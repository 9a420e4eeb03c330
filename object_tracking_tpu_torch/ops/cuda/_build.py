"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` source compiles with `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). Libraries
land in `<checkout>/build/kernels/`, which `.gitignore` lists, under a name
keyed on a hash of the source, every header under `csrc/` and the flags:
an edited source or header rebuilds, an unchanged one loads the library
already there. All missing libraries are
compiled together, one `nvcc` process per source.

Nothing here runs at import time; `load(name)` is called by a kernel
wrapper the first time it launches on a CUDA tensor, and builds every
missing library then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'

# -fmad=false: no multiply-add contraction, so float results match the
# plain PyTorch versions bit for bit. Never --use_fast_math (it would make
# division approximate).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xptxas=-v', '-shared',
              '-Xcompiler', '-fPIC')

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}          # name → nvcc output (ptxas -v)


def sources() -> List[str]:
    """Names of every kernel source under csrc/ (without `.cu`)."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels of '
                       'object_tracking_tpu_torch need the CUDA toolkit')


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names: List[str]) -> None:
    """Compile every listed source whose library is missing, all nvcc
    processes at once; raise with the compiler's output on failure."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        target = _library_path(name)
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f'{name}.cu (nvcc exit {proc.returncode}):\n{log}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu. The first load builds every
    missing library under csrc/ in the same round, so a fresh checkout
    pays one parallel round of nvcc, whichever kernel launches first."""
    lib = _loaded.get(name)
    if lib is None:
        build(sources())
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
