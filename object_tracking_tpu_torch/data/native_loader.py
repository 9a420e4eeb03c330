"""ctypes binding of the native C++ data runtime (native/ott_dataio.cpp).

Port of `object_tracking_tpu/data/native_loader.py`, with its public names,
its ctypes signatures and its ABI check. `libottdata.so` does the host's
byte work: JPEG/PNG decode, the fused bilinear resize (and /255), batch
loading on a worker pool, and the reference's greedy NMS on the host.

The library is compiled at first use, never at import, from the source in
`native/` (read there, never written) with `native/Makefile`'s flags and
libraries, into `<checkout>/build/native/`, which `.gitignore` lists:
- the file name is keyed on a hash of the source, the flags, the
  compiler's `--version` and the target that `-march=native` resolves to
  (a checkout copied to another machine builds its own library);
- each process compiles to a temp file of its own and renames it into
  place, so processes that build at once never read a half-written file.

Where it cannot build (no compiler, no libjpeg or libpng headers),
`available()` is False and `build_error` keeps the compiler's output, so
that a caller can show it; the generators then decode with cv2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / 'native' / 'ott_dataio.cpp'
BUILD_DIR = _ROOT / 'build' / 'native'
CXX = 'g++'
CXXFLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-march=native',
            '-fno-exceptions')
LDLIBS = ('-ljpeg', '-lpng')
_ABI_VERSION = 4

_lib = None
_lib_lock = threading.Lock()
_build_failed = False
build_error: Optional[str] = None     # why the library is unavailable


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    f32_p = ctypes.POINTER(ctypes.c_float)
    i32_p = ctypes.POINTER(ctypes.c_int)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.ott_version.restype = ctypes.c_int
    lib.ott_load_image_f32.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, f32_p]
    lib.ott_load_image_f32.restype = ctypes.c_int
    lib.ott_image_size.argtypes = [ctypes.c_char_p, i32_p, i32_p]
    lib.ott_image_size.restype = ctypes.c_int
    lib.ott_load_batch_f32.argtypes = [c_char_pp, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, f32_p,
                                       ctypes.c_int]
    lib.ott_load_batch_f32.restype = ctypes.c_int
    lib.ott_load_batch_u8.argtypes = [c_char_pp, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, u8_p,
                                      ctypes.c_int]
    lib.ott_load_batch_u8.restype = ctypes.c_int
    lib.ott_nms_scores.argtypes = [f32_p, f32_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_float]
    lib.ott_nms_scores.restype = None
    return lib


def _run(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f'{" ".join(cmd)} (exit {out.returncode}):\n'
                           f'{out.stdout}{out.stderr}')
    return out.stdout


def library_path() -> Path:
    """Where this source, these flags and this compiler and target put
    the library."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(' '.join(CXXFLAGS + LDLIBS).encode())
    digest.update(_run([CXX, '--version']).encode())
    # -march=native compiles for this machine's CPU: the resolved target
    # keys the file, so a copy of the checkout on another CPU rebuilds
    digest.update(_run([CXX, '-march=native', '-Q', '--help=target'])
                  .encode())
    return BUILD_DIR / f'libottdata-{digest.hexdigest()[:16]}.so'


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f'{target.name}.{os.getpid()}.tmp')
    try:
        _run([CXX, *CXXFLAGS, '-shared', str(SOURCE), '-o', str(tmp),
              *LDLIBS])
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded libottdata.so, compiled first if needed (`build`); None
    if it is unavailable, with the reason in `build_error`."""
    global _lib, _build_failed, build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            target = library_path()
            if not target.exists():
                if not build:
                    return None
                _build(target)
            lib = _bind(ctypes.CDLL(str(target)))
            if lib.ott_version() != _ABI_VERSION:
                raise RuntimeError(f'{target}: ABI {lib.ott_version()}, '
                                   f'the binding is ABI {_ABI_VERSION}')
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_failed = True
            build_error = str(e)
            return None
        return _lib


def available() -> bool:
    return load_library() is not None


def _library() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise ImportError(f'libottdata.so unavailable: {build_error}')
    return lib


def load_image(path: str, net_h: int, net_w: int) -> np.ndarray:
    """One file → (net_h, net_w, 3) float32 RGB in [0, 1]."""
    lib = _library()
    out = np.empty((net_h, net_w, 3), np.float32)
    rc = lib.ott_load_image_f32(
        path.encode(), net_h, net_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise FileNotFoundError(f'native decode failed ({rc}): {path}')
    return out


def image_size(path: str) -> tuple[int, int]:
    """Decode only the header → (height, width)."""
    lib = _library()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.ott_image_size(path.encode(), ctypes.byref(h),
                            ctypes.byref(w))
    if rc != 0:
        raise FileNotFoundError(f'native header decode failed: {path}')
    return h.value, w.value


def _load_batch(fn, ctype, dtype, paths: Sequence[str], net_h: int,
                net_w: int, n_threads: int) -> np.ndarray:
    n = len(paths)
    out = np.empty((n, net_h, net_w, 3), dtype)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failed = fn(arr, n, net_h, net_w,
                out.ctypes.data_as(ctypes.POINTER(ctype)), n_threads)
    if failed:
        raise FileNotFoundError(
            f'native decode failed for {failed}/{n} images')
    return out


def load_batch(paths: Sequence[str], net_h: int, net_w: int,
               n_threads: int = 0) -> np.ndarray:
    """N files → (N, net_h, net_w, 3) float32; raises if any file fails."""
    return _load_batch(_library().ott_load_batch_f32, ctypes.c_float,
                       np.float32, paths, net_h, net_w, n_threads)


def load_batch_u8(paths: Sequence[str], net_h: int, net_w: int,
                  n_threads: int = 0) -> np.ndarray:
    """N files → (N, net_h, net_w, 3) uint8 RGB, resized but not
    normalised: the fused train steps' host decode (the device divides by
    255)."""
    return _load_batch(_library().ott_load_batch_u8, ctypes.c_uint8,
                       np.uint8, paths, net_h, net_w, n_threads)


def nms_scores(boxes: np.ndarray, scores: np.ndarray,
               nms_threshold: float = 0.45) -> np.ndarray:
    """Greedy per-class NMS on the host (the reference's do_nms_obj):
    boxes (N, 4) center-format, scores (N, C) → a new suppressed score
    array."""
    lib = _library()
    boxes = np.ascontiguousarray(boxes, np.float32)
    out = np.ascontiguousarray(scores, np.float32).copy()
    if boxes.shape != (out.shape[0], 4):
        raise ValueError(f'boxes {boxes.shape} do not match scores '
                         f'{out.shape}')
    lib.ott_nms_scores(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        boxes.shape[0], out.shape[1], float(nms_threshold))
    return out


def make_loader(net_h: int, net_w: int
                ) -> Optional[Callable[[str], np.ndarray]]:
    """A per-path loader for the generators' `loader=` argument, or None
    if the library is unavailable."""
    if not available():
        return None

    def load(path: str) -> np.ndarray:
        return load_image(path, net_h, net_w)

    return load
