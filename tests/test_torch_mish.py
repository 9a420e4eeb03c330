"""The Mish kernel's wrapper on the CPU, and the kernel itself on a card
(`ops/cuda/csrc/mish.cu`, `ops/cuda/mish.py`, reached through
`models/darknet_cfg.py::_activate(x, 'mish')`).

On the CPU the custom op `ott_torch::mish` runs the plain twin, which is
the eager expression x · tanh(softplus(x)) bit for bit, also at ±0, ±inf,
NaN, around softplus' threshold of 20, where exp overflows (±88–90) and
on subnormals; the gradient of `MishFunction` equals autograd's through
the eager expression; the launch plan covers tails and misaligned
pointers; other types are refused; the op passes `torch.library.opcheck`;
the counters read the elements; and the module imports with no card and
no nvcc.

Tests marked `card` hold the kernel to the eager expression bit for bit,
in float32 at every distinct Mish shape of YOLOv4 at B=8, 608x608, and on
every bfloat16 value; they skip without a CUDA card. This file imports no
JAX, so on the card's machine it runs alone:

    python -m pytest --noconftest -q tests/test_torch_mish.py
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from object_tracking_tpu_torch.models import darknet_cfg
from object_tracking_tpu_torch.ops.cuda import _build
from object_tracking_tpu_torch.ops.cuda import mish as cuda_mish
from object_tracking_tpu_torch.utils.profiling import Recorder, recording

ROOT = Path(__file__).resolve().parents[1]
FLOATS = (torch.float32, torch.float64, torch.bfloat16)

# YOLOv4's Mish outputs at B=8, 608x608 (NCHW) and how many layers give
# each: 72 in all (test_torch_yolov4.py holds the plan to them)
YOLOV4_MISH = {(8, 32, 608, 608): 1, (8, 64, 304, 304): 6,
               (8, 32, 304, 304): 1, (8, 128, 152, 152): 2,
               (8, 64, 152, 152): 7, (8, 256, 76, 76): 2,
               (8, 128, 76, 76): 19, (8, 512, 38, 38): 2,
               (8, 256, 38, 38): 19, (8, 1024, 19, 19): 2,
               (8, 512, 19, 19): 11}


def eager(x):
    """The expression `_activate` computed before the kernel."""
    return x * torch.tanh(F.softplus(x))


def special(dtype):
    """±0, ±inf, NaN, the neighbours of softplus' threshold 20, where
    exp overflows (±88–90), subnormals and a few ordinary values."""
    twenty = torch.tensor(20.0, dtype=dtype)
    near = [torch.nextafter(twenty, torch.tensor(v, dtype=dtype))
            for v in (0.0, 100.0)]
    values = [0.0, -0.0, float('inf'), -float('inf'), float('nan'), 19.5,
              20.5, -20.0, 88.0, 88.5, 88.72, 88.73, 89.0, 90.0, -88.0,
              -88.72, -89.0, -90.0, -103.0, -104.0, 1e-40, -1e-40,
              1.4e-45, -1.4e-45, 1.1754944e-38, 1e-30, -1e-30, 0.5, -0.5,
              5.0, -5.0, 1.0, -1.0]
    return torch.cat([torch.tensor(values, dtype=dtype),
                      torch.stack(near)])


def samples(dtype, n=4099, seed=3):
    """Special values, then random normals at scales 1, 6 and 40."""
    rng = np.random.RandomState(seed)
    normals = rng.randn(3, n) * np.array([[1.0], [6.0], [40.0]])
    return torch.cat([special(dtype),
                      torch.from_numpy(normals.ravel()).to(dtype)])


def bits(x):
    return x.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def same_bits(a, b):
    """Equal bit for bit, NaNs in the same places (their payloads aside)."""
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(bits(a)[~nan], bits(b)[~nan]))


# ------------------------------------------------------------- the twin
@pytest.mark.parametrize('dtype', FLOATS)
def test_twin_and_op_equal_the_eager_expression_bit_for_bit(dtype):
    x = samples(dtype)
    want = eager(x)
    assert same_bits(cuda_mish.mish_plain(x), want)
    assert same_bits(cuda_mish.mish(x), want)


@pytest.mark.parametrize('layout', ['contiguous', 'channels_last',
                                    'transposed', 'offset'])
def test_activate_mish_on_the_cpu_is_unchanged(layout):
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 5, 7)
                         .astype(np.float32) * 6)
    x = {'contiguous': x,
         'channels_last': x.to(memory_format=torch.channels_last),
         'transposed': x.transpose(2, 3),
         'offset': x.flatten()[1:].reshape(11, 19)}[layout]
    got = darknet_cfg._activate(x, 'mish')
    assert got.shape == x.shape
    assert same_bits(got, eager(x))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_gradient_equals_autograds_through_the_eager_expression(dtype):
    """Exact in both types: the backward is autograd's own ops in its
    order (within 1e-6 relative is all float32 needs)."""
    x = samples(dtype)
    x = x[torch.isfinite(x)].requires_grad_()
    grad = torch.from_numpy(np.random.RandomState(5).randn(x.numel())
                            ).to(dtype)
    out = darknet_cfg._activate(x, 'mish')
    assert type(out.grad_fn).__name__ == 'MishFunctionBackward'
    got, = torch.autograd.grad(out, x, grad)
    ref = x.detach().clone().requires_grad_()
    want, = torch.autograd.grad(eager(ref), ref, grad)
    assert torch.equal(got, want)
    assert torch.equal(cuda_mish.mish_grad_plain(x.detach(), grad), want)


def test_no_grad_calls_the_op_without_a_graph():
    x = torch.randn(10, requires_grad=True)
    with torch.no_grad():
        out = cuda_mish.mish(x)
    assert out.grad_fn is None and not out.requires_grad
    assert cuda_mish.mish(x.detach()).grad_fn is None


# ----------------------------------------------------- plan and checks
N608 = 8 * 32 * 608 * 608


@pytest.mark.parametrize('numel, dtype, aligned, want', [
    (0, torch.float32, True, (4, 0, 0, 0)),
    (1, torch.float32, True, (4, 0, 1, 1)),
    (7, torch.bfloat16, True, (8, 0, 7, 1)),
    (13, torch.float32, True, (4, 3, 1, 1)),
    (13, torch.float32, False, (1, 13, 0, 1)),
    (4097, torch.bfloat16, True, (8, 512, 1, 2)),
    (4097, torch.bfloat16, False, (1, 4097, 0, 17)),
    (N608, torch.float32, True, (4, N608 // 4, 0, N608 // 4 // 256)),
    (N608 + 3, torch.float32, True, (4, N608 // 4, 3, N608 // 4 // 256)),
])
def test_launch_plan_covers_tails_and_misaligned_pointers(numel, dtype,
                                                          aligned, want):
    plan = cuda_mish.launch_plan(numel, dtype, aligned)
    assert (plan['vec'], plan['units'], plan['tail'], plan['blocks']) == want
    assert plan['units'] * plan['vec'] + plan['tail'] == numel
    assert plan['tail'] < plan['vec'] <= cuda_mish.THREADS
    assert plan['blocks'] * cuda_mish.THREADS * cuda_mish.UNROLL >= \
        plan['units']
    assert cuda_mish.launch_plan(numel, dtype, aligned) is plan


@pytest.mark.parametrize('dtype', [torch.float64, torch.float16,
                                   torch.int32])
def test_other_types_are_refused(dtype):
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        cuda_mish._check(dtype)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        cuda_mish.launch_plan(8, dtype)
    with FakeTensorMode():
        x = torch.zeros(3, dtype=dtype, device='cuda')
        with pytest.raises(TypeError, match='float32 or bfloat16'):
            torch.ops.ott_torch.mish(x)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['contiguous', 'channels_last',
                                    'transposed'])
def test_fake_gives_the_kernels_output_layout(dtype, layout):
    with FakeTensorMode():
        x = torch.empty(2, 3, 4, 5, dtype=dtype, device='cuda')
        x = {'contiguous': x,
             'channels_last': x.to(memory_format=torch.channels_last),
             'transposed': x.transpose(1, 3)}[layout]
        out = torch.ops.ott_torch.mish(x)
    want = (x.stride() if layout != 'transposed'
            else torch.empty(x.shape).stride())
    assert out.shape == x.shape and out.dtype == dtype
    assert out.stride() == want


@pytest.mark.parametrize('dtype', FLOATS)
def test_op_passes_opcheck(dtype):
    x = torch.randn(2, 3, 4, 5).to(dtype)
    for arg in (x, x.to(memory_format=torch.channels_last),
                x.transpose(1, 2)):
        torch.library.opcheck(torch.ops.ott_torch.mish.default, (arg,))


def _constants(name: str) -> dict:
    text = (_build.CSRC / name).read_text()
    return {key: int(value) for key, value in re.findall(
        r'constexpr int (k\w+) = (\d+);', text)}


def test_python_constants_equal_the_kernels():
    kernel = _constants('mish.cu')
    assert kernel['kThreads'] == cuda_mish.THREADS
    assert kernel['kUnroll'] == cuda_mish.UNROLL


def test_counters_read_the_elements():
    x = torch.randn(2, 3, 4)
    recorder = Recorder()
    with recording(recorder):
        cuda_mish.mish(x)
        darknet_cfg._activate(x[:1], 'mish')
        darknet_cfg._activate(x, 'leaky')
    assert recorder.reading()['counters'] == {'mish.elements': 36,
                                              'mish.kernel_elements': 0}


def test_module_imports_and_runs_without_a_card_or_nvcc(tmp_path):
    """Nothing builds or loads at import, nor for a CPU tensor: the
    process has no card and no nvcc on its PATH."""
    code = ('import torch\n'
            'from object_tracking_tpu_torch.models import darknet_cfg\n'
            'from object_tracking_tpu_torch.ops.cuda import _build, mish\n'
            'y = darknet_cfg._activate(torch.ones(3), "mish")\n'
            'assert _build._loaded == {} and mish._fn is None\n'
            'assert not torch.cuda.is_available()\n'
            'print(round(float(y[0]), 4))\n')
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '0.8651'


# ----------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the Mish kernel has no CPU mode')
    return torch.device('cuda', 0)


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cut', ['whole', 'tail', 'misaligned'])
def test_kernel_equals_the_eager_expression_on_card(card, dtype, cut):
    x = samples(dtype, n=100003).to(card)
    x = {'whole': x, 'tail': x[:-3], 'misaligned': x[1:]}[cut]
    before = cuda_mish.mish.launches
    recorder = Recorder()
    with recording(recorder):
        got = cuda_mish.mish(x)
    torch.cuda.synchronize()
    assert cuda_mish.mish.launches == before + 1
    assert recorder.reading()['counters'] == {
        'mish.elements': x.numel(), 'mish.kernel_elements': x.numel()}
    assert same_bits(got, eager(x))


@pytest.mark.card
@pytest.mark.parametrize('shape', list(YOLOV4_MISH))
def test_kernel_equals_the_eager_expression_at_yolov4_shapes(card, shape):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x = torch.randn(shape, device=card, generator=g) * 6
    assert same_bits(darknet_cfg._activate(x, 'mish'), eager(x))
    cl = x.to(memory_format=torch.channels_last)
    out = cuda_mish.mish(cl)
    assert out.stride() == cl.stride() and same_bits(out, eager(cl))


@pytest.mark.card
def test_kernel_equals_the_eager_expression_on_every_bfloat16(card):
    x = torch.arange(-2**15, 2**15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).to(card)
    assert same_bits(cuda_mish.mish(x), eager(x))


@pytest.mark.card
def test_gradient_on_card_equals_autograds(card):
    x = samples(torch.float32).to(card)
    x = x[torch.isfinite(x)].requires_grad_()
    grad = torch.randn(x.shape, device=card)
    before = cuda_mish.mish.launches
    got, = torch.autograd.grad(cuda_mish.mish(x), x, grad)
    assert cuda_mish.mish.launches == before + 1
    ref = x.detach().clone().requires_grad_()
    want, = torch.autograd.grad(eager(ref), ref, grad)
    assert torch.equal(got, want)


@pytest.mark.card
def test_other_types_raise_on_card(card):
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        cuda_mish.mish(torch.zeros(4, dtype=torch.float64, device=card))
