"""The batch-statistics BatchNorm kernels' wrapper on the CPU, and the
kernels themselves on a card (`ops/cuda/csrc/batch_norm.cu`,
`ops/cuda/batch_norm.py`, reached through `models/darknet19.py::
BatchNorm(x, batch_stats=True)`).

On the CPU: the launch plan covers every BatchNorm shape of Darknet-19
(YOLOv2 and the joint model) and YOLOv4 at B = 1, 4, 16 and 32 in both
layouts, aligned or not (H·W = 169 and 361 planes hold no whole vector),
and a walk of the kernels' loops visits every element once; the plain
twin (what the ops run on CPU tensors) equals `BatchNorm.forward`'s plain
expression, forward and gradient; the ops pass `torch.library.opcheck`
and their fake kernels give the kernels' output layouts; a data group of
two gloo ranks gives the one-rank result; the counters read the
elements; CPU and float64 tensors keep the plain expression; the module
imports with no card and no nvcc.

Tests marked `card` hold the kernels to the plain expression and to a
float64 reference at the 22 Darknet-19 shapes at B=32 (YOLOv2) and B·T=16
(the joint step), in float32 and bfloat16 and in both layouts, and check
that they repeat bit for bit, recompute alike under `checkpoint`, span a
two-rank data group on one card and drop the clip's term where the
variance is clipped. They skip without a CUDA card. This file imports no
JAX, so on the card's machine it runs alone:

    python -m pytest --noconftest -q tests/test_torch_batch_norm_kernel.py
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_ranks
from object_tracking_tpu_torch.models.darknet19 import BatchNorm
from object_tracking_tpu_torch.ops.cuda import _build
from object_tracking_tpu_torch.ops.cuda import batch_norm as cbn
from object_tracking_tpu_torch.utils.profiling import Recorder, recording

ROOT = Path(__file__).resolve().parents[1]
EPS = 1e-3

# Darknet-19's BatchNorm inputs (C, H = W) at 416x416, norm_1 .. norm_22
DARKNET19 = [(32, 416), (64, 208), (128, 104), (64, 104), (128, 104),
             (256, 52), (128, 52), (256, 52), (512, 26), (256, 26),
             (512, 26), (256, 26), (512, 26), (1024, 13), (512, 13),
             (1024, 13), (512, 13), (1024, 13), (1024, 13), (1024, 13),
             (64, 26), (1024, 13)]
# YOLOv4's at 608x608 (C, H = W): 107 layers over these 13 shapes
YOLOV4 = [(32, 608), (64, 304), (32, 304), (128, 152), (64, 152),
          (256, 76), (128, 76), (512, 38), (256, 38), (1024, 19),
          (512, 19), (256, 19), (128, 38)]
LAYOUTS = {'planes': cbn.PLANES, 'rows': cbn.ROWS}


def plain_forward(x, weight, bias, eps=EPS):
    """`BatchNorm.forward`'s plain expression with a gradient (flax's
    statistics in float32, or float64 for a float64 x)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(0, 2, 3))
    sq = torch.square(xf).mean(dim=(0, 2, 3))
    var = torch.clamp_min(sq - torch.square(mean), 0.0)
    mul = torch.rsqrt(var + eps) * weight
    y = (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype), mean, var


def inputs(n, c, h, dtype=torch.float32, seed=0, device='cpu',
           layout='planes'):
    """x with per-channel offsets and scales (offsets up to 3 standard
    deviations, as after a conv), dy, weight and bias, seeded."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    x = (torch.randn(n, c, h, h, generator=g)
         * (torch.rand(c, 1, 1, generator=g) * 2 + 0.1)
         + torch.randn(c, 1, 1, generator=g) * 3)
    dy = torch.randn(n, c, h, h, generator=g)
    weight = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.1
    fmt = (torch.channels_last if layout == 'rows'
           else torch.contiguous_format)
    x, dy = (t.to(device=device, dtype=dtype).contiguous(memory_format=fmt)
             for t in (x, dy))
    return x, dy, weight.to(device), bias.to(device)


def grads(fn, x, dy, weight, bias):
    """(y, dx, dweight, dbias) of fn(x, weight, bias)[0] under dy."""
    x, weight, bias = (t.detach().clone().requires_grad_()
                       for t in (x, weight, bias))
    y = fn(x, weight, bias)[0]
    return (y.detach(), *torch.autograd.grad(y, (x, weight, bias), dy))


# -------------------------------------------------------------- the plan
def walk(plan: dict, shape) -> np.ndarray:
    """How often the kernels' loops visit each element of an (N, C, H, W)
    tensor in `plan`'s layout, by a numpy copy of their index arithmetic
    (every block and thread; the unrolled units of a pass are the same
    strided sequence)."""
    n, c, h, w = shape
    seen = np.zeros(n * c * h * w, dtype=np.int64)
    vec, chunk, splits = plan['vec'], plan['chunk'], plan['splits']
    tid = np.arange(cbn.THREADS)
    if plan['layout'] == cbn.ROWS:
        tile, lanes = plan['tile'], plan['lanes']
        tx, ty = tid % tile, tid // tile
        for j in range(plan['col_tiles']):
            col = j * tile + tx
            live = (ty < lanes) & (col * vec < c)
            for k in range(splits):
                r0, r1 = k * chunk, min(plan['outer'], (k + 1) * chunk)
                rows = r0 + ty[live][:, None] + np.arange(
                    0, max(r1 - r0, 1) + lanes, lanes)[None]
                cols = np.broadcast_to(col[live][:, None], rows.shape)
                ok = rows < r1
                base = rows[ok] * c + cols[ok] * vec
                for e in range(vec):
                    np.add.at(seen, base + e, 1)
    else:
        p = h * w // vec
        units = n * p
        for ch in range(c):
            for k in range(splits):
                j0, j1 = k * chunk, min(units, (k + 1) * chunk)
                jj = (j0 + tid[:, None] + cbn.THREADS * np.arange(
                    0, max(j1 - j0, 1) // cbn.THREADS + 1)[None])
                jj = jj[jj < j1]
                base = ((jj // p * c + ch) * p + jj % p) * vec
                for e in range(vec):
                    np.add.at(seen, base + e, 1)
    return seen


@pytest.mark.parametrize('shape, layout, aligned', [
    ((2, 32, 16, 16), cbn.ROWS, True), ((3, 12, 5, 7), cbn.ROWS, True),
    ((3, 12, 5, 7), cbn.ROWS, False), ((2, 1030, 3, 3), cbn.ROWS, True),
    ((2, 6, 13, 13), cbn.PLANES, True), ((2, 3, 12, 12), cbn.PLANES, True),
    ((1, 5, 64, 64), cbn.PLANES, True), ((4, 2, 19, 19), cbn.PLANES, False),
    ((1, 1024, 2, 2), cbn.ROWS, True), ((1, 3, 1, 1), cbn.PLANES, True),
])
def test_kernels_loops_visit_every_element_once(shape, layout, aligned):
    plan = cbn.launch_plan(shape, layout, aligned, sms=2)
    seen = walk(plan, shape)
    assert (seen == 1).all(), (plan, np.flatnonzero(seen != 1)[:8])


def _shapes():
    for b in (1, 4, 16, 32):
        for name, table in (('darknet19', DARKNET19), ('yolov4', YOLOV4)):
            for c, h in table:
                yield name, (b, c, h, h)


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('aligned', [True, False])
def test_launch_plan_covers_every_darknet19_and_yolov4_shape(layout,
                                                             aligned):
    for name, shape in _shapes():
        b, c, h, w = shape
        plan = cbn.launch_plan(shape, LAYOUTS[layout], aligned)
        vec = plan['vec']
        if LAYOUTS[layout] == cbn.ROWS:
            assert vec == (cbn.VEC if aligned and c % cbn.VEC == 0 else 1)
            assert plan['outer'] == b * h * w and plan['inner'] == 1
            assert plan['tile'] * plan['lanes'] <= cbn.THREADS
            assert plan['tile'] * plan['col_tiles'] * vec >= c
            work, across = b * h * w, plan['col_tiles']
        else:
            # 13² = 169 and 19² = 361 planes hold no whole vector
            assert vec == (cbn.VEC if aligned and h * w % cbn.VEC == 0
                           else 1)
            assert (plan['outer'], plan['inner']) == (b, h * w)
            work, across = b * h * w // vec, c
        splits, chunk = plan['splits'], plan['chunk']
        assert splits * chunk >= work > (splits - 1) * chunk, (name, shape)
        # the partial sums (16 B a channel a split) against what the
        # first pass reads (4 B or more an element)
        assert splits == 1 or 16 * splits * c <= b * c * h * w * 4 / 16
        # one wave of BLOCKS_PER_SM blocks an SM at most
        assert splits * across <= max(cbn.SMS * cbn.BLOCKS_PER_SM, across)
        assert cbn.launch_plan(shape, LAYOUTS[layout], aligned) is plan


def test_launch_plan_fills_the_card_at_the_largest_maps():
    """32 × 416² rows of 32 channels, and 1024 channels of 32 × 169
    elements: both one full wave of 528 blocks or more."""
    rows = cbn.launch_plan((32, 32, 416, 416), cbn.ROWS)
    assert rows['splits'] * rows['col_tiles'] == 528
    planes = cbn.launch_plan((32, 1024, 13, 13), cbn.PLANES, False)
    assert planes['splits'] * 1024 >= 528 and planes['vec'] == 1


@pytest.mark.parametrize('bad', [(0, 4, 2, 2), (2, 70000, 1, 1)])
def test_launch_plan_refuses_what_the_grid_cannot_hold(bad):
    with pytest.raises(ValueError):
        cbn.launch_plan(bad, cbn.PLANES)


def _constants(name: str) -> dict:
    text = (_build.CSRC / name).read_text()
    return {key: int(value) for key, value in re.findall(
        r'constexpr int (k\w+) = (\d+);', text)}


def test_python_constants_and_plan_equal_the_kernels():
    kernel = _constants('batch_norm.cu')
    assert kernel['kThreads'] == cbn.THREADS
    assert kernel['kVec'] == cbn.VEC
    assert kernel['kMinBlocksPerSm'] == cbn.BLOCKS_PER_SM
    text = (_build.CSRC / 'batch_norm.cu').read_text()
    struct = text[text.index('struct Plan {'):]
    struct = struct[:struct.index('};')]
    fields = re.findall(r'(int64_t|int) (\w+);', struct)
    kinds = {'int64_t': cbn.ctypes.c_int64, 'int': cbn.ctypes.c_int}
    assert [(n, kinds[t]) for t, n in fields] == cbn.Plan._fields_
    plan = cbn.launch_plan((2, 8, 4, 4), cbn.ROWS)
    assert set(plan) == {n for n, _ in cbn.Plan._fields_}


# ------------------------------------------------------------- the twin
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_twin_equals_the_plain_expression_forward_and_gradient(dtype,
                                                               layout):
    x, dy, weight, bias = inputs(4, 6, 5, dtype, seed=1, layout=layout)
    if dtype == torch.float64:
        weight, bias = weight.double(), bias.double()
    y, dx, dw, db = grads(plain_forward, x, dy, weight, bias)
    got = grads(lambda *a: cbn.BatchNormFunction.apply(*a, EPS, None),
                x, dy, weight, bias)
    tol = dict(rtol=1e-5, atol=2e-5)   # the plain float32 statistics
    for a, b in zip(got, (y, dx, dw, db)):
        torch.testing.assert_close(a.to(b.dtype), b, **tol)
    assert got[0].stride() == x.stride() and got[1].stride() == x.stride()
    _, mean, var = plain_forward(x, weight, bias)
    stats = cbn.batch_norm(x, weight.float(), bias.float(), EPS)[1]
    torch.testing.assert_close(stats[0].double(), mean.double(), **tol)
    torch.testing.assert_close(stats[1].double(), var.double(), **tol)


def test_twin_drops_the_clip_term_where_the_variance_is_clipped():
    """Sums with E[x²] < E[x]²: var 0, keep 0, and dx loses its last term
    (the gradient through clamp_min), as the plain expression's does."""
    x, dy, weight, _ = inputs(2, 3, 4, torch.float64, seed=2)
    n = x.numel() // 3
    sums = cbn._sums(x, x)
    sums[1, 1] = sums[0, 1] ** 2 / n * (1 - 1e-9)        # clipped
    stats = cbn.stats_from_sums(sums, n, EPS)
    assert stats[1, 1] == 0 and stats[3].tolist() == [1.0, 0.0, 1.0]
    dx = cbn.batch_norm_backward_plain(dy, x, weight.double(), stats)[0]
    mean, rstd = stats[0].double(), stats[2].double()
    xhat = (x - mean[:, None, None]) * rstd[:, None, None]
    gsum = dy.sum(dim=(0, 2, 3))
    gdot = (dy * xhat).sum(dim=(0, 2, 3))
    want = ((weight.double() * rstd)[:, None, None]
            * (dy - (gsum / n)[:, None, None]
               - stats[3, :, None, None] * xhat * (gdot / n)[:, None, None]))
    torch.testing.assert_close(dx, want, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(dx[:, 1], (want[:, 1] - (
        (weight.double() * rstd)[1] * xhat[:, 1] * gdot[1] / n)))


def test_no_grad_calls_the_op_without_a_graph():
    x, _, weight, bias = inputs(2, 4, 3)
    weight.requires_grad_()
    with torch.no_grad():
        y, stats = cbn.batch_norm(x, weight, bias, EPS)
    assert y.grad_fn is None and stats.grad_fn is None
    y, _ = cbn.batch_norm(x, weight, bias, EPS)
    assert type(y.grad_fn).__name__ == 'BatchNormFunctionBackward'


# ------------------------------------------------------- ops and fakes
def _op_cases(dtype):
    x, dy, weight, bias = inputs(2, 8, 3, dtype, seed=3)
    stats = cbn.batch_norm_plain(x, weight, bias, EPS)[1]
    sums = cbn._sums(x, x)
    ops = torch.ops.ott_torch
    for arg in (x, x.to(memory_format=torch.channels_last),
                x.transpose(2, 3)):
        yield ops.batch_norm_stats.default, (arg, weight, bias, EPS, None, 0)
        yield ops.batch_norm_stats.default, (arg, weight, bias, EPS, sums,
                                             x.numel() // 8)
        yield ops.batch_norm_sums.default, (arg,)
        yield ops.batch_norm_backward.default, (dy, arg, weight, stats,
                                                None, 0)
        yield ops.batch_norm_backward.default, (dy, arg, weight, stats,
                                                sums, x.numel() // 8)
        yield ops.batch_norm_grad_sums.default, (dy, arg, stats)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ops_pass_opcheck(dtype):
    for op, args in _op_cases(dtype):
        torch.library.opcheck(op, args)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['contiguous', 'channels_last',
                                    'transposed'])
def test_fakes_give_the_kernels_output_layout(dtype, layout):
    with FakeTensorMode():
        x = torch.empty(2, 8, 4, 5, dtype=dtype, device='cuda')
        x = {'contiguous': x,
             'channels_last': x.to(memory_format=torch.channels_last),
             'transposed': x.transpose(2, 3)}[layout]
        w = torch.empty(8, device='cuda')
        y, stats = torch.ops.ott_torch.batch_norm_stats(x, w, w, EPS, None,
                                                        0)
        sums = torch.ops.ott_torch.batch_norm_sums(x)
        dx, dw, db = torch.ops.ott_torch.batch_norm_backward(
            x, x, w, stats, None, 0)
    want = (x.stride() if layout != 'transposed'
            else torch.empty(x.shape).stride())
    assert y.shape == dx.shape == x.shape and y.dtype == dx.dtype == dtype
    assert y.stride() == dx.stride() == want
    assert stats.shape == (4, 8) and stats.dtype == torch.float32
    assert sums.shape == (2, 8) and sums.dtype == torch.float64
    assert dw.shape == db.shape == (8,)


@pytest.mark.parametrize('dtype, shape, param', [
    (torch.float64, (2, 4, 3, 3), torch.float32),
    (torch.float16, (2, 4, 3, 3), torch.float32),
    (torch.float32, (2, 4, 9), torch.float32),
    (torch.float32, (0, 4, 3, 3), torch.float32),
    (torch.float32, (2, 4, 3, 3), torch.float64),
])
def test_other_inputs_are_refused_on_cuda(dtype, shape, param):
    with FakeTensorMode():
        x = torch.zeros(shape, dtype=dtype, device='cuda')
        w = torch.zeros(4, dtype=param, device='cuda')
        with pytest.raises((TypeError, ValueError), match='batch_norm'):
            torch.ops.ott_torch.batch_norm_stats(x, w, w, EPS, None, 0)


# --------------------------------------------------------------- groups
def test_a_two_rank_group_gives_the_one_rank_result(tmp_path):
    """The twin through `BatchNormFunction` on two gloo ranks, each half
    the batch: the sums and the gradient sums all-reduced between the
    passes give the one-rank y, statistics and dx; each rank's dweight and
    dbias are its own share (the step sums them over the group)."""
    x, dy, weight, bias = inputs(4, 6, 5, seed=4, layout='rows')
    world = torch_ranks.run_world(torch_ranks.bn_group_world, 2, tmp_path,
                                  x.numpy(), dy.numpy(), weight.numpy(),
                                  bias.numpy(), 'cpu')
    one = torch_ranks.bn_group_world(0, 1, x.numpy(), dy.numpy(),
                                     weight.numpy(), bias.numpy(), 'cpu')
    for key in ('y', 'dx'):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in world]), one[key],
            rtol=1e-5, atol=1e-6)
    for r in world:
        np.testing.assert_allclose(r['stats'], one['stats'], rtol=1e-6,
                                   atol=1e-7)
    for key in ('dweight', 'dbias'):
        np.testing.assert_allclose(sum(r[key] for r in world), one[key],
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the model's choices
def test_counters_count_no_cpu_call():
    """The counters measure the kernels' share on the card: a CPU call,
    which no kernel can take, adds nothing (a CPU run of a training cell
    records no counter)."""
    bn = BatchNorm(4)
    x = torch.randn(2, 4, 3, 3)
    recorder = Recorder()
    with recording(recorder):
        bn(x, True)
        bn(x, False)
    assert recorder.reading()['counters'] == {}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_float32_and_bfloat16_take_the_kernels(monkeypatch, dtype):
    """`BatchNorm.forward` on fake float32 and bfloat16 CUDA tensors calls
    the kernels' entry and counts every element as the kernels'. (Which
    other tensors keep the plain expression: `engages` below, and the
    CPU and card tests of that path.)"""
    calls = []

    def spy(x, weight, bias, eps, group):
        calls.append(x.dtype)
        return torch.empty_like(x), (weight.detach(), weight.detach())
    monkeypatch.setattr(cbn, 'batch_norm', spy)
    recorder = Recorder()
    with FakeTensorMode():
        with torch.device('cuda'):
            bn = BatchNorm(4)
            x = torch.empty(2, 4, 3, 3, dtype=dtype)
            x1 = torch.empty(1, 4, 3, 3, dtype=dtype)
        with recording(recorder):
            y = bn(x, True)
            bn(x1, True)
    assert calls == [dtype, dtype]
    assert y.shape == x.shape and y.dtype == dtype
    assert recorder.reading()['counters'] == {'bn.elements': 108,
                                              'bn.kernel_elements': 108}


def test_engages_only_non_empty_4d_float32_and_bfloat16_cuda_tensors():
    with FakeTensorMode():
        cases = {(dtype, shape, device): cbn.engages(
            torch.empty(shape, dtype=dtype, device=device))
            for dtype in (torch.float32, torch.bfloat16, torch.float16,
                          torch.float64)
            for shape in ((2, 3, 4, 4), (2, 3, 4), (0, 3, 4, 4))
            for device in ('cuda', 'cpu')}
    assert {k for k, v in cases.items() if v} == {
        (torch.float32, (2, 3, 4, 4), 'cuda'),
        (torch.bfloat16, (2, 3, 4, 4), 'cuda')}


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_cpu_tensors_keep_the_plain_expression(monkeypatch, dtype):
    """On the CPU `BatchNorm.forward` never reaches the kernels' entry and
    equals the plain expression bit for bit, forward, gradient and
    running statistics (CPU parity with JAX is unchanged)."""
    monkeypatch.setattr(cbn, 'batch_norm', None)
    x, dy, weight, bias = inputs(3, 5, 4, dtype, seed=5, layout='rows')
    weight, bias = weight.to(dtype), bias.to(dtype)
    bn = BatchNorm(5).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xr = x.clone().requires_grad_()
    y = bn(xr, True)
    got = (y.detach(), *torch.autograd.grad(y, (xr, bn.weight, bn.bias),
                                            dy))
    want = grads(plain_forward, x, dy, weight, bias)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _, mean, var = plain_forward(x, weight, bias)
    rate = 1.0 - BatchNorm.momentum
    assert torch.equal(bn.running_mean,
                       torch.zeros(5, dtype=dtype).lerp_(mean, rate))
    assert torch.equal(bn.running_var,
                       torch.ones(5, dtype=dtype).lerp_(var, rate))
    bn.eval()
    with torch.no_grad():
        y = bn(x, True)
        assert torch.equal(y, torch.nn.functional.batch_norm(
            x, mean, var, weight, bias, False, 0.0, EPS))


def test_module_imports_and_runs_without_a_card_or_nvcc(tmp_path):
    """Nothing builds or loads at import, nor for a CPU tensor: the
    process has no card and no nvcc on its PATH."""
    code = ('import torch\n'
            'from object_tracking_tpu_torch.models.darknet19 import '
            'BatchNorm\n'
            'from object_tracking_tpu_torch.ops.cuda import _build, '
            'batch_norm\n'
            'y = BatchNorm(2)(torch.arange(8.).reshape(2, 2, 2, 1), True)\n'
            'assert _build._loaded == {} and batch_norm._fns is None\n'
            'assert not torch.cuda.is_available()\n'
            'print(round(float(y[0, 0, 0, 0]), 4))\n')
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '-1.2125'


def test_a_graph_holding_the_op_reloads_where_serving_is_imported(tmp_path):
    """A program exported on a card holds `ott_torch::batch_norm_stats`
    (serving's `bn_mode='batch'`); a fresh interpreter that imports only
    `serving` (no model class) deserializes and runs one. Here the op's
    CPU twin stands in for the card's kernels."""
    class Norm(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.rand(4) + 0.5)
            self.bias = torch.nn.Parameter(torch.randn(4))

        def forward(self, x):
            return cbn.batch_norm(x, self.weight, self.bias, EPS)[0]
    model = Norm()
    x = torch.randn(2, 4, 3, 3)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
        want = model(x)
    assert 'ott_torch.batch_norm_stats' in str(program.graph)
    torch.export.save(program, tmp_path / 'bn.pt2')
    torch.save(x, tmp_path / 'x.pt')
    code = ('import sys, torch\n'
            'import object_tracking_tpu_torch.serving\n'
            'program = torch.export.load("bn.pt2")\n'
            'y = program.module()(torch.load("x.pt"))\n'
            'assert "object_tracking_tpu_torch.models" not in sys.modules\n'
            'torch.save(y, "y.pt")\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert torch.equal(torch.load(tmp_path / 'y.pt'), want)


# ----------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the BatchNorm kernels have no CPU '
                    'mode')
    return torch.device('cuda', 0)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 distance of a from b, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


# the float64 reference's rounding to the output type, relative L2
FLOOR = {torch.float32: 1e-6, torch.bfloat16: 4e-3}


def reference(x, dy, weight, bias):
    """The plain expression in float64 on the exact inputs: (y, dx,
    dweight, dbias) and (mean, var)."""
    x64, dy64 = x.double(), dy.double()
    out = grads(plain_forward, x64, dy64, weight.double(), bias.double())
    _, mean, var = plain_forward(x64, weight.double(), bias.double())
    return out, (mean, var)


def kernel_run(bn, x, dy):
    """(y, dx, dweight, dbias), the stats and the running statistics of
    one training-mode batch-statistics call of `bn` on x."""
    bn.train()
    with torch.no_grad():
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    x = x.detach().clone().requires_grad_()
    for p in bn.parameters():
        p.grad = None
    before = cbn.batch_norm.launches
    recorder = Recorder()
    with recording(recorder):
        y = bn(x, True)
    y.backward(dy)
    assert cbn.batch_norm.launches == before + 2      # forward, backward
    n = x.numel()
    assert recorder.reading()['counters'] == {'bn.elements': n,
                                              'bn.kernel_elements': n}
    assert y.stride() == x.stride() and x.grad.stride() == x.stride()
    return ((y.detach(), x.grad, bn.weight.grad.clone(),
             bn.bias.grad.clone()),
            (bn.running_mean.clone(), bn.running_var.clone()))


CARD_SHAPES = ([('yolov2_b32', 32, c, h) for c, h in DARKNET19]
               + [('joint_b16', 16, c, h) for c, h in DARKNET19])


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', CARD_SHAPES,
                         ids=lambda c: f'{c[0]}_{c[2]}x{c[3]}')
def test_kernels_agree_with_the_plain_expression_on_card(card, case,
                                                         dtype):
    """Against the float64 reference the kernels' y, dx, dweight, dbias,
    statistics and running statistics lie no further than the plain
    expression's (or than the output type's rounding), in both layouts;
    a second run gives the same bits."""
    _, n, c, h = case
    torch.backends.cudnn.allow_tf32 = False
    for layout in LAYOUTS:
        x, dy, weight, bias = inputs(n, c, h, dtype, seed=c + h,
                                     device=card, layout=layout)
        bn = BatchNorm(c).to(card)
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        got, running = kernel_run(bn, x, dy)
        again, running2 = kernel_run(bn, x, dy)
        for a, b in zip(got + running, again + running2):
            assert torch.equal(a, b), 'not repeatable'
        want, (mean, var) = reference(x, dy, weight, bias)
        plain = grads(plain_forward, x, dy, weight, bias)
        for name, k, p, w in zip(('y', 'dx', 'dweight', 'dbias'), got,
                                 plain, want):
            floor = FLOOR[dtype] if name in ('y', 'dx') else 1e-6
            assert rel(k, w) <= max(2 * rel(p, w), floor), (
                layout, name, rel(k, w), rel(p, w))
        stats = cbn.batch_norm(x, weight, bias, EPS)[1]
        pm, pv = plain_forward(x, weight, bias)[1:]
        assert rel(stats[0], mean) <= max(rel(pm, mean), 1e-7)
        assert rel(stats[1], var) <= max(rel(pv, var), 1e-7)
        rm, rv = running
        torch.testing.assert_close(rm.double(), 0.01 * mean, rtol=1e-6,
                                   atol=1e-9)
        torch.testing.assert_close(rv.double(), 0.99 + 0.01 * var,
                                   rtol=1e-6, atol=1e-9)
        del x, dy, got, again, want, plain
        torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_no_grad_call_equals_the_gradient_calls_forward_on_card(card,
                                                                dtype):
    """Serving's call (no gradient, eval mode: no running statistics
    written) gives the training call's y bit for bit, in one launch."""
    x, _, weight, bias = inputs(16, 256, 52, dtype, device=card,
                                layout='rows')
    bn = BatchNorm(256).to(card).eval()
    before = cbn.batch_norm.launches
    with torch.no_grad():
        y = bn(x, True)
    assert cbn.batch_norm.launches == before + 1
    assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
    y2 = bn(x.clone().requires_grad_(), True)
    assert torch.equal(y, y2.detach())


@pytest.mark.card
def test_clipped_variance_channel_gives_the_plain_gradient_on_card(card):
    """A constant map (var 0) among ordinary ones: the kernels' dx equals
    the plain expression's; and sums whose E[x²] < E[x]² clip the
    variance, keep 0, and the kernels' dx drops the clip's term exactly
    as the twin's does."""
    x, dy, weight, bias = inputs(8, 6, 26, device=card, layout='rows')
    x[:, 2] = 0.1
    got = grads(lambda *a: cbn.batch_norm(*a, EPS), x, dy, weight, bias)
    want = grads(plain_forward, x, dy, weight, bias)
    exact = reference(x, dy, weight, bias)[0]
    for k, p, w in zip(got, want, exact):
        assert rel(k, w) <= max(2 * rel(p, w), 1e-6)
    n = x.numel() // 6
    sums = cbn.batch_norm_sums_op(x)
    sums[1, 4] = sums[0, 4] ** 2 / n * (1 - 1e-9)
    y, stats = torch.ops.ott_torch.batch_norm_stats(x, weight, bias, EPS,
                                                    sums, n)
    assert stats[3, 4] == 0 and stats[1, 4] == 0
    assert stats[3, [0, 1, 3, 5]].tolist() == [1, 1, 1, 1]
    dx, dw, db = torch.ops.ott_torch.batch_norm_backward(
        dy, x, weight, stats, None, 0)
    tdx, tdw, tdb = cbn.batch_norm_backward_plain(dy, x, weight, stats)
    for a, b in ((dx, tdx), (dw, tdw), (db, tdb)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    ty = cbn.batch_norm_plain(x, weight, bias, EPS, sums, n)[0]
    torch.testing.assert_close(y, ty, rtol=1e-6, atol=1e-5)


@pytest.mark.card
def test_checkpoint_recomputation_runs_the_same_op_on_card(card):
    """The joint model's `remat` forward recomputes the detector in
    backward through the same kernels: gradients and running statistics
    equal the plain forward's (cuDNN deterministic)."""
    from object_tracking_tpu_torch.models import MultiObjDetTracker
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g = torch.Generator(device='cpu').manual_seed(6)
        images = torch.rand(2, 4, 128, 128, 3, generator=g).to(card)
        out = {}
        for remat in (False, True):
            torch.manual_seed(0)
            model = MultiObjDetTracker(width_div=8, convlstm_features=64,
                                       remat=remat).to(card).train()
            before = cbn.batch_norm.launches
            loss = sum(v.square().mean() for k, v in
                       model(images, train=True).items())
            loss.backward()
            out[remat] = ({n: p.grad.clone() for n, p in
                           model.named_parameters()},
                          {n: b.clone() for n, b in model.named_buffers()},
                          cbn.batch_norm.launches - before)
        (g0, b0, l0), (g1, b1, l1) = out[False], out[True]
        assert l0 == 44 and l1 == 66      # 22 forward + 22 backward (+22)
        for name in g0:
            assert torch.equal(g0[name], g1[name]), name
        for name in b0:
            assert torch.equal(b0[name], b1[name]), name
    finally:
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.card
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_a_two_rank_group_on_one_card_gives_the_one_rank_step(card, dtype,
                                                              tmp_path):
    """Two gloo ranks on cuda:0, each half of a (16, 256, 52, 52) batch:
    y, statistics and dx equal the one-rank kernels' on the whole batch
    (up to the order of the float64 sums), each rank's dweight and dbias
    its share."""
    x, dy, weight, bias = inputs(16, 256, 52, seed=7, layout='rows')
    args = (x.numpy(), dy.numpy(), weight.numpy(), bias.numpy(), 'cuda',
            dtype)
    world = torch_ranks.run_world(torch_ranks.bn_group_world, 2, tmp_path,
                                  *args, timeout=300.0)
    one = torch_ranks.bn_group_world(0, 1, *args)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == 'float32'
           else dict(rtol=1e-2, atol=1e-2))
    for key in ('y', 'dx'):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in world]), one[key], **tol)
    for r in world:
        np.testing.assert_allclose(r['stats'], one['stats'], rtol=1e-6,
                                   atol=1e-7)
    for key in ('dweight', 'dbias'):
        np.testing.assert_allclose(sum(r[key] for r in world), one[key],
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.card
def test_other_types_keep_the_plain_expression_on_card(card):
    """float64 on the card runs the plain expression, not the kernels."""
    x, dy, weight, bias = inputs(4, 8, 13, torch.float64, device=card)
    bn = BatchNorm(8).to(card).double()
    before = cbn.batch_norm.launches
    recorder = Recorder()
    with recording(recorder):
        y = bn(x, True)
    assert cbn.batch_norm.launches == before
    assert recorder.reading()['counters'] == {'bn.elements': x.numel(),
                                              'bn.kernel_elements': 0}
    assert torch.equal(y, plain_forward(x, bn.weight, bn.bias)[0])
