"""BatchNorm with batch statistics for Hopper: wrapper, launch plan, plain
twin, launch count.

Replaces no TPU kernel: the JAX package normalises with flax's
`nn.BatchNorm`, which XLA fuses into a few loops. `models/darknet19.py::
BatchNorm` computes the same statistics (the mean and E[x²] − E[x]² in
float32, clipped at 0) as plain tensor ops, which run eagerly as ~8
kernels forward and more in autograd's backward, each over whole feature
maps. `csrc/batch_norm.cu` reads x once for both per-channel sums and
once more to write y; its backward reads dy and x once for Σdy and
Σdy·(x − mean) and once more to write dx. Its header says what bounds it
on the H100 (bytes) and how the design answers that.

The ops (`torch.ops.ott_torch.*`), each a CUDA kernel sequence on a CUDA
tensor and the plain twin on a CPU one:
- `batch_norm_stats(x, weight, bias, eps, sums, count) -> (y, stats)`:
  stats is (4, C) float32, rows mean, var, rstd = rsqrt(var + eps) and
  keep (1 where E[x²] − E[x]² ≥ 0: where the clip passes a gradient). With
  `sums` None the op takes the sums of x itself; else `sums` (2, C)
  float64 holds Σx and Σx² over `count` elements a channel (a data
  group's, all-reduced);
- `batch_norm_sums(x) -> sums`: those two sums of x alone;
- `batch_norm_backward(dy, x, weight, stats, sums, count) -> (dx, dweight,
  dbias)`: likewise from Σdy and Σdy·(x − mean), its own or given;
- `batch_norm_grad_sums(dy, x, stats) -> sums`: those two sums alone.

`batch_norm` chooses between them and `BatchNormFunction`, which carries
the gradient; `engages` says which tensors take the kernels (float32 or
bfloat16 4-D CUDA tensors; the model runs its plain expression on every
other). `launch_plan` chooses every size of a launch in plain Python that
the CPU tests reach.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from object_tracking_tpu_torch.parallel.collectives import (
    all_reduce_sum_, group_size)

# The kernel's own constants (csrc/batch_norm.cu; tests/test_torch_batch_
# norm_kernel.py holds these copies equal to them)
THREADS = 256             # kThreads: a block of the four passes
VEC = 4                   # kVec: channels or elements a vector
BLOCKS_PER_SM = 4         # kMinBlocksPerSm: the blocks one wave holds an SM
TILE = 32                 # rows: column units a block at most (a warp
                          # across a row: 512 B in float32)
MIN_PASSES = 8            # a thread's rows or units at least, where the
                          # tensor allows (fewer blocks, fewer partials)
SMS = 132                 # the H100's SMs (the default of `launch_plan`)
MAX_GRID_Y = 65535
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the launchers' codes
ALL, SUMS, APPLY = 0, 1, 2                        # the launchers' stages
PLANES, ROWS = 0, 1                               # layouts

_fns = None


class Plan(ctypes.Structure):
    """`launch_plan`'s numbers as the kernel's `struct Plan` takes them."""
    _fields_ = [('outer', ctypes.c_int64), ('inner', ctypes.c_int64),
                ('chunk', ctypes.c_int64), ('channels', ctypes.c_int),
                ('layout', ctypes.c_int), ('vec', ctypes.c_int),
                ('splits', ctypes.c_int), ('tile', ctypes.c_int),
                ('lanes', ctypes.c_int), ('col_tiles', ctypes.c_int)]


# ------------------------------------------------------------ the twin
def _sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2, C) float64: Σa and Σa·b over all but the channel axis."""
    a, b = a.double(), b.double()
    return torch.stack([a.sum(dim=(0, 2, 3)), (a * b).sum(dim=(0, 2, 3))])


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """`t` in float32, or float64 where it is that."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def stats_from_sums(sums: torch.Tensor, count: int, eps: float
                    ) -> torch.Tensor:
    """(4, C) float32 statistics from Σx and Σx², as the finishing kernel
    computes them: in float64, then rounded once; var clipped at 0 (a NaN
    kept), var + eps added in float32."""
    mean = sums[0] / count
    v = sums[1] / count - mean * mean
    var = torch.where(v < 0, torch.zeros_like(v), v).float()
    rstd = (1.0 / torch.sqrt((var + eps).double())).float()
    return torch.stack([mean.float(), var, rstd, (v >= 0).float()])


def batch_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     sums: Optional[torch.Tensor] = None, count: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' forward as eager PyTorch, and what CPU tensors run:
    (y, stats), y = (x − mean)·(rstd·weight) + bias in float32, in x's
    type."""
    if sums is None:
        sums, count = _sums(x, x), x.numel() // x.shape[1]
    stats = stats_from_sums(sums, count, eps)
    mul = stats[2] * weight
    y = (_wide(x) - _col(stats[0])) * _col(mul) + _col(bias)
    return y.to(x.dtype), stats


def batch_norm_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                              weight: torch.Tensor, stats: torch.Tensor,
                              sums: Optional[torch.Tensor] = None,
                              count: int = 0):
    """The kernels' backward as eager PyTorch: (dx, dweight, dbias) with
    dx = rstd·weight·(dy − Σdy/N − keep·x̂·Σ(dy·x̂)/N), x̂ = (x − mean)·rstd,
    dweight = Σdy·x̂ and dbias = Σdy, the sums float64."""
    mean, rstd, keep = stats[0], stats[2], stats[3]
    if sums is None:
        sums = _sums(dy, _wide(x) - _col(mean))
        count = x.numel() // x.shape[1]
    r = rstd.double()
    dbias, dweight = sums[0].float(), (sums[1] * r).float()
    b1 = (sums[0] / count).float()
    c1 = (keep.double() * r * r * sums[1] / count).float()
    mul = rstd * weight
    dx = _col(mul) * (_wide(dy) - _col(b1)
                      - (_wide(x) - _col(mean)) * _col(c1))
    return dx.to(x.dtype), dweight, dbias


# ---------------------------------------------------------------- plan
def layout_of(x: torch.Tensor) -> Optional[int]:
    """PLANES for a contiguous (N, C, H, W) tensor, ROWS for a
    channels_last one, None for any other strides."""
    if x.is_contiguous():
        return PLANES
    if x.is_contiguous(memory_format=torch.channels_last):
        return ROWS
    return None


def _dense(x: torch.Tensor) -> torch.Tensor:
    return x if layout_of(x) is not None else x.contiguous()


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`t` in the memory layout of `x` (dense)."""
    fmt = (torch.channels_last if layout_of(x) == ROWS
           else torch.contiguous_format)
    return t.contiguous(memory_format=fmt)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def launch_plan(shape: Tuple[int, int, int, int], layout: int,
                aligned: bool = True, sms: int = SMS) -> dict:
    """Every size of the four passes over an (N, C, H, W) tensor laid out
    as `layout`: vectors of VEC channels (ROWS, where C is a multiple of
    VEC) or VEC elements of a plane (PLANES, where H·W is), if every
    pointer is `aligned` to a vector, else single elements (`vec` 1); for
    ROWS a block of up to TILE column units by `lanes` rows, so that wide
    maps split across `col_tiles` blocks and each block's partial sums
    (16 B a channel) stay a few percent of the bytes it reads; the grid
    (`splits` chunks along the rows or a channel's units, times
    `col_tiles` column tiles or C channels) that fills `sms` SMs with
    BLOCKS_PER_SM blocks each in one wave, each thread at least MIN_PASSES
    rows or units where the tensor holds that many; and each block's
    `chunk`. Cached per shape: treat the dict as read-only."""
    n, c, h, w = shape
    if min(shape) <= 0:
        raise ValueError(f'batch_norm needs a non-empty (N, C, H, W), got '
                         f'{shape}')
    wave = sms * BLOCKS_PER_SM
    if layout == ROWS:
        vec = VEC if aligned and c % VEC == 0 else 1
        cols = c // vec
        tile = min(cols, TILE)
        col_tiles = _ceil(cols, tile)
        lanes = THREADS // tile
        outer, inner = n * h * w, 1
        work, per_pass, across = outer, lanes, col_tiles
    elif layout == PLANES:
        vec = VEC if aligned and (h * w) % VEC == 0 else 1
        tile = lanes = col_tiles = 1
        outer, inner = n, h * w
        work, per_pass, across = n * (h * w // vec), THREADS, c
        if work >= 2**32:
            raise ValueError(f'batch_norm: {work} units a channel (planes '
                             f'index them in 32 bits)')
    else:
        raise ValueError(f'layout {layout}')
    if across > MAX_GRID_Y:
        raise ValueError(f'batch_norm: {across} blocks across the grid')
    splits = max(1, min(wave // across, work // (per_pass * MIN_PASSES)))
    chunk = _ceil(work, splits)
    return {'layout': layout, 'vec': vec, 'outer': outer, 'inner': inner,
            'channels': c, 'splits': _ceil(work, chunk), 'chunk': chunk,
            'tile': tile, 'lanes': lanes, 'col_tiles': col_tiles}


# -------------------------------------------------------------- launch
def _check(x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f'the batch_norm kernels take float32 or bfloat16, '
                        f'got {x.dtype}')
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'the batch_norm kernels take a non-empty (N, C, '
                         f'H, W), got {tuple(x.shape)}')
    for p in params:
        if p.dtype != torch.float32 or p.shape != (x.shape[1],):
            raise TypeError(f'batch_norm parameters are float32 of shape '
                            f'({x.shape[1]},), got {p.dtype} '
                            f'{tuple(p.shape)}')


def _launchers():
    global _fns
    if _fns is None:
        from object_tracking_tpu_torch.ops.cuda import _build
        lib = _build.load('batch_norm')
        p, i, d, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                      ctypes.c_float)
        fwd, bwd = lib.bn_forward_launch, lib.bn_backward_launch
        fwd.argtypes = [p, i, i, p, p, p, p, p, p, p, d, f, p]
        bwd.argtypes = [p, i, i, p, p, p, p, p, p, p, p, p, p, d, p]
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _plan(x: torch.Tensor, *others: Optional[torch.Tensor]) -> Plan:
    unit = VEC * x.element_size()
    aligned = all(t.data_ptr() % unit == 0 for t in (x, *others)
                  if t is not None)
    return Plan(**launch_plan(tuple(x.shape), layout_of(x), aligned,
                              _sms(x.device)))


def _sums_buffers(plan: Plan, x: torch.Tensor, stage: int,
                  sums: Optional[torch.Tensor], count: int):
    """(partials, sums, count) of a launcher call: a stage that takes its
    own sums gets the blocks' workspace and the local count, SUMS an
    output for the sums too; APPLY reads the given sums."""
    if stage == APPLY:
        return None, sums, count
    c = x.shape[1]
    partials = torch.empty((plan.splits, 2, c), dtype=torch.float64,
                           device=x.device)
    out = (torch.empty((2, c), dtype=torch.float64, device=x.device)
           if stage == SUMS else None)
    return partials, out, plan.outer * plan.inner


def _launch(which: int, x: torch.Tensor, *args) -> None:
    """Launcher `which` (0 forward, 1 backward) on x's device and current
    stream, counted in `batch_norm.launches`; raises on a failed build or
    launch."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[which](*args, stream)
    if err != 0:
        raise RuntimeError(f'batch_norm {("forward", "backward")[which]} '
                           f'launch failed: cudaError {err}')
    batch_norm.launches += 1


def _forward(x, weight, bias, eps, sums, count, stage):
    """One forward launcher call; returns (y, stats, sums), None for what
    the stage does not write."""
    c = x.shape[1]
    y = torch.empty_like(x) if stage != SUMS else None
    stats = (torch.empty((4, c), dtype=torch.float32, device=x.device)
             if stage != SUMS else None)
    plan = _plan(x, y)
    partials, sums, count = _sums_buffers(plan, x, stage, sums, count)
    _launch(0, x, ctypes.byref(plan), DTYPES[x.dtype], stage, _ptr(x),
            _ptr(y), _ptr(weight), _ptr(bias), _ptr(partials), _ptr(sums),
            _ptr(stats), float(count), float(eps))
    return y, stats, sums


def _backward(dy, x, weight, stats, sums, count, stage):
    """One backward launcher call; returns (dx, dweight, dbias, sums)."""
    c = x.shape[1]
    dx = torch.empty_like(x) if stage != SUMS else None
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    coef = (torch.empty((2, c), dtype=torch.float32, device=x.device)
            if stage != SUMS else None)
    plan = _plan(x, dy, dx)
    partials, sums, count = _sums_buffers(plan, x, stage, sums, count)
    _launch(1, x, ctypes.byref(plan), DTYPES[x.dtype], stage, _ptr(dy),
            _ptr(x), _ptr(dx), _ptr(weight), _ptr(stats), _ptr(partials),
            _ptr(sums), _ptr(dweight), _ptr(dbias), _ptr(coef),
            float(count))
    return dx, dweight, dbias, sums


# ------------------------------------------------------------- the ops
def _fake_out(x: torch.Tensor) -> torch.Tensor:
    """An output of x's shape in the layout the kernels give it (without
    copying x, which a fake tensor of a card this build lacks cannot)."""
    return (torch.empty_like(x) if layout_of(x) is not None
            else x.new_empty(x.shape))


# Registered as custom ops so that a traced program records one call of
# each and a profiler files their kernels under it: the CUDA
# implementations launch the kernels, the CPU ones run the plain twin, the
# fake ones give tracing the outputs' shapes. Registering builds nothing;
# the kernels build at their first launch.
@torch.library.custom_op('ott_torch::batch_norm_stats', mutates_args=(),
                         device_types='cuda')
def batch_norm_stats_op(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float,
                        sums: Optional[torch.Tensor], count: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, weight, bias)
    x = _dense(x)
    y, stats, _ = _forward(x, weight.contiguous(), bias.contiguous(), eps,
                           None if sums is None else sums.contiguous(),
                           count, ALL if sums is None else APPLY)
    return y, stats


@batch_norm_stats_op.register_kernel('cpu')
def _stats_cpu(x, weight, bias, eps, sums, count):
    x = _dense(x)
    y, stats = batch_norm_plain(x, weight, bias, eps, sums, count)
    return _like(y, x), stats


@batch_norm_stats_op.register_fake
def _stats_fake(x, weight, bias, eps, sums, count):
    if x.device.type == 'cuda':
        _check(x, weight, bias)
    return (_fake_out(x),
            x.new_empty((4, x.shape[1]), dtype=torch.float32))


@torch.library.custom_op('ott_torch::batch_norm_sums', mutates_args=(),
                         device_types='cuda')
def batch_norm_sums_op(x: torch.Tensor) -> torch.Tensor:
    _check(x)
    return _forward(_dense(x), None, None, 0.0, None, 0, SUMS)[2]


@batch_norm_sums_op.register_kernel('cpu')
def _sums_cpu(x):
    return _sums(x, x)


@batch_norm_sums_op.register_fake
def _sums_fake(x):
    if x.device.type == 'cuda':
        _check(x)
    return x.new_empty((2, x.shape[1]), dtype=torch.float64)


@torch.library.custom_op('ott_torch::batch_norm_backward', mutates_args=(),
                         device_types='cuda')
def batch_norm_backward_op(dy: torch.Tensor, x: torch.Tensor,
                           weight: torch.Tensor, stats: torch.Tensor,
                           sums: Optional[torch.Tensor], count: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    _check(x, weight)
    x = _dense(x)
    dx, dweight, dbias, _ = _backward(
        _like(dy, x), x, weight.contiguous(), stats.contiguous(),
        None if sums is None else sums.contiguous(), count,
        ALL if sums is None else APPLY)
    return dx, dweight, dbias


@batch_norm_backward_op.register_kernel('cpu')
def _backward_cpu(dy, x, weight, stats, sums, count):
    x = _dense(x)
    dx, dweight, dbias = batch_norm_backward_plain(_like(dy, x), x, weight,
                                                   stats, sums, count)
    return _like(dx, x), dweight, dbias


@batch_norm_backward_op.register_fake
def _backward_fake(dy, x, weight, stats, sums, count):
    if x.device.type == 'cuda':
        _check(x, weight)
    return (_fake_out(x), torch.empty_like(weight),
            torch.empty_like(weight))


@torch.library.custom_op('ott_torch::batch_norm_grad_sums', mutates_args=(),
                         device_types='cuda')
def batch_norm_grad_sums_op(dy: torch.Tensor, x: torch.Tensor,
                            stats: torch.Tensor) -> torch.Tensor:
    _check(x)
    x = _dense(x)
    return _backward(_like(dy, x), x, None, stats.contiguous(), None, 0,
                     SUMS)[3]


@batch_norm_grad_sums_op.register_kernel('cpu')
def _grad_sums_cpu(dy, x, stats):
    return _sums(dy, _wide(x) - _col(stats[0]))


@batch_norm_grad_sums_op.register_fake
def _grad_sums_fake(dy, x, stats):
    if x.device.type == 'cuda':
        _check(x)
    return x.new_empty((2, x.shape[1]), dtype=torch.float64)


# ------------------------------------------------------------ autograd
def _stats(x, weight, bias, eps, group):
    """(y, stats, count): the sums all-reduced over `group` between the
    passes, where there is one."""
    count = x.numel() // x.shape[1]
    if group is None:
        y, stats = torch.ops.ott_torch.batch_norm_stats(x, weight, bias, eps,
                                                        None, 0)
        return y, stats, count
    count *= group_size(group)
    sums = all_reduce_sum_(torch.ops.ott_torch.batch_norm_sums(x), group)
    y, stats = torch.ops.ott_torch.batch_norm_stats(x, weight, bias, eps,
                                                    sums, count)
    return y, stats, count


class BatchNormFunction(torch.autograd.Function):
    """BatchNorm with batch statistics and a gradient: forward
    `batch_norm_stats` (with a group, `batch_norm_sums` and an all-reduce
    first), backward `batch_norm_backward` (with a group, the local
    `batch_norm_grad_sums` give dweight and dbias, and their all-reduce
    gives dx). stats is an output without a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        y, stats, count = _stats(x, weight, bias, eps, group)
        ctx.save_for_backward(x, weight, stats)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(stats)
        ctx.set_materialize_grads(False)    # no zeros for stats' gradient
        return y, stats

    @staticmethod
    def backward(ctx, dy, _):
        x, weight, stats = ctx.saved_tensors
        ops = torch.ops.ott_torch
        if ctx.group is None:
            dx, dweight, dbias = ops.batch_norm_backward(dy, x, weight, stats,
                                                         None, 0)
        else:
            local = ops.batch_norm_grad_sums(dy, x, stats)
            dbias, dweight = local[0].float(), (local[1] * stats[2]).float()
            dx = ops.batch_norm_backward(
                dy, x, weight, stats, all_reduce_sum_(local.clone(),
                                                      ctx.group),
                ctx.count)[0]
        return dx, dweight, dbias, None, None


def engages(x: torch.Tensor) -> bool:
    """Whether `batch_norm` runs the kernels on x: a non-empty float32 or
    bfloat16 (N, C, H, W) CUDA tensor."""
    return (x.is_cuda and x.dtype in DTYPES and x.dim() == 4
            and x.numel() > 0)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): x normalised with its batch statistics (Σ over N, H, W;
    with a data `group`, over every rank's batch), y in x's type and
    layout, stats (4, C) float32 (mean, var, rstd, keep). On a CUDA tensor
    (float32 or bfloat16) the kernels run, one forward launcher call (two
    and an all-reduce with a group), counted in `batch_norm.launches`;
    on a CPU tensor the twin. Where a gradient is wanted it goes through
    `BatchNormFunction`."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return BatchNormFunction.apply(x, weight, bias, eps, group)
    return _stats(x, weight, bias, eps, group)[:2]


batch_norm.launches = 0
