"""RoI max-pooling kernel for Hopper: wrapper, plain twin, launch count.

Replaces no TPU kernel: the JAX package has no two-stage detector. The
port's Faster R-CNN (`models/faster_rcnn.py`) pools every RoI of each
image from that image's conv5_3 map into 7x7 bins (Caffe's
`ROIPoolingLayer`), which eager PyTorch has no op for; `csrc/roi_pool.cu`
does it in one launch for the whole batch. Its header says what bounds it
on the H100 (bytes: the pooled output) and how the design answers that.

`roi_pool` goes through the custom op `ott_torch::roi_pool`
(`roi_pool_op`): on a CPU tensor it runs `roi_pool_plain`, the same
arithmetic in PyTorch (float32, or float64 for the tests); on a CUDA
tensor it launches the kernel (float32; any other type raises), which
equals the twin bit for bit (a max is exact, and both compute the bins in
the same float32 operations).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from object_tracking_tpu_torch.utils.profiling import count

MAX_BINS = 64         # kMaxBins (csrc/roi_pool.cu): PH * PW a launch takes
CLAMP = 1e6           # kClamp: coordinates clamped before the round
PLAIN_STEP = 2 ** 26  # elements of the plain twin's masked max a step

_fn = None


def c_round(v: torch.Tensor) -> torch.Tensor:
    """C's `roundf`: half away from zero, exactly (torch.round rounds half
    to even)."""
    t = torch.trunc(v)
    return t + torch.where((v - t).abs() >= 0.5, torch.sign(v),
                           torch.zeros_like(v))


def _edges(rois: torch.Tensor, scale: float) -> torch.Tensor:
    """round(coordinate · scale) of every corner, as the kernel takes it:
    the product in float32, clamped to ±CLAMP (a NaN to −CLAMP), C's
    round."""
    v = rois * torch.tensor(scale, dtype=rois.dtype, device=rois.device)
    v = torch.where(torch.isnan(v), torch.full_like(v, -CLAMP), v)
    return c_round(v.clamp(-CLAMP, CLAMP)).long()


def _bins(start: torch.Tensor, end: torch.Tensor, pooled: int, size: int):
    """[lo, hi) of each bin along one axis, (..., pooled) each: Caffe's
    float32 bin edges offset by the start, clipped to [0, size]."""
    length = torch.clamp_min(end - start + 1, 1).float()
    step = length / torch.full_like(length, float(pooled))
    p = torch.arange(pooled, dtype=torch.float32, device=start.device)
    lo = torch.floor(p * step[..., None]).long() + start[..., None]
    hi = torch.ceil((p + 1) * step[..., None]).long() + start[..., None]
    return lo.clamp(0, size), hi.clamp(0, size)


def roi_pool_plain(features: torch.Tensor, rois: torch.Tensor,
                   scale: float, pooled: Tuple[int, int] = (7, 7)
                   ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: features (B, C, H, W),
    rois (B, R, 4) corners → (B, R, C, PH, PW): each bin's max (a NaN
    propagates), 0 where the bin is empty. A masked max over the columns
    of each bin, then over its rows, a few RoIs at a time (about
    PLAIN_STEP elements a step)."""
    b, c, h, w = features.shape
    ph, pw = pooled
    edges = _edges(rois, scale)
    xs, xe = _bins(edges[..., 0], edges[..., 2], pw, w)     # (B, R, PW)
    ys, ye = _bins(edges[..., 1], edges[..., 3], ph, h)
    col = (torch.arange(w, device=features.device) >= xs[..., None]) & (
        torch.arange(w, device=features.device) < xe[..., None])
    row = (torch.arange(h, device=features.device) >= ys[..., None]) & (
        torch.arange(h, device=features.device) < ye[..., None])
    empty = ~(row.any(-1)[..., :, None] & col.any(-1)[..., None, :])
    neg = torch.tensor(float('-inf'), dtype=features.dtype,
                       device=features.device)
    step = max(1, PLAIN_STEP // max(b * c * h * w * max(ph, pw), 1))
    x = features[:, None, :, :, None, :]                     # (B,1,C,H,1,W)
    out = []
    for r0 in range(0, rois.shape[1], step):
        sl = slice(r0, r0 + step)
        by_col = torch.where(col[:, sl, None, None], x, neg).amax(-1)
        pooled_max = torch.where(row[:, sl, None, :, :, None],
                                 by_col[:, :, :, None], neg).amax(-2)
        out.append(torch.where(empty[:, sl, None],
                               torch.zeros_like(pooled_max), pooled_max))
    if not out:
        return features.new_zeros((b, 0, c, ph, pw))
    return torch.cat(out, dim=1)


def _check(features: torch.Tensor, rois: torch.Tensor,
           pooled: Tuple[int, int]) -> None:
    if features.dim() != 4:
        raise ValueError(f'features must be (B, C, H, W), got '
                         f'{tuple(features.shape)}')
    if (rois.dim() != 3 or rois.shape[-1] != 4
            or rois.shape[0] != features.shape[0]):
        raise ValueError(f'rois must be (B, R, 4) with features '
                         f'(B, C, H, W), got {tuple(rois.shape)} and '
                         f'{tuple(features.shape)}')
    types = (torch.float32,) if features.is_cuda else (torch.float32,
                                                        torch.float64)
    if features.dtype not in types or rois.dtype != features.dtype:
        raise TypeError(f'roi_pool takes float32 (or float64 on the CPU), '
                        f'got {features.dtype} and {rois.dtype}')
    if features.device != rois.device:
        raise ValueError(f'features on {features.device}, rois on '
                         f'{rois.device}')
    if pooled[0] * pooled[1] > MAX_BINS or min(pooled) <= 0:
        raise ValueError(f'roi_pool takes 1 to {MAX_BINS} bins, got '
                         f'{pooled}')


def _launcher():
    global _fn
    if _fn is None:
        from object_tracking_tpu_torch.ops.cuda import _build
        fn = _build.load('roi_pool').roi_pool_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(features: torch.Tensor, rois: torch.Tensor, scale: float,
            pooled: Tuple[int, int]) -> torch.Tensor:
    """One launch on CUDA tensors, on the current stream, counted in
    `roi_pool.launches`; raises on a failed build or launch."""
    b, c, h, w = features.shape
    r = rois.shape[1]
    ph, pw = pooled
    nhwc = features.contiguous(memory_format=torch.channels_last)
    rois = rois.contiguous()
    out = torch.empty((b, r, c, ph, pw), dtype=torch.float32,
                      device=features.device)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = _launcher()(nhwc.data_ptr(), rois.data_ptr(), out.data_ptr(),
                          b, r, h, w, c, ph, pw, float(scale), stream)
    if err != 0:
        raise RuntimeError(f'roi_pool kernel launch failed: cudaError {err}')
    roi_pool.launches += 1
    return out


# The kernel as the custom op `ott_torch::roi_pool`, so that a traced
# program records one call of it and a profiler files its kernel under the
# op: the CUDA implementation launches the kernel, the CPU one runs the
# plain twin, and the fake one gives tracing the output's shape.
# Registering builds nothing; the kernel builds at its first launch.
@torch.library.custom_op('ott_torch::roi_pool', mutates_args=(),
                         device_types='cuda')
def roi_pool_op(features: torch.Tensor, rois: torch.Tensor, scale: float,
                pooled_h: int, pooled_w: int) -> torch.Tensor:
    _check(features, rois, (pooled_h, pooled_w))
    return _launch(features, rois, scale, (pooled_h, pooled_w))


@roi_pool_op.register_kernel('cpu')
def _roi_pool_cpu(features: torch.Tensor, rois: torch.Tensor, scale: float,
                  pooled_h: int, pooled_w: int) -> torch.Tensor:
    _check(features, rois, (pooled_h, pooled_w))
    return roi_pool_plain(features, rois, scale, (pooled_h, pooled_w))


@roi_pool_op.register_fake
def _roi_pool_fake(features: torch.Tensor, rois: torch.Tensor, scale: float,
                   pooled_h: int, pooled_w: int) -> torch.Tensor:
    _check(features, rois, (pooled_h, pooled_w))
    return features.new_empty((features.shape[0], rois.shape[1],
                               features.shape[1], pooled_h, pooled_w))


def roi_pool(features: torch.Tensor, rois: torch.Tensor, scale: float,
             pooled: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """Caffe's RoI max pooling for B images in one launch.

    features (B, C, H, W) float32, any memory format; rois (B, R, 4)
    float32 corners (x1, y1, x2, y2) in image pixels, RoI r of image b
    over image b's map; `scale` maps pixels to map cells (1/16 for
    conv5_3) → (B, R, C, PH, PW). CPU tensors run `roi_pool_plain`; CUDA
    tensors launch `csrc/roi_pool.cu` once, counted in
    `roi_pool.launches`. Counts (with a recorder attached) the RoIs as
    `roi_pool.rois` and those the kernel pooled as `roi_pool.kernel_rois`.
    """
    out = torch.ops.ott_torch.roi_pool(features, rois, float(scale),
                                       int(pooled[0]), int(pooled[1]))
    n = rois.shape[0] * rois.shape[1]
    count('roi_pool.rois', n)
    count('roi_pool.kernel_rois', n if rois.is_cuda else 0)
    return out


roi_pool.launches = 0
