"""Darknet-19 / YOLOv2 detector as a PyTorch module.

Port of `object_tracking_tpu/models/darknet19.py`: 22 conv+BN+LeakyReLU(0.1)
blocks with 5 max-pools, a space-to-depth skip from block 13, and a 1x1 head
conv reshaped to (H/32, W/32, A, 5+C).

- NCHW inside; images come in as (B, H, W, 3) and netout / conv_feat leave
  as (B, H/32, W/32, A, 5+C) / (B, H/32, W/32, 1024), the JAX layouts.
- `dtype` is the activation type (float32 or bfloat16); parameters stay
  float32 and are cast at each conv, and the two outputs are float32.
- BatchNorm uses flax's epsilon (1e-3) and momentum (0.99). `train=True`
  normalises with the batch statistics; it also folds them into the
  running statistics when the module is in `train()` mode (a training
  step), and writes nothing in `eval()` mode (the serving path's
  bn_mode='batch', the eval steps). `train=False` uses the running
  statistics.
- `space_to_depth_2x` orders channels (di, dj, c), as tf.space_to_depth
  does — not `F.pixel_unshuffle`'s (c, di, dj).
- With a `mesh`, batch statistics span the data group: each rank holds a
  share of the global batch, as under JAX's sharded `jit` (none inside
  `parallel.mesh.whole_batch()`, where each rank holds all of it).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.ops.cuda import batch_norm as cuda_batch_norm
from object_tracking_tpu_torch.parallel.collectives import (
    all_reduce_sum, group_size)
from object_tracking_tpu_torch.parallel.mesh import in_whole_batch
from object_tracking_tpu_torch.parallel.sharding import (
    column_conv, column_operands, held)
from object_tracking_tpu_torch.utils.profiling import count


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """tf.space_to_depth on NCHW: output channel (di * block + dj) * C + c
    takes input channel c at offset (di, dj)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)             # (b, di, dj, c, h/s, w/s)
    return x.reshape(b, block * block * c, h // block, w // block)


def space_to_depth_2x(x: torch.Tensor) -> torch.Tensor:
    """tf.space_to_depth(block_size=2) on NCHW."""
    return space_to_depth(x, 2)


def seeded(seed: int, build):
    """`build()` under a global torch RNG seeded with `seed`, restored
    afterwards: a module's random init is a function of the seed alone."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


# flax's lecun_normal: a normal truncated at ±2 standard deviations, scaled
# by this constant so that its standard deviation is sqrt(1 / fan_in)
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's lecun_normal in place: a normal truncated at ±2 standard
    deviations, with standard deviation sqrt(1 / fan_in)."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


@torch.no_grad()
def init_like_flax(module: nn.Module, seed: int) -> nn.Module:
    """Initialise `module` in place as flax initialises the JAX model, with
    torch's RNG seeded by `seed` (JAX's PRNG stream cannot be reproduced):
    every conv and dense kernel lecun_normal (truncated normal, fan-in, std
    sqrt(1/fan_in)), biases 0, BatchNorm scale 1, bias 0 and statistics
    (0, 1); then each module's own `reset_recurrent_parameters` (a
    ConvLSTM's forget-gate bias +1 and orthogonal recurrent kernel, an
    LSTM's orthogonal recurrent kernels, a zero-initialised residual
    head). torch's default conv init has a third of that variance.
    Returns `module`."""
    def build():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, m.weight[0].numel())
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for m in module.modules():
            reset = getattr(m, 'reset_recurrent_parameters', None)
            if reset is not None:
                reset()
        return module
    return seeded(seed, build)


def plain_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, group=None):
    """flax's batch statistics and the normalised x as plain tensor ops:
    (y, mean, var). The mean and E[x²] − E[x]², clipped at 0, reduced in
    float32 (float64 for a float64 x) and differentiated through both,
    summed over the data `group` if one is given; y is
    (x − mean)·rsqrt(var + eps)·weight + bias in x's dtype, one
    `F.batch_norm` on those statistics when no gradient is wanted. What
    `BatchNorm` runs where the kernels cannot take x."""
    dims = (0, 2, 3)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if group is None:
        mean = xf.mean(dim=dims)
        sq = torch.square(xf).mean(dim=dims)
    else:
        total = xf.numel() // xf.shape[1] * group_size(group)
        sums = all_reduce_sum(torch.stack(
            [xf.sum(dim=dims), torch.square(xf).sum(dim=dims)]), group)
        mean, sq = sums[0] / total, sums[1] / total
    var = torch.clamp_min(sq - torch.square(mean), 0.0)
    if not torch.is_grad_enabled():
        return (F.batch_norm(x, mean, var, weight, bias, training=False,
                             eps=eps), mean, var)
    mul = torch.rsqrt(var + eps) * weight
    y = (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype), mean, var


class BatchNorm(nn.Module):
    """BatchNorm as flax computes it, with its epsilon and momentum.

    With batch statistics it normalises with flax's: the mean and the
    biased variance E[x²] − E[x]², reduced in float32 and clipped at 0,
    differentiated through both, (x − mean)·rsqrt(var + eps)·scale + bias.
    In `train()` mode it folds the same pair into the running statistics,
    ra = 0.99·ra + 0.01·batch; in `eval()` mode it writes nothing.
    Without a gradient to take, the normalisation is one `F.batch_norm`
    on those statistics.

    With a data `group` (each rank a share of the global batch) the two
    sums are all-reduced over it, with the gradient of the global
    statistics: the mean and E[x²] of the global batch, as flax computes
    them under a sharded `jit`. Neither plain DDP (per-rank statistics)
    nor `SyncBatchNorm` (an unbiased variance in the running statistics)
    computes that. Inside `parallel.mesh.whole_batch()` the group is
    left out: every rank holds the whole batch.

    On a float32 or bfloat16 CUDA tensor the batch statistics go through
    the hand-written kernels (`ops/cuda/batch_norm.py::batch_norm`: the
    same statistics from float64 sums, forward and backward in two passes
    each, the group's all-reduce between them); every other tensor runs
    the plain expression, `plain_batch_norm`. Each batch-statistics call
    on a CUDA tensor counts its elements as `bn.elements` and those the
    kernels took as `bn.kernel_elements` (`utils/profiling.count`); a CPU
    call, which no kernel can take, counts nothing.
    """

    momentum = 0.99
    tp_leaves = ('bias',)               # gathered at use when sharded

    def __init__(self, features: int, eps: float = 1e-3, group=None):
        super().__init__()
        self.eps = eps
        self.group = group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        weight, bias = self.weight, held(self, 'bias')
        if not batch_stats:
            mean, var = self.running_mean, self.running_var
        else:
            engaged = cuda_batch_norm.engages(x)
            if x.is_cuda:
                count('bn.elements', x.numel())
                count('bn.kernel_elements', x.numel() if engaged else 0)
            group = None if in_whole_batch() else self.group
            if engaged:
                y, stats = cuda_batch_norm.batch_norm(x, weight, bias,
                                                      self.eps, group)
                mean, var = stats[0], stats[1]
            else:
                y, mean, var = plain_batch_norm(x, weight, bias, self.eps,
                                                group)
            self._fold(mean, var)
            return y
        return F.batch_norm(x, mean, var, weight, bias, training=False,
                            eps=self.eps)

    def _fold(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The batch statistics into the running ones, in `train()` mode."""
        if self.training:
            with torch.no_grad():
                self.running_mean.lerp_(mean, 1.0 - self.momentum)
                self.running_var.lerp_(var, 1.0 - self.momentum)


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """`layer` applied in x's dtype ('SAME' padding, stride 1); the
    float32 parameters are cast, never stored in the compute type. A
    layer whose weight is tensor-parallel computes its own output
    channels and gathers the rest (`parallel.sharding.column_conv`)."""
    weight, bias, group = column_operands(layer, 'weight', 'bias')
    return column_conv(x, weight.to(x.dtype),
                       None if bias is None else bias.to(x.dtype),
                       layer.kernel_size[0] // 2, group)


class Darknet19(nn.Module):
    """YOLOv2 backbone + detection head.

    Args:
      num_classes: size of the class set (defines head width).
      num_anchors: anchor boxes per cell.
      dtype: activation dtype (torch.float32 or torch.bfloat16).
      width_div: divide every backbone width by this (floor 4 channels).
      mesh: a `parallel.mesh.Mesh` whose data group the BatchNorm
        statistics span (None: this process's batch alone).
    """

    # (conv index, features, kernel) with pools after 1, 2, 5, 8, 13
    PLAN: Tuple[Tuple[int, int, int], ...] = (
        (1, 32, 3), (2, 64, 3), (3, 128, 3), (4, 64, 1), (5, 128, 3),
        (6, 256, 3), (7, 128, 1), (8, 256, 3), (9, 512, 3), (10, 256, 1),
        (11, 512, 3), (12, 256, 1), (13, 512, 3), (14, 1024, 3),
        (15, 512, 1), (16, 1024, 3), (17, 512, 1), (18, 1024, 3),
        (19, 1024, 3), (20, 1024, 3),
    )
    POOL_AFTER = frozenset((1, 2, 5, 8, 13))

    def __init__(self, num_classes: int = 80, num_anchors: int = 5,
                 dtype: torch.dtype = torch.float32, width_div: int = 1,
                 mesh: Any = None):
        super().__init__()
        self._bn_group = None if mesh is None else mesh.data_group
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.width_div = width_div

        def width(features):
            return max(features // width_div, 4)

        c_in = 3
        for idx, features, kernel in self.PLAN:
            self._add_block(idx, c_in, width(features), kernel)
            c_in = width(features)
        self._add_block(21, width(512), width(64), 1)
        self._add_block(22, 4 * width(64) + c_in, width(1024), 3)
        self.feat_channels = width(1024)
        self.conv_23 = nn.Conv2d(self.feat_channels,
                                 num_anchors * (5 + num_classes), 1)

    def _add_block(self, idx: int, c_in: int, c_out: int, kernel: int):
        self.add_module(f'conv_{idx}', nn.Conv2d(c_in, c_out, kernel,
                                                 bias=False))
        self.add_module(f'norm_{idx}', BatchNorm(c_out,
                                                 group=self._bn_group))

    def _block(self, x, idx: int, train: bool):
        x = conv(x, getattr(self, f'conv_{idx}'))
        x = getattr(self, f'norm_{idx}')(x, train)
        return F.leaky_relu(x, 0.1)

    def features(self, images: torch.Tensor, train: bool = False):
        """images (B, H, W, 3) → (head (B, A·(5+C), H/32, W/32),
        conv_feat (B, 1024, H/32, W/32)), NCHW in the compute dtype."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        skip = None
        for idx, _, _ in self.PLAN:
            x = self._block(x, idx, train)
            if idx == 13:
                skip = x
            if idx in self.POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)        # flax 'VALID' pooling
        skip = space_to_depth_2x(self._block(skip, 21, train))
        x = self._block(torch.cat([skip, x], dim=1), 22, train)
        return conv(x, self.conv_23), x

    def forward(self, images: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) in [0, 1] →
        {'netout': (B, H/32, W/32, A, 5+C),
         'conv_feat': (B, H/32, W/32, 1024)}, both float32."""
        head, feat = self.features(images, train)
        b, _, gh, gw = head.shape
        netout = head.permute(0, 2, 3, 1).reshape(
            b, gh, gw, self.num_anchors, 5 + self.num_classes)
        return {'netout': netout.float(),
                'conv_feat': feat.permute(0, 2, 3, 1).float()}
