"""Image augmentation on tensors, split into drawing and applying.

Port of `object_tracking_tpu/data/augment.py`:

- geometric: a zoom of up to `scale_max` and a translate, as separable
  bilinear resampling, i.e. two batched matmuls with (n_out, n_in)
  sampling matrices; a horizontal flip; and the matching box fix-up;
- photometric, each applied with its probability: gaussian blur (a
  depthwise conv), additive gaussian noise, pixel dropout, brightness add,
  channel multiply, contrast normalisation.

JAX's PRNG cannot be matched bit for bit, so the function is split in two:
`draw_params` draws every random quantity (scale, offsets, flip, the twelve
photometric draws, the noise and the dropout mask) from one
`torch.Generator` per window, and `apply_params` is the deterministic body
that applies given parameters. A window's T frames share its parameters
(the JAX code reuses one key across the window). Every choice is a
`torch.where` on the device, so nothing syncs with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    scale_max: float = 1.1
    flip_prob: float = 0.5
    blur_prob: float = 0.25
    blur_sigma: float = 1.5
    noise_prob: float = 0.25
    noise_std: float = 0.02
    dropout_prob: float = 0.25
    dropout_rate: float = 0.05
    brightness_prob: float = 0.25
    brightness_delta: float = 0.04
    multiply_prob: float = 0.25
    multiply_range: Tuple[float, float] = (0.5, 1.5)
    contrast_prob: float = 0.25
    contrast_range: Tuple[float, float] = (0.5, 2.0)


# the uniform draws of one window, in the order of `draw_params`
_UNIFORMS = ('scale', 'offx', 'offy', 'flip', 'blur', 'noise_on', 'drop_on',
             'delta', 'bright_on', 'mul', 'mul_on', 'alpha', 'contrast_on')


def draw_params(generators: Sequence[torch.Generator], height: int,
                width: int, cfg: AugmentConfig = AugmentConfig(),
                device='cpu') -> Params:
    """One parameter set per window, each from its own generator (on
    `device`). Returns a dict of (B, ...) tensors: 'scale', 'offx',
    'offy' (pixels), 'flip', 'blur', 'noise_on', 'drop_on', 'bright_on',
    'mul_on', 'contrast_on' (bool), 'delta', 'mul', 'alpha', 'noise'
    (B, H, W, 3, standard normal) and 'keep' (B, H, W, 1, bool)."""
    draws, noise, keep = [], [], []
    for g in generators:
        draws.append(torch.rand(len(_UNIFORMS), generator=g, device=device))
        noise.append(torch.randn((height, width, 3), generator=g,
                                 device=device))
        keep.append(torch.rand((height, width, 1), generator=g,
                               device=device))
    u = dict(zip(_UNIFORMS, torch.stack(draws).unbind(-1)))

    def between(x, lo, hi):
        return lo + x * (hi - lo)

    scale = between(u['scale'], 1.0, cfg.scale_max)
    return {
        'scale': scale,
        'offx': u['offx'] * (scale - 1.0) * width,
        'offy': u['offy'] * (scale - 1.0) * height,
        'flip': u['flip'] < cfg.flip_prob,
        'blur': u['blur'] < cfg.blur_prob,
        'noise': torch.stack(noise),
        'noise_on': u['noise_on'] < cfg.noise_prob,
        'keep': torch.stack(keep) > cfg.dropout_rate,
        'drop_on': u['drop_on'] < cfg.dropout_prob,
        'delta': between(u['delta'], -cfg.brightness_delta,
                         cfg.brightness_delta),
        'bright_on': u['bright_on'] < cfg.brightness_prob,
        'mul': between(u['mul'], *cfg.multiply_range),
        'mul_on': u['mul_on'] < cfg.multiply_prob,
        'alpha': between(u['alpha'], *cfg.contrast_range),
        'contrast_on': u['contrast_on'] < cfg.contrast_prob,
    }


def _resample_matrix(n: int, scale: torch.Tensor,
                     offset: torch.Tensor) -> torch.Tensor:
    """(B, n_out, n_in) bilinear sampling matrices: out[i] = in((i − t)/s)
    in the half-pixel-center convention."""
    i = torch.arange(n, dtype=torch.float32, device=scale.device)
    src = (i[None, :] + 0.5 + offset[:, None]) / scale[:, None] - 0.5
    return torch.clamp_min(1.0 - torch.abs(src[:, :, None] - i[None, None]),
                           0.0)


def _gaussian_kernel(sigma: float, radius: int = 2) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur(images: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur with zero padding on (N, H, W, C): two
    depthwise convs."""
    c = images.shape[-1]
    k = _gaussian_kernel(sigma).to(images.device, non_blocking=True)
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                 padding=(2, 0), groups=c)
    x = F.conv2d(x, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                 padding=(0, 2), groups=c)
    return x.permute(0, 2, 3, 1)


def _where(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-window choice: flag (B,) bool broadcast over a's trailing
    dims."""
    return torch.where(flag.reshape(flag.shape + (1,) * (a.dim() - 1)), a, b)


def apply_params(images: torch.Tensor, boxes_xyxy: torch.Tensor,
                 params: Params, cfg: AugmentConfig = AugmentConfig()):
    """The deterministic body: images (B, T, H, W, 3) float32 in [0, 1] and
    boxes (B, T, M, 4) pixels, with one parameter set per window →
    (images', boxes'), same shapes."""
    b, t, h, w, c = images.shape
    p = params
    scale, offx, offy = p['scale'], p['offx'], p['offy']

    # zoom + translate: out = Wy · image · Wxᵀ per window, for all frames
    wy = _resample_matrix(h, scale, offy)                     # (B, H, H)
    wx = _resample_matrix(w, scale, offx)                     # (B, W, W)
    x = torch.matmul(wy, images.permute(0, 2, 1, 3, 4).reshape(b, h, -1))
    x = x.reshape(b, h, t, w, c).permute(0, 3, 2, 1, 4).reshape(b, w, -1)
    x = torch.matmul(wx, x).reshape(b, w, t, h, c).permute(0, 2, 3, 1, 4)

    sc = scale[:, None, None]
    x1 = boxes_xyxy[..., 0] * sc - offx[:, None, None]
    y1 = boxes_xyxy[..., 1] * sc - offy[:, None, None]
    x2 = boxes_xyxy[..., 2] * sc - offx[:, None, None]
    y2 = boxes_xyxy[..., 3] * sc - offy[:, None, None]

    flip = p['flip']
    x = _where(flip, x.flip(3), x)
    fx1 = _where(flip, w - x2, x1)
    fx2 = _where(flip, w - x1, x2)
    boxes = torch.stack([fx1.clamp(0, w), y1.clamp(0, h),
                         fx2.clamp(0, w), y2.clamp(0, h)], dim=-1)

    blurred = _blur(x.reshape(b * t, h, w, c), cfg.blur_sigma).reshape(
        x.shape)
    x = _where(p['blur'], blurred, x)
    x = _where(p['noise_on'], x + (p['noise'] * cfg.noise_std)[:, None], x)
    x = _where(p['drop_on'], x * p['keep'][:, None].to(x.dtype), x)
    x = _where(p['bright_on'], x + p['delta'][:, None, None, None, None], x)
    x = _where(p['mul_on'], x * p['mul'][:, None, None, None, None], x)
    alpha = p['alpha'][:, None, None, None, None]
    mean = x.mean(dim=(2, 3), keepdim=True)                  # per frame
    x = _where(p['contrast_on'], (x - mean) * alpha + mean, x)
    return torch.clamp(x, 0.0, 1.0), boxes


def window_generators(seeds, device) -> list:
    """One generator on `device` per window, seeded from the host ints
    `seeds` (a raw batch's 'aug_seeds')."""
    out = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        out.append(g)
    return out


def augment_sequences_batch(seeds, images: torch.Tensor,
                            boxes_xyxy: torch.Tensor,
                            cfg: AugmentConfig = AugmentConfig()):
    """(B,) host seeds + images (B, T, H, W, 3) + boxes (B, T, M, 4): one
    parameter set per window, drawn on the images' device."""
    _, _, h, w, _ = images.shape
    params = draw_params(window_generators(seeds, images.device), h, w, cfg,
                         images.device)
    return apply_params(images, boxes_xyxy, params, cfg)


def augment_sequence(seed: int, images: torch.Tensor,
                     boxes_xyxy: torch.Tensor,
                     cfg: AugmentConfig = AugmentConfig()):
    """One window (T, H, W, 3) + (T, M, 4), every frame the same
    transform."""
    out, boxes = augment_sequences_batch([seed], images[None],
                                         boxes_xyxy[None], cfg)
    return out[0], boxes[0]


def augment_frames_batch(seeds, images: torch.Tensor,
                         boxes_xyxy: torch.Tensor,
                         cfg: AugmentConfig = AugmentConfig()):
    """(B,) seeds + (B, H, W, 3) + (B, M, 4), independent per frame."""
    out, boxes = augment_sequences_batch(seeds, images[:, None],
                                         boxes_xyxy[:, None], cfg)
    return out[:, 0], boxes[:, 0]


def augment_frame(seed: int, image: torch.Tensor, boxes_xyxy: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig()):
    """One frame (H, W, 3) + (M, 4)."""
    out, boxes = augment_sequences_batch([seed], image[None, None],
                                         boxes_xyxy[None, None], cfg)
    return out[0, 0], boxes[0, 0]
