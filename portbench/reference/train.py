"""Plain reference of the training path: augmentation, YOLOv2 target
encoding, the YOLOv2 loss (joint: 0.7 track + 0.3 detect over the B·T
frames) and Adam.

Written from the reference repository's training code (ktzsh/object-
tracking: KerasYOLO.py's custom_loss, the BatchGenerator's target
writing, imgaug's zoom, translate, flip, blur, noise, dropout, add,
multiply and contrast steps; Keras' Adam) in plain torch ops and numpy
loops. Imports nothing of the program. The random draws of one window's
augmentation come from one torch.Generator on the images' device, seeded
by the window's seed, in this order: 13 uniforms (scale, x and y offsets,
flip, blur, noise on, dropout on, brightness delta, brightness on,
multiplier, multiply on, contrast alpha, contrast on), a (H, W, 3) normal
(the noise) and a (H, W, 1) uniform (the dropout mask).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model as ref_model

AUGMENT = {'scale_max': 1.1, 'flip_prob': 0.5, 'blur_prob': 0.25,
           'blur_sigma': 1.5, 'noise_prob': 0.25, 'noise_std': 0.02,
           'dropout_prob': 0.25, 'dropout_rate': 0.05,
           'brightness_prob': 0.25, 'brightness_delta': 0.04,
           'multiply_prob': 0.25, 'multiply_range': (0.5, 1.5),
           'contrast_prob': 0.25, 'contrast_range': (0.5, 2.0)}


def _draws(seed: int, h: int, w: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand(13, generator=g, device=device)
    noise = torch.randn((h, w, 3), generator=g, device=device)
    keep = torch.rand((h, w, 1), generator=g, device=device)
    a = AUGMENT
    scale = 1.0 + u[0] * (a['scale_max'] - 1.0)
    lo_m, hi_m = a['multiply_range']
    lo_c, hi_c = a['contrast_range']
    return {'scale': scale, 'offx': u[1] * (scale - 1.0) * w,
            'offy': u[2] * (scale - 1.0) * h, 'flip': bool(u[3] < 0.5),
            'blur': bool(u[4] < a['blur_prob']),
            'noise_on': bool(u[5] < a['noise_prob']), 'noise': noise,
            'drop_on': bool(u[6] < a['dropout_prob']),
            'keep': keep > a['dropout_rate'],
            'delta': -a['brightness_delta'] + u[7] * 2 * a['brightness_delta'],
            'bright_on': bool(u[8] < a['brightness_prob']),
            'mul': lo_m + u[9] * (hi_m - lo_m),
            'mul_on': bool(u[10] < a['multiply_prob']),
            'alpha': lo_c + u[11] * (hi_c - lo_c),
            'contrast_on': bool(u[12] < a['contrast_prob'])}


def _sampling(n: int, scale, offset) -> torch.Tensor:
    """(n_out, n_in) bilinear weights of out[i] = in((i + 0.5 + offset) /
    scale - 0.5), pixel centres at half-integers."""
    i = torch.arange(n, dtype=torch.float32, device=scale.device)
    src = (i + 0.5 + offset) / scale - 0.5
    return torch.clamp(1.0 - (src[:, None] - i[None, :]).abs(), min=0.0)


def _gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """(T, H, W, 3): separable 5-tap gaussian, zero padding."""
    taps = torch.exp(-0.5 * (torch.arange(-2, 3, dtype=torch.float32)
                             / sigma) ** 2)
    taps = (taps / taps.sum()).tolist()
    for axis in (1, 2):
        n = x.shape[axis]
        xp = F.pad(x, _pad_spec(axis))
        x = sum(tap * xp.narrow(axis, d, n) for d, tap in enumerate(taps))
    return x


def _pad_spec(axis: int) -> list:
    # F.pad lists the last dimension first: (C, W, H) pairs for (T, H, W, C)
    return [0, 0, 2, 2, 0, 0] if axis == 2 else [0, 0, 0, 0, 2, 2]


def augment_window(seed: int, frames: torch.Tensor, boxes: torch.Tensor):
    """One window: frames (T, H, W, 3) in [0, 1], boxes (T, M, 4) pixel
    corners → both augmented, every frame with the window's draws."""
    t, h, w, _ = frames.shape
    p = _draws(seed, h, w, frames.device)
    wy = _sampling(h, p['scale'], p['offy'])
    wx = _sampling(w, p['scale'], p['offx'])
    x = torch.einsum('ij,tjwc->tiwc', wy, frames)
    x = torch.einsum('ij,thjc->thic', wx, x)
    x1 = boxes[..., 0] * p['scale'] - p['offx']
    y1 = boxes[..., 1] * p['scale'] - p['offy']
    x2 = boxes[..., 2] * p['scale'] - p['offx']
    y2 = boxes[..., 3] * p['scale'] - p['offy']
    if p['flip']:
        x = x.flip(2)
        x1, x2 = w - x2, w - x1
    boxes = torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w),
                         y2.clamp(0, h)], dim=-1)
    if p['blur']:
        x = _gaussian_blur(x, AUGMENT['blur_sigma'])
    if p['noise_on']:
        x = x + p['noise'] * AUGMENT['noise_std']
    if p['drop_on']:
        x = x * p['keep'].to(x.dtype)
    if p['bright_on']:
        x = x + p['delta']
    if p['mul_on']:
        x = x * p['mul']
    if p['contrast_on']:
        mean = x.mean(dim=(1, 2), keepdim=True)
        x = (x - mean) * p['alpha'] + mean
    return x.clamp(0.0, 1.0), boxes


def encode_targets(boxes: np.ndarray, cls: np.ndarray, valid: np.ndarray,
                   cfg: dict):
    """Per frame, objects in order: (N, M, 4) pixel corners, (N, M), (N, M)
    → y (N, GH, GW, A, 5+C) and the true-box buffer (N, 1, 1, 1, TB, 4).
    An object is written at its centre's cell and its best anchor (IoU of
    the origin-aligned boxes, first on ties) as [x, y, w, h, 1, one-hot] in
    cell units, a later object overwriting an earlier one there, and into
    the next slot of the buffer, which wraps."""
    image, grid = cfg['image'], cfg['image'] // 32
    classes, tb = cfg['num_classes'], cfg['true_box_buffer']
    anchors = np.asarray(cfg['anchors'], np.float32).reshape(-1, 2)
    a = anchors.shape[0]
    cell = np.float32(image / grid)
    n, m = cls.shape
    y = np.zeros((n, grid, grid, a, 5 + classes), np.float32)
    buf = np.zeros((n, 1, 1, 1, tb, 4), np.float32)
    for i in range(n):
        slot = 0
        for j in range(m):
            x1, y1, x2, y2 = boxes[i, j].astype(np.float32)
            c = int(cls[i, j])
            if not (valid[i, j] and x2 > x1 and y2 > y1
                    and 0 <= c < classes):
                continue
            cx = np.float32(0.5) * (x1 + x2) / cell
            cy = np.float32(0.5) * (y1 + y2) / cell
            bw, bh = (x2 - x1) / cell, (y2 - y1) / cell
            gx, gy = int(np.floor(cx)), int(np.floor(cy))
            if not (0 <= gx < grid and 0 <= gy < grid):
                continue
            inter = np.minimum(bw, anchors[:, 0]) * np.minimum(bh,
                                                               anchors[:, 1])
            iou = inter / (bw * bh + anchors[:, 0] * anchors[:, 1] - inter
                           + np.float32(1e-10))
            best = int(np.argmax(iou))
            y[i, gy, gx, best] = 0.0
            y[i, gy, gx, best, :5] = (cx, cy, bw, bh, 1.0)
            y[i, gy, gx, best, 5 + c] = 1.0
            buf[i, 0, 0, 0, slot % tb] = (cx, cy, bw, bh)
            slot += 1
    return y, buf


def _iou(xy_a, wh_a, xy_b, wh_b):
    lo = torch.maximum(xy_a - wh_a / 2, xy_b - wh_b / 2)
    hi = torch.minimum(xy_a + wh_a / 2, xy_b + wh_b / 2)
    inter = (hi - lo).clamp(min=0).prod(-1)
    union = wh_a.prod(-1) + wh_b.prod(-1) - inter
    return inter / (union + 1e-10)


def yolo_loss(pred: torch.Tensor, y: torch.Tensor, true_boxes: torch.Tensor,
              anchors, loss: dict) -> torch.Tensor:
    """YOLOv2's loss (no warm-up) over (N, GH, GW, A, 5+C) predictions:
    squared errors of the centre, the size and the confidence (the IoU of
    the predicted with the true box where an object is, 0 elsewhere, and
    only where the best IoU against the frame's true boxes is under the
    threshold) each over twice its count of weighted cells, plus the
    softmax cross-entropy of the class over its count."""
    n, gh, gw, a = pred.shape[:4]
    dev = pred.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=dev).reshape(a, 2)
    col = torch.arange(gw, dtype=torch.float32, device=dev)
    row = torch.arange(gh, dtype=torch.float32, device=dev)
    offset = torch.stack(torch.broadcast_tensors(
        col[None, :, None], row[:, None, None]), dim=-1)   # (GH, GW, 1, 2)
    xy = torch.sigmoid(pred[..., :2]) + offset
    wh = torch.exp(pred[..., 2:4]) * anchors
    conf = torch.sigmoid(pred[..., 4])
    obj = y[..., 4]
    true_conf = _iou(xy, wh, y[..., :2], y[..., 2:4]) * obj
    best = _iou(xy[..., None, :], wh[..., None, :], true_boxes[..., :2],
                true_boxes[..., 2:4]).amax(-1)
    coord_w = obj * loss['coord_scale']
    conf_w = ((best < loss['best_iou_threshold']).float() * (1 - obj)
              * loss['no_object_scale'] + obj * loss['object_scale'])
    class_w = obj * loss['class_scale']
    n_coord = (coord_w > 0).sum().float()
    n_conf = (conf_w > 0).sum().float()
    n_class = (class_w > 0).sum().float()
    eps = 1e-6
    l_xy = (((y[..., :2] - xy) ** 2).sum(-1) * coord_w).sum() \
        / (n_coord + eps) / 2
    l_wh = (((y[..., 2:4] - wh) ** 2).sum(-1) * coord_w).sum() \
        / (n_coord + eps) / 2
    l_conf = ((true_conf - conf) ** 2 * conf_w).sum() / (n_conf + eps) / 2
    target = y[..., 5:].argmax(-1)
    ce = F.cross_entropy(pred[..., 5:].reshape(-1, pred.shape[-1] - 5),
                         target.reshape(-1), reduction='none')
    l_class = (ce.reshape(target.shape) * class_w).sum() / (n_class + eps)
    return l_xy + l_wh + l_conf + l_class


def joint_batch(raw: dict, cfg: dict, device):
    """A raw joint batch (uint8 windows, pixel boxes, classes, validity,
    window seeds) → the augmented images (B, T, H, W, 3) and the targets,
    on `device`."""
    images = torch.as_tensor(raw['images_u8']).to(device).float() / 255.0
    boxes = torch.as_tensor(raw['boxes']).to(device).float()
    outs = [augment_window(int(s), images[i], boxes[i])
            for i, s in enumerate(raw['aug_seeds'])]
    images = torch.stack([o[0] for o in outs])
    boxes = torch.stack([o[1] for o in outs])
    b, t, m = raw['cls'].shape
    y, tb = encode_targets(boxes.reshape(b * t, m, 4).cpu().numpy(),
                           raw['cls'].reshape(b * t, m),
                           raw['valid'].reshape(b * t, m), cfg)
    return images, torch.as_tensor(y).to(device), torch.as_tensor(tb).to(
        device)


def joint_loss(w: Dict[str, torch.Tensor], cfg: dict, batch) -> torch.Tensor:
    """The joint model's training loss of one prepared batch under
    weights `w`: both YOLOv2 losses over the B·T frames, weighted."""
    loss = cfg['loss']
    images, y, tb = batch
    out = ref_model.joint_forward(w, cfg, images)
    track = yolo_loss(out['track'].flatten(0, 1), y, tb, cfg['anchors'],
                      loss)
    detect = yolo_loss(out['detect'].flatten(0, 1), y, tb, cfg['anchors'],
                       loss)
    return loss['weight_track'] * track + loss['weight_detect'] * detect


def detector_loss(w: Dict[str, torch.Tensor], cfg: dict,
                  batch) -> torch.Tensor:
    """The detector's YOLOv2 loss of one prepared batch under `w`."""
    images, y, tb = batch
    out = ref_model.detector_forward(w, cfg, images)
    return yolo_loss(out['netout'], y, tb, cfg['anchors'], cfg['loss'])


class Adam:
    """Adam (Kingma & Ba) with Keras' constants: b1 0.9, b2 0.999, eps
    1e-7 added to the bias-corrected sqrt(v)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.params, self.lr = list(params), lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = math.sqrt(1 - self.b2 ** self.t)
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / (v.sqrt() / c2 + self.eps))


def three_steps(w: Dict[str, torch.Tensor], names: Sequence[str],
                loss_of: Callable, batches: list, lr: float) -> dict:
    """The reference's first steps from weights `w` (changed in place),
    training the leaves `names` on `loss_of(w, batch)`: each step's loss,
    each leaf's first gradient norm, and each leaf's change after the
    last step."""
    start = {n: w[n].detach().clone() for n in names}
    params = [w[n].detach().requires_grad_(True) for n in names]
    for n, p in zip(names, params):
        w[n] = p
    opt = Adam(params, lr)
    losses, first = [], None
    for batch in batches:
        loss = loss_of(w, batch)
        grads = torch.autograd.grad(loss, params)
        if first is None:
            first = {n: float(g.norm()) for n, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        opt.step(grads)
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in zip(names, params)}
    return {'losses': losses, 'grad_norms': first, 'change_norms': change}
