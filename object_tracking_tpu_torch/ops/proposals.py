"""Region proposals and class-specific boxes for a two-stage detector, on
the device, for a batch of images at once.

The JAX package has no two-stage detector; this follows py-faster-rcnn
(`lib/rpn/generate_anchors.py`, `lib/rpn/proposal_layer.py`,
`lib/fast_rcnn/bbox_transform.py`, `tools/test_net.py`), with the
conventions of Caffe's pixel boxes: corners (x1, y1, x2, y2) whose widths
count both ends (w = x2 − x1 + 1).

- `generate_anchors`: the base anchors, ratio-major;
- `shifted_anchors`: those anchors at every cell of a feature map, in
  (h, w, a) order (shifts outer, anchors inner);
- `decode` (`bbox_transform_inv`), `clip`, `centre_form` (corners →
  (cx, cy, w, h) with the +1 widths, the form the NMS kernel takes);
- `propose`: the proposal layer for B images in one pass, with no host
  synchronisation: decode, clip, the minimum-size filter, the top
  `pre_nms` by foreground score (ties by the lower anchor index: a stable
  sort), greedy NMS on kernel 1 (`ops/cuda/nms.py::nms_scores` through
  `ops/nms.py::greedy_nms_scores`, one launch for the B images), the
  first `post_nms` kept;
- `class_detections`: each RoI's class-specific boxes, the score
  threshold, per-class greedy NMS on kernel 1 over (image, class)
  pseudo-frames in one launch, and the best `max_per_image` of each image.

Kernel 1 suppresses a candidate whose IoU with a kept one is at least the
threshold, with its continuous IoU inter / max(union, 1e-12) on centre-form
boxes. Boxes given with the +1 widths cover [x1, x2 + 1], so that IoU is
py-faster-rcnn's +1 IoU up to rounding (which suppresses above the
threshold, not at it).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.ops.nms import greedy_nms_scores
from object_tracking_tpu_torch.utils.profiling import count


def generate_anchors(base_size: int = 16,
                     ratios: Sequence[float] = (0.5, 1.0, 2.0),
                     scales: Sequence[float] = (8, 16, 32)) -> np.ndarray:
    """py-faster-rcnn's `generate_anchors`: (len(ratios)·len(scales), 4)
    corners of a base_size cell's anchors, ratio-major, with its own
    rounding (np.round, half to even)."""
    w = h = float(base_size)
    cx = cy = 0.5 * (base_size - 1)
    out = []
    for ratio in ratios:
        ws = np.round(np.sqrt(w * h / ratio))
        hs = np.round(ws * ratio)
        for scale in scales:
            a, b = ws * scale, hs * scale
            out.append([cx - 0.5 * (a - 1), cy - 0.5 * (b - 1),
                        cx + 0.5 * (a - 1), cy + 0.5 * (b - 1)])
    return np.asarray(out, np.float32)


def shifted_anchors(base: np.ndarray, gh: int, gw: int, stride: int,
                    device) -> torch.Tensor:
    """`base` (A, 4) shifted by stride·(x, y) to every cell of a gh×gw
    map: (gh·gw·A, 4) float32, anchor (h·gw + w)·A + a."""
    sx = np.arange(gw, dtype=np.float32) * stride
    sy = np.arange(gh, dtype=np.float32) * stride
    xx, yy = np.meshgrid(sx, sy)
    shifts = np.stack([xx, yy, xx, yy], axis=-1).reshape(-1, 1, 4)
    return torch.from_numpy((shifts + base[None]).reshape(-1, 4)).to(device)


def decode(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """`bbox_transform_inv`: corners (..., 4) moved by deltas (dx, dy, dw,
    dh) (..., 4), broadcast → corners."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx, dy, dw, dh = deltas.unbind(-1)
    px = dx * widths + ctr_x
    py = dy * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph,
                        px + 0.5 * pw, py + 0.5 * ph], dim=-1)


def clip(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Corners clipped to [0, w − 1] × [0, h − 1]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w - 1), y1.clamp(0, h - 1),
                        x2.clamp(0, w - 1), y2.clamp(0, h - 1)], dim=-1)


def centre_form(boxes: torch.Tensor) -> torch.Tensor:
    """Corners → (cx, cy, w, h) with w = x2 − x1 + 1, cx = x1 + 0.5·w."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return torch.stack([boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h,
                        w, h], dim=-1)


def _nms(boxes: torch.Tensor, scores: torch.Tensor,
         thresh: float) -> torch.Tensor:
    """Kernel 1 over every candidate (`ops/nms.py`'s op path: the kernel
    on a CUDA tensor, its plain twin on a CPU one, the same IoU): (F, K, C)
    scores with the suppressed ones zeroed."""
    return greedy_nms_scores(boxes, scores, thresh, top_k=0, impl='op')[1]


def _gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, N, D)[b, index[b, k]] → (B, K, D)."""
    return x.gather(1, index[..., None].expand(-1, -1, x.shape[-1]))


def propose(fg: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
            image_hw: Tuple[int, int], min_size: float, pre_nms: int,
            post_nms: int, nms_thresh: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The proposal layer for B images: foreground scores fg (B, N) and
    deltas (B, N, 4) of the anchors (N, 4) → (rois (B, post_nms, 4)
    corners, valid (B, post_nms)). Image b's first valid rows are its
    proposals in the order NMS kept them; an image with fewer keeps fewer
    (the rest zero and not valid).

    The candidates enter the NMS sorted, with their rank as the score
    (pre_nms for the best, down to 1), so that kernel 1 walks them in
    exactly that order whatever their probabilities; the boxes the
    minimum-size filter drops score 0 and are never picked. Counts (with
    a recorder attached) `rcnn.pre_nms` (candidates into the NMS),
    `rcnn.proposals` (RoIs kept) and `rcnn.short_images` (images with
    fewer than post_nms)."""
    h, w = image_hw
    b, n = fg.shape
    boxes = clip(decode(anchors, deltas), h, w)
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    ok = (bw >= min_size) & (bh >= min_size)
    k = min(pre_nms, n)
    order = torch.sort(torch.where(ok, fg, torch.full_like(fg, -1.0)),
                       dim=1, descending=True, stable=True).indices[:, :k]
    cand = _gather_rows(boxes, order)
    cand_ok = ok.gather(1, order)
    rank = torch.arange(k, 0, -1, dtype=torch.float32, device=fg.device)
    score = torch.where(cand_ok, rank, torch.zeros_like(rank))
    kept = _nms(centre_form(cand), score[..., None], nms_thresh)[..., 0]
    top = torch.topk(kept, min(post_nms, k), dim=1)
    valid = top.values > 0
    rois = torch.where(valid[..., None], _gather_rows(cand, top.indices),
                       torch.zeros((), device=fg.device))
    if rois.shape[1] < post_nms:
        pad = post_nms - rois.shape[1]
        rois = torch.cat([rois, rois.new_zeros((b, pad, 4))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    count('rcnn.pre_nms', lambda: cand_ok.sum())
    count('rcnn.proposals', lambda: valid.sum())
    count('rcnn.short_images', lambda: (valid.sum(1) < post_nms).sum())
    return rois, valid


def class_detections(cls_prob: torch.Tensor, bbox_pred: torch.Tensor,
                     rois: torch.Tensor, valid: torch.Tensor,
                     image_hw: Tuple[int, int], score_thresh: float,
                     nms_thresh: float, max_per_image: int):
    """`im_detect`'s boxes and `test_net`'s selection for B images: class
    probabilities (B, R, K) (class 0 the background), box deltas
    (B, R, 4K) and the RoIs (B, R, 4) with their valid mask → padded
    detections (boxes (B, M, 4) image-relative (cx, cy, w, h), labels
    (B, M) in 1..K−1, scores (B, M), valid (B, M)), M = max_per_image,
    best first.

    Each class's deltas decode against its RoI and are clipped; a class
    score above `score_thresh` enters that class's greedy NMS (kernel 1,
    one launch over the B·(K−1) (image, class) pseudo-frames of R
    candidates); the image keeps the best `max_per_image` over its
    classes, ties by class, then RoI. Counts (with a recorder attached)
    `rcnn.detections` and `rcnn.capped` (images the cap cut)."""
    h, w = image_hw
    b, r, k = cls_prob.shape
    boxes = clip(decode(rois[:, :, None, :], bbox_pred.reshape(b, r, k, 4)),
                 h, w)[:, :, 1:].transpose(1, 2)        # (B, K−1, R, 4)
    scores = cls_prob[:, :, 1:].transpose(1, 2)         # (B, K−1, R)
    live = (scores > score_thresh) & valid[:, None, :]
    scores = torch.where(live, scores, torch.zeros_like(scores))
    kept = _nms(centre_form(boxes).reshape(-1, r, 4),
                scores.reshape(-1, r, 1), nms_thresh).reshape(b, (k - 1) * r)
    m = min(max_per_image, kept.shape[1])
    best = torch.sort(kept, dim=1, descending=True, stable=True)
    top, index = best.values[:, :m], best.indices[:, :m]
    picked = _gather_rows(centre_form(boxes).reshape(b, (k - 1) * r, 4),
                          index)
    # a tensor made on the device: no copy from the host, and a true
    # division (CUDA divides by a host scalar as a product by its inverse)
    size = torch.full((4,), float(w), device=picked.device)
    size[1::2] = float(h)
    found = top > 0
    count('rcnn.detections', lambda: found.sum())
    count('rcnn.capped', lambda: ((kept > 0).sum(1) > max_per_image).sum())
    return picked / size, index // r + 1, top, found
