"""Bounding-box math on tensors; broadcasts over leading dims.

Formats:
- cxcywh: (center_x, center_y, w, h)
- xyxy:   (xmin, ymin, xmax, ymax)

The operation order follows `object_tracking_tpu/ops/boxes.py` so that
float32 results agree with it bit for bit on the same inputs.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-format → corner-format."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner-format → center-format."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack(
        [(x1 + x2) / 2.0, (y1 + y2) / 2.0, x2 - x1, y2 - y1], dim=-1)


def interval_overlap(a_min, a_max, b_min, b_max):
    """Overlap length of [a_min, a_max] and [b_min, b_max], >= 0."""
    return torch.clamp_min(
        torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), 0.0)


def iou_center(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of center-format boxes; broadcasts over leading dims."""
    a_xy, a_wh = a[..., :2], a[..., 2:4]
    b_xy, b_wh = b[..., :2], b[..., 2:4]
    a_min, a_max = a_xy - a_wh / 2.0, a_xy + a_wh / 2.0
    b_min, b_max = b_xy - b_wh / 2.0, b_xy + b_wh / 2.0
    iw = interval_overlap(a_min[..., 0], a_max[..., 0],
                          b_min[..., 0], b_max[..., 0])
    ih = interval_overlap(a_min[..., 1], a_max[..., 1],
                          b_min[..., 1], b_max[..., 1])
    inter = iw * ih
    union = (a_wh[..., 0] * a_wh[..., 1] + b_wh[..., 0] * b_wh[..., 1]
             - inter)
    return inter / (union + EPS)


def iou_corner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of corner-format boxes; broadcasts over leading dims."""
    iw = interval_overlap(a[..., 0], a[..., 2], b[..., 0], b[..., 2])
    ih = interval_overlap(a[..., 1], a[..., 3], b[..., 1], b[..., 3])
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + EPS)


def pairwise_iou_center(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: a (..., N, 4), b (..., M, 4) → (..., N, M)."""
    return iou_center(a[..., :, None, :], b[..., None, :, :])
