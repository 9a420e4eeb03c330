"""YOLOv2 training-target encoding on tensors, batched over frames.

Port of `object_tracking_tpu/ops/targets.py`. Per object: the grid-cell
center and size in cell units, the best anchor by IoU of the origin-shifted
box, a row [box, 1, one-hot] written at (grid_y, grid_x, anchor), and the
box appended to a rolling true-box buffer of `true_box_buffer` slots.

The JAX code writes in a `fori_loop`, so on a cell/anchor collision the
last accepted object wins, and the slot counter advances only for accepted
objects and wraps at the buffer size. Here every frame of a (N, M) batch is
encoded at once, without a loop over objects and without a host sync:

- each accepted object gets its flat target index and its slot (its rank
  among the frame's accepted objects, mod the buffer size);
- `scatter_reduce(..., 'amax')` of the object index per target and per
  slot picks the last accepted object (a plain scatter with duplicate
  indices has no defined winner on CUDA);
- one gather of the winners' rows fills the targets; an empty target or
  slot stays zero.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from object_tracking_tpu_torch.ops.boxes import iou_center


def _anchor_tensor(anchors, device) -> torch.Tensor:
    """(A, 2) float32 on `device`; a host copy goes without a sync."""
    return torch.as_tensor(anchors, dtype=torch.float32).to(
        device, non_blocking=True).reshape(-1, 2)


def _last_winner(index: torch.Tensor, accept: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Per frame, the largest object index m with accept[n, m] among those
    with index[n, m] == i, for each i < size; -1 where there is none.
    index, accept: (N, M). Returns (N, size) int64."""
    n, m = index.shape
    obj = torch.arange(m, device=index.device).expand(n, m)
    obj = torch.where(accept, obj, torch.full_like(obj, -1))
    slot = torch.where(accept, index, torch.zeros_like(index))
    out = torch.full((n, size), -1, dtype=torch.int64, device=index.device)
    return out.scatter_reduce(1, slot, obj, reduce='amax', include_self=True)


def _gather_rows(rows: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """rows (N, M, D), winner (N, S) with -1 for none → (N, S, D), zero
    where winner is -1."""
    idx = winner.clamp(min=0)
    picked = torch.gather(rows, 1, idx[..., None].expand(-1, -1,
                                                         rows.shape[-1]))
    return picked * (winner >= 0)[..., None].to(rows.dtype)


def encode_targets_batch(boxes_xyxy: torch.Tensor, class_ids: torch.Tensor,
                         valid: torch.Tensor, anchors, *,
                         image_h: int = 416, image_w: int = 416,
                         grid_h: int = 13, grid_w: int = 13,
                         num_classes: int = 80, true_box_buffer: int = 50
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode each frame's objects into YOLO targets.

    Args:
      boxes_xyxy: (..., M, 4) corner-format pixel boxes.
      class_ids: (..., M) int class indices.
      valid: (..., M) bool padding mask (also encodes label filtering).
      anchors: flat (2A,) or (A, 2) anchor priors in grid-cell units.

    Returns:
      y: (..., grid_h, grid_w, A, 5+C) float32 targets;
      b: (..., 1, 1, 1, true_box_buffer, 4) float32 true-box buffer.
    """
    lead = boxes_xyxy.shape[:-2]
    m = boxes_xyxy.shape[-2]
    device = boxes_xyxy.device
    bx = boxes_xyxy.reshape(-1, m, 4).to(torch.float32)
    cls = class_ids.reshape(-1, m).to(torch.int64)
    valid = valid.reshape(-1, m).to(torch.bool)
    anchors = _anchor_tensor(anchors, device)
    num_anchors = anchors.shape[0]

    cell_w = float(image_w) / grid_w
    cell_h = float(image_h) / grid_h
    center_x = 0.5 * (bx[..., 0] + bx[..., 2]) / cell_w
    center_y = 0.5 * (bx[..., 1] + bx[..., 3]) / cell_h
    size_w = (bx[..., 2] - bx[..., 0]) / cell_w
    size_h = (bx[..., 3] - bx[..., 1]) / cell_h
    grid_x = torch.floor(center_x).to(torch.int64)
    grid_y = torch.floor(center_y).to(torch.int64)

    ok = (valid
          & (bx[..., 2] > bx[..., 0]) & (bx[..., 3] > bx[..., 1])
          & (grid_x < grid_w) & (grid_y < grid_h)
          & (grid_x >= 0) & (grid_y >= 0)
          & (cls >= 0) & (cls < num_classes))

    # best anchor by IoU of the origin-shifted box; argmax takes the first
    # of equal maxima, as jnp.argmax does
    zeros = torch.zeros_like(size_w)
    shifted = torch.stack([zeros, zeros, size_w, size_h], dim=-1)
    anchor_boxes = torch.cat(
        [torch.zeros_like(anchors), anchors], dim=-1)          # (A, 4)
    ious = iou_center(shifted[..., None, :], anchor_boxes)     # (N, M, A)
    best_anchor = torch.argmax(ious, dim=-1)

    cell_box = torch.stack([center_x, center_y, size_w, size_h], dim=-1)
    # a comparison, not F.one_hot, which checks its range with a host sync
    # off the card; out-of-range classes are never accepted anyway
    one_hot = (cls[..., None] == torch.arange(
        num_classes, device=device)).to(torch.float32)
    rows = torch.cat([cell_box, torch.ones_like(center_x)[..., None],
                      one_hot], dim=-1)                        # (N, M, 5+C)

    gy = grid_y.clamp(0, grid_h - 1)
    gx = grid_x.clamp(0, grid_w - 1)
    target = (gy * grid_w + gx) * num_anchors + best_anchor
    cells = grid_h * grid_w * num_anchors
    y = _gather_rows(rows, _last_winner(target, ok, cells))

    slot = (torch.cumsum(ok.to(torch.int64), dim=-1) - 1) % true_box_buffer
    b = _gather_rows(cell_box, _last_winner(slot, ok, true_box_buffer))

    y = y.reshape(lead + (grid_h, grid_w, num_anchors, 5 + num_classes))
    b = b.reshape(lead + (1, 1, 1, true_box_buffer, 4))
    return y, b


# one frame (M, 4) → (GH, GW, A, 5+C), (1, 1, 1, TB, 4): the same function
encode_targets = encode_targets_batch


def encode_targets_multiscale(boxes_xyxy: torch.Tensor,
                              class_ids: torch.Tensor, valid: torch.Tensor,
                              heads: Sequence[Tuple], *,
                              image_h: int = 416, image_w: int = 416,
                              true_box_buffer: int = 50):
    """Multi-scale ([yolo]-head) targets: each box is owned by the head
    holding the globally best-IoU anchor (pixel anchors), and written into
    that head's grid in its cell units; every head's buffer holds all
    valid boxes of its class range in its own cell units.

    Args:
      heads: per head (anchors_px flat tuple, grid_h, grid_w, num_classes).
      boxes_xyxy (..., M, 4), class_ids (..., M), valid (..., M).

    Returns:
      (y_heads, b_heads): tuples with one target and one buffer per head.
    """
    device = boxes_xyxy.device
    all_px = torch.cat([_anchor_tensor(h[0], device) for h in heads])
    bx = boxes_xyxy.to(torch.float32)
    sizes = torch.stack([bx[..., 2] - bx[..., 0], bx[..., 3] - bx[..., 1]],
                        dim=-1)
    shifted = torch.cat([torch.zeros_like(sizes), sizes], dim=-1)
    anchor_boxes = torch.cat([torch.zeros_like(all_px), all_px], dim=-1)
    best = torch.argmax(iou_center(shifted[..., None, :], anchor_boxes),
                        dim=-1)

    y_heads, b_heads = [], []
    offset = 0
    for anchors_px, gh, gw, classes in heads:
        count = len(anchors_px) // 2
        own = valid & (best >= offset) & (best < offset + count)
        offset += count
        a_cells = _anchor_tensor(anchors_px, device) * _anchor_tensor(
            [gw / image_w, gh / image_h], device)
        kw = dict(image_h=image_h, image_w=image_w, grid_h=gh, grid_w=gw,
                  num_classes=classes, true_box_buffer=true_box_buffer)
        y, _ = encode_targets_batch(boxes_xyxy, class_ids, own, a_cells, **kw)
        _, b = encode_targets_batch(
            boxes_xyxy, class_ids,
            valid & (class_ids >= 0) & (class_ids < classes), a_cells, **kw)
        y_heads.append(y)
        b_heads.append(b)
    return tuple(y_heads), tuple(b_heads)
