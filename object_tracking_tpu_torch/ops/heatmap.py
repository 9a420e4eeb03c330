"""Occupancy-heatmap codec of the heatmap tracker, as tensor mask ops.

Port of `object_tracking_tpu/ops/heatmap.py`. Both directions compare
broadcast index grids, with no data-dependent control flow, and take any
leading dims.

- `heatmap_encode` truncates coordinates toward zero (`torch.trunc`, not
  `floor`: the heatmap targets feed negative top-left corners cx − w/2,
  where the two differ) and paints the inclusive block
  [y : y+h+1, x : x+w+1]; a block past the left or top edge is clamped.
- `heatmap_decode_rect` returns the tightest cell rectangle (x1, y1, x2,
  y2) covering the cells >= thresh, and (hmap, hmap, −1, −1) for an empty
  heatmap.
"""

from __future__ import annotations

import torch


def heatmap_encode(x, y, w, h, hmap_size: int = 32) -> torch.Tensor:
    """Binary occupancy grid of a top-left-format normalised box.

    x, y (top-left corner) and w, h, all in [0, 1], broadcastable tensors
    or scalars → (..., hmap_size²) float32, the grid flattened row-major.
    """
    s = float(hmap_size)

    def cells(v):
        v = torch.as_tensor(v, dtype=torch.float32)
        return torch.trunc(v * s)[..., None, None]

    sx, sy, sw, sh = cells(x), cells(y), cells(w), cells(h)
    device = sx.device
    rows = torch.arange(hmap_size, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(hmap_size, dtype=torch.float32, device=device)[None, :]
    row_mask = (rows >= sy) & (rows <= sy + sh)
    col_mask = (cols >= sx) & (cols <= sx + sw)
    heat = (row_mask & col_mask).to(torch.float32)
    return heat.reshape(heat.shape[:-2] + (hmap_size * hmap_size,))


def heatmap_decode_rect(heatmap: torch.Tensor, thresh: float = 0.75,
                        hmap_size: int = 32):
    """Tightest cell-aligned rectangle covering the cells >= thresh of a
    (..., hmap_size²) heatmap → (x1, y1, x2, y2) int32 tensors in cell
    units, (hmap_size, hmap_size, −1, −1) where no cell is on."""
    heat = torch.as_tensor(heatmap)
    heat = heat.reshape(heat.shape[:-1] + (hmap_size, hmap_size))
    mask = heat >= thresh
    rows = torch.arange(hmap_size, dtype=torch.int32,
                        device=heat.device)[:, None].expand(mask.shape)
    cols = torch.arange(hmap_size, dtype=torch.int32,
                        device=heat.device)[None, :].expand(mask.shape)
    big = torch.full_like(rows, hmap_size)
    none = torch.full_like(rows, -1)

    def reduce(values, fill, op):
        return op(torch.where(mask, values, fill).flatten(-2), dim=-1)

    return (reduce(cols, big, torch.amin), reduce(rows, big, torch.amin),
            reduce(cols, none, torch.amax), reduce(rows, none, torch.amax))
