"""Track-identity assignment: IoU-cost matching between detection sets.

Port of `object_tracking_tpu/ops/matching.py`:

- `greedy_match`: fixed-shape greedy best-IoU matching;
- `TrackState` / `init_track_state` / `assign_tracks`: the fixed-shape
  track table and one frame of class-aware, motion-aware assignment,
  batched over a leading clip dimension B. Nothing in it reads a tensor
  value on the host, so a frame costs no device sync;
- `hungarian_match` / `TrackManager`: the host-side optimal matcher and
  track book-keeping, in numpy/scipy with their own IoU.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.config import TRACK_GATE_IOU
from object_tracking_tpu_torch.ops.boxes import EPS, pairwise_iou_center
from object_tracking_tpu_torch.utils.profiling import count


def _greedy_pairs(iou: torch.Tensor, iou_threshold: float,
                  steps: int) -> torch.Tensor:
    """Greedy one-to-one matching on a batched (B, N, M) IoU matrix.

    Each step takes the largest remaining IoU (first flat index on ties);
    if it clears the threshold, the pair is matched and its row and column
    are retired. Returns (B, M) int64: the matched row per column, or -1.
    """
    b, n, m = iou.shape
    rows = torch.arange(n, device=iou.device)[None, :, None]
    cols = torch.arange(m, device=iou.device)[None, None, :]
    match = torch.full((b, m), -1, dtype=torch.int64, device=iou.device)
    for _ in range(steps):
        flat = iou.reshape(b, n * m).argmax(dim=1)               # (B,)
        i, j = flat // m, flat % m
        hit = iou.reshape(b, n * m).gather(1, flat[:, None])[:, 0] \
            >= iou_threshold
        match = torch.where(hit[:, None] & (cols[:, 0] == j[:, None]),
                            i[:, None], match)
        retire = (rows == i[:, None, None]) | (cols == j[:, None, None])
        iou = torch.where(hit[:, None, None] & retire, -1.0, iou)
    return match


def greedy_match(boxes_a: torch.Tensor, valid_a: torch.Tensor,
                 boxes_b: torch.Tensor, valid_b: torch.Tensor,
                 iou_threshold: float = TRACK_GATE_IOU) -> torch.Tensor:
    """Greedy one-to-one matching by descending IoU.

    Args:
      boxes_a: (N, 4) center-format (e.g. previous-frame tracks).
      boxes_b: (M, 4) center-format (current detections).
      valid_a/valid_b: boolean masks.

    Returns:
      match: (M,) int32 — for each b-box, the matched a-index or -1.
    """
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    iou = pairwise_iou_center(boxes_a, boxes_b)
    iou = torch.where(valid_a[:, None] & valid_b[None, :], iou, -1.0)
    return _greedy_pairs(iou[None], iou_threshold,
                         min(n, m))[0].to(torch.int32)


class TrackState(NamedTuple):
    """Fixed-shape track table for B clips, slot-indexed (S slots each).

    `ids` holds the public track id of each slot (-1 = unused), `age` the
    frames since last match, `vel` the EMA of the per-frame center
    displacement (constant-velocity motion model: matching happens
    against the motion-predicted box, and unmatched tracks coast along
    their velocity)."""
    boxes: torch.Tensor     # (B, S, 4) center-format
    vel: torch.Tensor       # (B, S, 2) center velocity / frame
    labels: torch.Tensor    # (B, S) int32 class ids
    ids: torch.Tensor       # (B, S) int32 public ids (-1 = unused slot)
    age: torch.Tensor       # (B, S) int32
    active: torch.Tensor    # (B, S) bool
    next_id: torch.Tensor   # (B,) int32


def init_track_state(max_tracks: int = 64, batch: int = 1,
                     device='cpu') -> TrackState:
    b, s = batch, max_tracks
    return TrackState(
        boxes=torch.zeros((b, s, 4), dtype=torch.float32, device=device),
        vel=torch.zeros((b, s, 2), dtype=torch.float32, device=device),
        labels=torch.full((b, s), -1, dtype=torch.int32, device=device),
        ids=torch.full((b, s), -1, dtype=torch.int32, device=device),
        age=torch.zeros((b, s), dtype=torch.int32, device=device),
        active=torch.zeros((b, s), dtype=torch.bool, device=device),
        next_id=torch.zeros((b,), dtype=torch.int32, device=device))


def _scatter_rows(base: torch.Tensor, slot: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """base (B, S, ...) with base[b, slot[b, m]] = values[b, m] where
    slot < S; slot == S drops the write (JAX's mode='drop'). The writes go
    into an (S + 1)-row buffer whose last row is cut off."""
    b, s = base.shape[:2]
    pad = torch.zeros((b, 1) + base.shape[2:], dtype=base.dtype,
                      device=base.device)
    buf = torch.cat([base, pad], dim=1)
    index = slot.reshape(slot.shape + (1,) * (base.dim() - 2))
    buf.scatter_(1, index.expand(values.shape), values)
    return buf[:, :s]


def _gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """src (B, S, ...) → src[b, index[b, m]] of shape (B, M, ...)."""
    idx = index.reshape(index.shape + (1,) * (src.dim() - 2))
    return src.gather(1, idx.expand(index.shape + src.shape[2:]))


def assign_tracks(state: TrackState, boxes: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float = TRACK_GATE_IOU, max_age: int = 3,
                  vel_smooth: float = 0.6
                  ) -> Tuple[TrackState, torch.Tensor]:
    """One frame of class-aware, motion-aware greedy track assignment for
    B clips at once: boxes (B, M, 4), labels (B, M), valid (B, M).

    Matches current detections to live tracks by descending IoU against
    each track's constant-velocity predicted box, assigns fresh ids to
    unmatched detections (into free slots; when the table is full the
    excess detections get id -1), ages unmatched tracks — which coast along
    their velocity — and retires those unseen for > max_age frames.

    Returns (new_state, det_ids (B, M) int32 — -1 for invalid detections).

    Counts (`utils/profiling.count`, with a recorder attached) the greedy
    loop's steps, B·min(S, M), as `assign.steps` and the matched
    detections as `assign.matches`.
    """
    s = state.boxes.shape[1]
    m = boxes.shape[1]
    labels = labels.to(torch.int32)
    pred_boxes = torch.cat([state.boxes[..., :2] + state.vel,
                            state.boxes[..., 2:]], dim=-1)    # (B, S, 4)
    iou = pairwise_iou_center(pred_boxes, boxes)              # (B, S, M)
    ok = (state.active[:, :, None] & valid[:, None, :]
          & (state.labels[:, :, None] == labels[:, None, :]))
    iou = torch.where(ok, iou, -1.0)
    match = _greedy_pairs(iou, iou_threshold, min(s, m))      # (B, M)

    matched_det = match >= 0
    count('assign.steps', match.shape[0] * min(s, m))
    count('assign.matches', lambda: matched_det.sum())
    slot_of_det = torch.where(matched_det, match, 0)
    # which slots got matched this frame (max: the index-0 writes of
    # unmatched detections must not clobber a real hit there)
    slot_hit = torch.zeros_like(state.age).scatter_reduce(
        1, slot_of_det, matched_det.to(torch.int32), 'amax') > 0

    # age/retire unmatched tracks first, freeing their slots
    age = torch.where(slot_hit, 0, state.age + 1)
    active = state.active & (age <= max_age)

    # allocate free slots to new (valid, unmatched) detections in order
    new_det = valid & ~matched_det                            # (B, M)
    free = ~active                                            # (B, S)
    det_rank = torch.cumsum(new_det.to(torch.int32), dim=1) - 1
    # free slot indices in ascending order, then -1: a stable sort puts
    # the free slots first in index order (fixed shape, no host sync)
    n_free = free.sum(dim=1, dtype=torch.int32)               # (B,)
    by_free = torch.argsort((~free).to(torch.int8), dim=1, stable=True)
    positions = torch.arange(s, device=free.device)[None, :]
    free_slots = torch.where(positions < n_free[:, None], by_free, -1)
    placeable = new_det & (det_rank < n_free[:, None])
    new_slot = torch.where(
        placeable, free_slots.gather(1, det_rank.clamp(0, s - 1).long()), -1)

    # ids: matched dets inherit the slot id; placeable dets get fresh ids
    fresh_id = state.next_id[:, None] + det_rank
    det_ids = torch.where(matched_det, state.ids.gather(1, slot_of_det), -1)
    det_ids = torch.where(placeable, fresh_id, det_ids).to(torch.int32)

    # scatter detection data into slots (matched updates + new inserts);
    # non-writing detections point at the dropped row s
    write = matched_det | placeable
    slot = torch.where(write, torch.where(matched_det, slot_of_det,
                                          new_slot), s)
    # unmatched live tracks coast along their velocity
    coast = torch.where((state.active & ~slot_hit)[..., None],
                        pred_boxes, state.boxes)
    new_boxes = _scatter_rows(coast, slot, boxes)
    # EMA velocity for matched tracks; fresh tracks start at rest; a track
    # still at rest bootstraps to the full observed displacement
    inst_vel = boxes[..., :2] - _gather_rows(state.boxes, slot_of_det)[..., :2]
    prev_vel = _gather_rows(state.vel, slot_of_det)
    at_rest = torch.all(prev_vel == 0.0, dim=-1, keepdim=True)
    ema = vel_smooth * inst_vel + (1.0 - vel_smooth) * prev_vel
    det_vel = torch.where(matched_det[..., None],
                          torch.where(at_rest, inst_vel, ema), 0.0)
    new_vel = _scatter_rows(state.vel, slot, det_vel)
    new_labels = _scatter_rows(state.labels, slot, labels)
    new_ids = _scatter_rows(state.ids, slot, det_ids)
    age = _scatter_rows(age, slot, torch.zeros_like(det_ids))
    active = _scatter_rows(active, slot, torch.ones_like(valid))

    new_state = TrackState(
        boxes=new_boxes, vel=new_vel, labels=new_labels, ids=new_ids,
        age=age, active=active,
        next_id=state.next_id + placeable.sum(dim=1, dtype=torch.int32))
    return new_state, det_ids


def _pairwise_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """All-pairs center-format IoU in numpy float32:
    (N, 4), (M, 4) → (N, M)."""
    a = np.asarray(a, np.float32)[:, None, :]
    b = np.asarray(b, np.float32)[None, :, :]
    a_min, a_max = a[..., :2] - a[..., 2:4] / 2, a[..., :2] + a[..., 2:4] / 2
    b_min, b_max = b[..., :2] - b[..., 2:4] / 2, b[..., :2] + b[..., 2:4] / 2
    wh = np.maximum(np.minimum(a_max, b_max) - np.maximum(a_min, b_min),
                    np.float32(0))
    inter = wh[..., 0] * wh[..., 1]
    union = (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter)
    return inter / (union + np.float32(EPS))


def hungarian_match(boxes_a: np.ndarray, boxes_b: np.ndarray,
                    iou_threshold: float = 0.5,
                    labels_a: Optional[np.ndarray] = None,
                    labels_b: Optional[np.ndarray] = None
                    ) -> List[Tuple[int, int]]:
    """Optimal IoU assignment (host, scipy). Returns [(i_a, i_b), ...].

    When labels are given, cross-class pairs are excluded (their IoU is
    forced below any threshold), so a detection can only extend a track
    of its own class.
    """
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return []
    from scipy.optimize import linear_sum_assignment
    iou = _pairwise_iou_np(boxes_a, boxes_b)
    if labels_a is not None and labels_b is not None:
        same = np.asarray(labels_a)[:, None] == np.asarray(labels_b)[None, :]
        iou = np.where(same, iou, -1.0)
    rows, cols = linear_sum_assignment(-iou)
    return [(int(r), int(c)) for r, c in zip(rows, cols)
            if iou[r, c] >= iou_threshold]


class TrackManager:
    """Host-side identity book-keeping over per-frame detections.

    update() matches current detections to live tracks (Hungarian on IoU
    against each track's constant-velocity predicted box), assigns new IDs
    to unmatched detections, coasts unmatched tracks along their velocity,
    and retires tracks unseen for `max_age` frames.
    """

    def __init__(self, iou_threshold: float = TRACK_GATE_IOU,
                 max_age: int = 3, vel_smooth: float = 0.6):
        self.iou_threshold = iou_threshold
        self.max_age = max_age
        self.vel_smooth = vel_smooth
        self._next_id = 0
        self._tracks: Dict[int, np.ndarray] = {}     # id → last box
        self._vel: Dict[int, np.ndarray] = {}        # id → center vel
        self._labels: Dict[int, int] = {}            # id → class id
        self._age: Dict[int, int] = {}

    def reset(self) -> None:
        self._next_id = 0
        self._tracks.clear()
        self._vel.clear()
        self._labels.clear()
        self._age.clear()

    def _predicted(self, tid: int) -> np.ndarray:
        box = self._tracks[tid].copy()
        box[:2] += self._vel.get(tid, 0.0)
        return box

    def update(self, boxes: np.ndarray,
               labels: Optional[np.ndarray] = None) -> List[int]:
        """boxes (M, 4) center-format → per-detection track ids.

        When `labels` (M,) class ids are given, matching is class-aware:
        a detection never continues a track of a different class.
        """
        ids = list(self._tracks.keys())
        prev = np.stack([self._predicted(i) for i in ids]) if ids else \
            np.zeros((0, 4), np.float32)
        prev_labels = None
        if labels is not None and ids:
            prev_labels = np.asarray(
                [self._labels.get(i, -1) for i in ids])
        pairs = hungarian_match(
            prev, boxes, self.iou_threshold,
            labels_a=prev_labels,
            labels_b=np.asarray(labels) if labels is not None and ids
            else None)
        matched_b = {b: ids[a] for a, b in pairs}
        out = []
        seen = set()
        for j in range(len(boxes)):
            if j in matched_b:
                tid = matched_b[j]
                inst = np.asarray(boxes[j], np.float32)[:2] \
                    - self._tracks[tid][:2]
                prev = self._vel.get(tid, np.zeros(2, np.float32))
                # bootstrap a track at rest to the full displacement
                self._vel[tid] = inst if not prev.any() else (
                    self.vel_smooth * inst
                    + (1.0 - self.vel_smooth) * prev)
            else:
                tid = self._next_id
                self._next_id += 1
                self._vel[tid] = np.zeros(2, np.float32)
            out.append(tid)
            seen.add(tid)
            self._tracks[tid] = np.asarray(boxes[j], np.float32)
            if labels is not None:
                self._labels[tid] = int(np.asarray(labels)[j])
            self._age[tid] = 0
        for tid in list(self._tracks):
            if tid not in seen:
                self._age[tid] += 1
                if self._age[tid] > self.max_age:
                    del self._tracks[tid], self._age[tid]
                    self._labels.pop(tid, None)
                    self._vel.pop(tid, None)
                else:
                    # coast: next frame's match happens against the
                    # position the object should have reached
                    self._tracks[tid] = self._predicted(tid)
        return out
