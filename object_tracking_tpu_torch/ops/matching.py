"""Track-identity assignment: IoU-cost matching between detection sets.

Port of `object_tracking_tpu/ops/matching.py`:

- `greedy_match`: fixed-shape greedy best-IoU matching;
- `TrackState` / `init_track_state` / `assign_tracks`: the fixed-shape
  track table and class-aware, motion-aware assignment over one frame or
  a window of T frames, batched over a leading clip dimension B. It is
  the custom op `ott_torch::assign_tracks`: on CUDA one launch of the
  kernel `ops/cuda/csrc/assign_tracks.cu` for the whole window, with no
  host sync; on the CPU its plain twin `assign_tracks_plain`, frame by
  frame;
- `hungarian_match` / `TrackManager`: the host-side optimal matcher and
  track book-keeping, in numpy/scipy with their own IoU.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.config import TRACK_GATE_IOU
from object_tracking_tpu_torch.ops.boxes import EPS, pairwise_iou_center
from object_tracking_tpu_torch.ops.cuda import assign as cuda_assign
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


def _sorted_scan_pairs(iou: torch.Tensor, iou_threshold: float
                       ) -> torch.Tensor:
    """`_greedy_pairs` on a batched (B, S, M) masked IoU matrix, as the
    kernel computes it: one scan over the pairs with IoU >= threshold,
    sorted by the key ((0x7fffffff - IoU bits) << 32) | (i << 16) | j
    (IoU descending, flat index ascending), accepting a pair while its row
    and column are both free. A NaN IoU stops the greedy loop at its first
    step (argmax takes it, and it never clears the threshold), so a clip
    with one matches nothing. The threshold must be in (0, 1], where the
    gated IoUs are positive floats whose bits order as integers. Returns
    (B, M) int64: the matched row per column, or -1. Reads the gated pairs
    on the host."""
    b, s, m = iou.shape
    nan = torch.isnan(iou).flatten(1).any(dim=1)
    clip, i, j = ((iou >= iou_threshold) & ~nan[:, None, None]).nonzero(
        as_tuple=True)
    bits = iou[clip, i, j].view(torch.int32).to(torch.int64)
    keys = ((0x7fffffff - bits) << 32) | (i << 16) | j
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(clip[order], stable=True).indices]
    match = [[-1] * m for _ in range(b)]
    used_rows = [set() for _ in range(b)]
    for c, r, col in zip(clip[order].tolist(), i[order].tolist(),
                         j[order].tolist()):
        if r not in used_rows[c] and match[c][col] < 0:
            used_rows[c].add(r)
            match[c][col] = r
    return torch.tensor(match, dtype=torch.int64,
                        device=iou.device).reshape(b, m)


def _assign_frame(state: TrackState, boxes: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float, max_age: int, vel_smooth: float
                  ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """One frame of `assign_tracks_plain`: boxes (B, M, 4), labels (B, M),
    valid (B, M) → (new_state, det_ids (B, M) int32, matched detections
    per clip (B,) int32)."""
    s = state.boxes.shape[1]
    labels = labels.to(torch.int32)
    pred_boxes = torch.cat([state.boxes[..., :2] + state.vel,
                            state.boxes[..., 2:]], dim=-1)    # (B, S, 4)
    iou = pairwise_iou_center(pred_boxes, boxes)              # (B, S, M)
    ok = (state.active[:, :, None] & valid[:, None, :]
          & (state.labels[:, :, None] == labels[:, None, :]))
    iou = torch.where(ok, iou, -1.0)
    match = _sorted_scan_pairs(iou, iou_threshold)            # (B, M)

    matched_det = match >= 0
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
    return new_state, det_ids, matched_det.sum(dim=1, dtype=torch.int32)


def assign_tracks_plain(state: TrackState, boxes: torch.Tensor,
                        labels: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float = TRACK_GATE_IOU,
                        max_age: int = 3, vel_smooth: float = 0.6
                        ) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, frame by frame: a window
    of T frames for B clips, boxes (B, T, M, 4), labels (B, T, M), valid
    (B, T, M) → (the table after the last frame, contiguous; det_ids
    (B, T, M) int32; matched detections per clip over the window (B,)
    int32). Each frame matches by the kernel's sorted scan
    (`_sorted_scan_pairs`), which reads the gated pairs on the host."""
    ids, matches = [], torch.zeros_like(state.next_id)
    for t in range(boxes.shape[1]):
        state, ids_t, matched = _assign_frame(
            state, boxes[:, t], labels[:, t], valid[:, t], iou_threshold,
            max_age, vel_smooth)
        ids.append(ids_t)
        matches = matches + matched
    b, t, m = boxes.shape[:3]
    det_ids = torch.stack(ids, dim=1) if ids else torch.empty(
        (b, t, m), dtype=torch.int32, device=boxes.device)
    return (TrackState(*(x.contiguous() for x in state)), det_ids,
            matches)


def _check_assign(table: Tuple[torch.Tensor, ...], boxes: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float) -> None:
    if not 0.0 < iou_threshold <= 1.0:
        # the sorted scan orders the gated IoUs by their bits
        raise ValueError(f'assign_tracks takes a gate in (0, 1], got '
                         f'{iou_threshold}')
    b, s = table[0].shape[:2]
    want = {'boxes': ((b, s, 4), torch.float32),
            'vel': ((b, s, 2), torch.float32),
            'labels': ((b, s), torch.int32), 'ids': ((b, s), torch.int32),
            'age': ((b, s), torch.int32), 'active': ((b, s), torch.bool),
            'next_id': ((b,), torch.int32)}
    for (name, (shape, dtype)), x in zip(want.items(), table):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f'track state {name}: expected {shape} '
                             f'{dtype}, got {tuple(x.shape)} {x.dtype}')
    if boxes.dim() != 4 or boxes.shape[0] != b or boxes.shape[-1] != 4:
        raise ValueError(f'boxes must be (B, T, M, 4) with B={b}, got '
                         f'{tuple(boxes.shape)}')
    frames = tuple(boxes.shape[:3])
    for name, x, dtype in (('boxes', boxes, torch.float32),
                           ('labels', labels, torch.int32),
                           ('valid', valid, torch.bool)):
        if x.dtype != dtype or (name != 'boxes'
                                and tuple(x.shape) != frames):
            raise ValueError(f'{name}: expected {dtype} over {frames}, got '
                             f'{x.dtype} {tuple(x.shape)}')
    tensors = (*table, boxes, labels, valid)
    if any(x.device != boxes.device for x in tensors):
        raise ValueError('assign_tracks takes its tensors on one device')
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError('assign_tracks takes contiguous tensors')


# The kernel as the custom op `ott_torch::assign_tracks`, so that a traced
# program (torch.export, `serving.py`) records one call of it for a whole
# window: the CUDA implementation launches the kernel (ops/cuda/assign.py),
# the CPU one runs `assign_tracks_plain`, and the fake one gives tracing
# the outputs' shapes. Registering builds nothing; the kernel builds at
# its first launch.
@torch.library.custom_op('ott_torch::assign_tracks', mutates_args=(),
                         device_types='cuda')
def assign_tracks_op(
        boxes: torch.Tensor, vel: torch.Tensor, labels: torch.Tensor,
        ids: torch.Tensor, age: torch.Tensor, active: torch.Tensor,
        next_id: torch.Tensor, det_boxes: torch.Tensor,
        det_labels: torch.Tensor, det_valid: torch.Tensor,
        iou_threshold: float, max_age: int, vel_smooth: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    table = (boxes, vel, labels, ids, age, active, next_id)
    _check_assign(table, det_boxes, det_labels, det_valid, iou_threshold)
    out = cuda_assign.launch(table, det_boxes, det_labels, det_valid,
                             iou_threshold, max_age, vel_smooth)
    assign_tracks.launches += 1
    return out


@assign_tracks_op.register_kernel('cpu')
def _assign_tracks_cpu(boxes, vel, labels, ids, age, active, next_id,
                       det_boxes, det_labels, det_valid, iou_threshold,
                       max_age, vel_smooth):
    table = (boxes, vel, labels, ids, age, active, next_id)
    _check_assign(table, det_boxes, det_labels, det_valid, iou_threshold)
    if det_boxes.shape[1] == 0:        # no frame: a copy, never an alias
        table = tuple(x.clone() for x in table)
    state, det_ids, matches = assign_tracks_plain(
        TrackState(*table), det_boxes, det_labels, det_valid,
        iou_threshold, max_age, vel_smooth)
    return (*state, det_ids, matches)


@assign_tracks_op.register_fake
def _assign_tracks_fake(boxes, vel, labels, ids, age, active, next_id,
                        det_boxes, det_labels, det_valid, iou_threshold,
                        max_age, vel_smooth):
    table = (boxes, vel, labels, ids, age, active, next_id)
    _check_assign(table, det_boxes, det_labels, det_valid, iou_threshold)
    return (*(torch.empty_like(x) for x in table),
            det_labels.new_empty(det_labels.shape),
            next_id.new_empty(next_id.shape))


def assign_tracks(state: TrackState, boxes: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float = TRACK_GATE_IOU, max_age: int = 3,
                  vel_smooth: float = 0.6
                  ) -> Tuple[TrackState, torch.Tensor]:
    """Class-aware, motion-aware greedy track assignment for B clips at
    once, over one frame (boxes (B, M, 4), labels (B, M), valid (B, M))
    or a window of T frames in order (boxes (B, T, M, 4), labels and valid
    (B, T, M)), each frame from the table the frame before left.

    Matches current detections to live tracks by descending IoU against
    each track's constant-velocity predicted box, assigns fresh ids to
    unmatched detections (into free slots; when the table is full the
    excess detections get id -1), ages unmatched tracks — which coast along
    their velocity — and retires those unseen for > max_age frames.

    Returns (new_state, det_ids (B, M) or (B, T, M) int32 — -1 for invalid
    detections).

    One call of the custom op `torch.ops.ott_torch.assign_tracks` for the
    whole window, with a gate in (0, 1]: CUDA tensors launch the kernel
    (S ≤ 1024 slots, M ≤ 4096 detections; each launch counted in
    `assign_tracks.launches`) or raise; CPU tensors run
    `assign_tracks_plain`. Counts (`utils/profiling.count`, with a recorder
    attached) the frames assigned, B·T, as `assign.frames`, those the
    kernel assigned as `assign.kernel_frames`, the greedy loop's steps,
    B·T·min(S, M), as `assign.steps` and the matched detections as
    `assign.matches`.
    """
    window = boxes.dim() == 4
    if not window:
        boxes, labels, valid = boxes[:, None], labels[:, None], valid[:, None]
    b, t, m = boxes.shape[:3]
    s = state.boxes.shape[1]
    out = torch.ops.ott_torch.assign_tracks(
        *(x.contiguous() for x in state), boxes.contiguous(),
        labels.to(torch.int32).contiguous(), valid.contiguous(),
        float(iou_threshold), int(max_age), float(vel_smooth))
    matches = out[8]
    count('assign.frames', b * t)
    count('assign.kernel_frames', b * t if boxes.is_cuda else 0)
    count('assign.steps', b * t * min(s, m))
    count('assign.matches', lambda: matches.sum())
    return TrackState(*out[:7]), out[7] if window else out[7][:, 0]


assign_tracks.launches = 0


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
