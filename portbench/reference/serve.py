"""Plain reference of the serving path after the model: YOLOv2 decode, the
top-K candidate cap, per-class greedy NMS and greedy track assignment.

Written from the reference repository's semantics (ktzsh/object-tracking's
decode_netout and do_nms, the JAX package's fixed-shape track table) in
torch ops for the decode and in numpy loops for the rest. Imports nothing
of the program.

- Decode (torch, float32, on the netout's device): conf = sigmoid(t_o),
  class scores conf·softmax(t_c) kept where > obj_threshold; box
  x = (col + sigmoid(t_x)) / GW, y = (row + sigmoid(t_y)) / GH,
  w = anchor_w·exp(t_w) / GW, h = anchor_h·exp(t_h) / GH.
- Cap: where K < N, the K candidates of highest best-class score, ties by
  index, in that order; otherwise all N in index order.
- NMS, per frame and class: walk the candidates by descending score (ties
  by rank in the cap); a live candidate with a positive score removes every
  later one whose IoU with it is >= the threshold. IoU is
  inter / max(union, 1e-12), union = (area_i + area_j) - inter, in float32.
- Assignment, per clip and frame, on a table of S slots: detections of a
  class match live tracks of that class by descending IoU (inter /
  (union + 1e-10)) against each track's box moved by its velocity, first
  (slot, detection) in row-major order on ties, while IoU >= the gate;
  unmatched tracks age, coast along their velocity and retire after
  max_age frames; unmatched detections take free slots in ascending order
  and fresh ids; velocities follow an EMA (0.6) of the centre's motion, a
  track at rest taking the full first displacement.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

F32 = np.float32


def decode(netout: torch.Tensor, anchors, obj_threshold: float):
    """(..., GH, GW, A, 5+C) → boxes (..., N, 4) centre format, scores
    (..., N, C), N = GH·GW·A."""
    gh, gw, a = netout.shape[-4:-1]
    lead = netout.shape[:-4]
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=netout.device).reshape(a, 2)
    conf = torch.sigmoid(netout[..., 4:5])
    scores = conf * torch.softmax(netout[..., 5:], dim=-1)
    scores = torch.where(scores > obj_threshold, scores,
                         torch.zeros_like(scores))
    col = torch.arange(gw, dtype=torch.float32,
                       device=netout.device).reshape(1, gw, 1)
    row = torch.arange(gh, dtype=torch.float32,
                       device=netout.device).reshape(gh, 1, 1)
    x = (col + torch.sigmoid(netout[..., 0])) / gw
    y = (row + torch.sigmoid(netout[..., 1])) / gh
    w = anchors[:, 0] * torch.exp(netout[..., 2]) / gw
    h = anchors[:, 1] * torch.exp(netout[..., 3]) / gh
    boxes = torch.stack([x, y, w, h], dim=-1)
    return (boxes.reshape(lead + (-1, 4)),
            scores.reshape(lead + (-1, scores.shape[-1])))


def cap(boxes: np.ndarray, scores: np.ndarray, k: int):
    """(F, N, 4), (F, N, C) → the k best candidates of each frame by best
    class score, descending, ties by index."""
    order = np.argsort(-scores.max(-1), axis=1, kind='stable')[:, :k]
    return (np.take_along_axis(boxes, order[..., None], 1),
            np.take_along_axis(scores, order[..., None], 1))


def nms_iou(boxes: np.ndarray) -> np.ndarray:
    """(F, K, 4) → (F, K, K) float32 IoU, inter / max(union, 1e-12)."""
    cx, cy, w, h = (boxes[..., i] for i in range(4))

    def overlap(c, s):
        lo = c - s * F32(0.5)
        hi = c + s * F32(0.5)
        return np.maximum(np.minimum(hi[..., :, None], hi[..., None, :])
                          - np.maximum(lo[..., :, None], lo[..., None, :]),
                          F32(0))

    inter = overlap(cx, w) * overlap(cy, h)
    area = w * h
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / np.maximum(union, F32(1e-12))


def nms(boxes: np.ndarray, scores: np.ndarray, threshold: float
        ) -> np.ndarray:
    """Per-class greedy NMS: (F, K, 4), (F, K, C) → (F, K, C), the scores
    of removed candidates zeroed."""
    f, k, c = scores.shape
    over = nms_iou(boxes) >= F32(threshold)            # (F, K, K)
    out = scores.copy()
    for frame in range(f):
        for cls in range(c):
            s = scores[frame, :, cls]
            order = np.argsort(-s, kind='stable')
            rank = np.empty(k, np.int64)
            rank[order] = np.arange(k)
            alive = np.ones(k, bool)
            for r, i in enumerate(order):
                if s[i] <= 0:
                    break
                if alive[i]:
                    alive &= ~(over[frame, i] & (rank > r))
            out[frame, :, cls] = np.where(alive, s, F32(0))
    return out


def detections(netout: torch.Tensor, anchors, obj_threshold: float,
               nms_threshold: float, top_k: int):
    """netout (B, T, GH, GW, A, 5+C) → numpy (boxes (B, T, K, 4), labels
    (B, T, K), scores (B, T, K), valid (B, T, K)) after decode, the cap
    and NMS; a candidate is valid when its best class score after NMS
    exceeds obj_threshold."""
    b, t = netout.shape[:2]
    boxes, scores = decode(netout, anchors, obj_threshold)
    n, c = scores.shape[-2:]
    boxes = boxes.reshape(b * t, n, 4).cpu().numpy()
    scores = scores.reshape(b * t, n, c).cpu().numpy()
    if top_k and top_k < n:
        boxes, scores = cap(boxes, scores, top_k)
    kept = nms(boxes, scores, nms_threshold)
    k = kept.shape[1]
    labels = kept.argmax(-1)
    best = kept.max(-1)
    return (boxes.reshape(b, t, k, 4), labels.reshape(b, t, k),
            best.reshape(b, t, k), (best > F32(obj_threshold)).reshape(
                b, t, k))


def empty_tracks(slots: int) -> Dict[str, np.ndarray]:
    """One clip's track table: S slots, none in use."""
    return {'boxes': np.zeros((slots, 4), F32),
            'vel': np.zeros((slots, 2), F32),
            'labels': np.full(slots, -1, np.int32),
            'ids': np.full(slots, -1, np.int32),
            'age': np.zeros(slots, np.int32),
            'active': np.zeros(slots, bool),
            'next_id': 0}


def track_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(S, 4), (M, 4) centre format → (S, M) float32, inter / (union +
    1e-10)."""
    a, b = a[:, None, :], b[None, :, :]
    a_lo, a_hi = a[..., :2] - a[..., 2:4] / F32(2), \
        a[..., :2] + a[..., 2:4] / F32(2)
    b_lo, b_hi = b[..., :2] - b[..., 2:4] / F32(2), \
        b[..., :2] + b[..., 2:4] / F32(2)
    wh = np.maximum(np.minimum(a_hi, b_hi) - np.maximum(a_lo, b_lo), F32(0))
    inter = wh[..., 0] * wh[..., 1]
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / (union + F32(1e-10))


def assign(table: Dict[str, np.ndarray], boxes: np.ndarray,
           labels: np.ndarray, valid: np.ndarray, gate: float,
           max_age: int, smooth: float = 0.6
           ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One frame of one clip: (M, 4), (M,), (M,) → (new table, ids (M,),
    -1 where a detection is invalid or finds no free slot)."""
    s, m = table['boxes'].shape[0], boxes.shape[0]
    labels = labels.astype(np.int32)
    moved = table['boxes'].copy()
    moved[:, :2] = table['boxes'][:, :2] + table['vel']
    iou = track_iou(moved, boxes)
    ok = (table['active'][:, None] & valid[None, :]
          & (table['labels'][:, None] == labels[None, :]))
    iou = np.where(ok, iou, F32(-1))
    match = np.full(m, -1, np.int64)
    for _ in range(min(s, m)):
        flat = int(np.argmax(iou))
        i, j = divmod(flat, m)
        if not iou[i, j] >= F32(gate):
            break
        match[j] = i
        iou[i, :] = F32(-1)
        iou[:, j] = F32(-1)
    hit = np.zeros(s, bool)
    hit[match[match >= 0]] = True
    age = np.where(hit, 0, table['age'] + 1).astype(np.int32)
    active = table['active'] & (age <= max_age)
    free = np.nonzero(~active)[0]
    boxes_out = np.where((table['active'] & ~hit)[:, None], moved,
                         table['boxes'])
    vel = table['vel'].copy()
    lab = table['labels'].copy()
    ids_out = table['ids'].copy()
    ids = np.full(m, -1, np.int32)
    fresh = 0
    for j in range(m):
        if match[j] >= 0:
            slot = match[j]
            inst = boxes[j, :2] - table['boxes'][slot, :2]
            prev = table['vel'][slot]
            vel[slot] = inst if not prev.any() else (
                F32(smooth) * inst + F32(1.0 - smooth) * prev)
            ids[j] = table['ids'][slot]
        elif valid[j]:
            if fresh >= len(free):
                fresh += 1
                continue
            slot = free[fresh]
            ids[j] = table['next_id'] + fresh
            fresh += 1
            vel[slot] = 0
        else:
            continue
        boxes_out[slot] = boxes[j]
        lab[slot] = labels[j]
        ids_out[slot] = ids[j]
        age[slot] = 0
        active[slot] = True
    placed = min(fresh, len(free))
    return ({'boxes': boxes_out, 'vel': vel, 'labels': lab, 'ids': ids_out,
             'age': age, 'active': active,
             'next_id': table['next_id'] + placed}, ids)


def frame_lists(boxes, labels, scores, valid, ids, names) -> List[list]:
    """One clip's (T, K, ...) outputs → per frame the valid detections
    as (label name, score, box, track id), by descending score, ties by
    rank."""
    out = []
    for t in range(boxes.shape[0]):
        keep = np.nonzero(valid[t])[0]
        order = keep[np.argsort(-scores[t][keep], kind='stable')]
        out.append([(names[labels[t, i]] if labels[t, i] < len(names)
                     else str(labels[t, i]), float(scores[t, i]),
                     tuple(float(v) for v in boxes[t, i]), int(ids[t, i]))
                    for i in order])
    return out


def serve_clips(netout: torch.Tensor, tables: List[dict], cfg: dict,
                obj_threshold: float) -> Tuple[List[List[list]], List[dict]]:
    """The reference's serving of one call after the model: decode, the
    cap and NMS of `netout` (B, T, GH, GW, A, 5+C), then each clip's
    frames assigned in order from its track table. Per clip the frame
    lists (`frame_lists`), and the tables the call leaves."""
    boxes, labels, scores, valid = detections(
        netout, cfg['anchors'], obj_threshold, cfg['nms_threshold'],
        cfg['top_k'])
    frames, after = [], []
    for clip, table in enumerate(tables):
        ids = []
        for f in range(netout.shape[1]):
            table, got = assign(table, boxes[clip, f], labels[clip, f],
                                valid[clip, f], cfg['track_gate_iou'],
                                cfg['max_age'])
            ids.append(got)
        after.append(table)
        frames.append(frame_lists(boxes[clip], labels[clip], scores[clip],
                                  valid[clip], np.stack(ids), cfg['labels']))
    return frames, after
