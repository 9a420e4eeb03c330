"""YOLOv2 netout decoding: grid decode → threshold → NMS, batched.

Port of `object_tracking_tpu/ops/decode.py`. Decode stays plain tensor
code (the JAX package leaves it to XLA); every function takes any leading
dims, so the B·T frames of a predict call decode in one pass and reach
NMS as one (F, N, ·) batch.

1. conf = sigmoid(netout[..., 4])
2. class scores = conf * softmax(netout[..., 5:])
3. zero class scores <= obj_threshold
4. box decode: x=(col+sigmoid(tx))/W, y=(row+sigmoid(ty))/H,
   w=anchor_w*exp(tw)/W, h=anchor_h*exp(th)/H
5. per-class greedy NMS (ops/nms.py)
6. keep boxes whose best class score > obj_threshold
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.ops.nms import greedy_nms_scores


def decode_netout(netout: torch.Tensor, anchors,
                  obj_threshold: float = 0.5):
    """Decode a raw (..., H, W, A, 5+C) netout into flat candidates.

    Returns:
      boxes: (..., H*W*A, 4) center-format, image-relative [0, 1].
      scores: (..., H*W*A, C) thresholded class scores (conf * softmax).
    """
    grid_h, grid_w, num_anchors = netout.shape[-4:-1]
    lead = netout.shape[:-4]
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=netout.device).reshape(num_anchors, 2)

    conf = torch.sigmoid(netout[..., 4:5])
    probs = conf * torch.softmax(netout[..., 5:], dim=-1)
    probs = probs * (probs > obj_threshold)

    col = torch.arange(grid_w, dtype=torch.float32,
                       device=netout.device)[None, :, None]
    row = torch.arange(grid_h, dtype=torch.float32,
                       device=netout.device)[:, None, None]
    x = (col + torch.sigmoid(netout[..., 0])) / grid_w
    y = (row + torch.sigmoid(netout[..., 1])) / grid_h
    w = anchors[:, 0] * torch.exp(netout[..., 2]) / grid_w
    h = anchors[:, 1] * torch.exp(netout[..., 3]) / grid_h

    boxes = torch.stack([x, y, w, h], dim=-1).reshape(*lead, -1, 4)
    scores = probs.reshape(*lead, -1, probs.shape[-1])
    return boxes, scores


def decode_and_nms(netout: torch.Tensor, anchors,
                   obj_threshold: float = 0.5,
                   nms_threshold: float = 0.45,
                   top_k: int = 128,
                   nms_impl: str = 'auto'):
    """Full decode+NMS. netout (..., H, W, A, 5+C) →
    (boxes (..., K, 4), labels (..., K), scores (..., K), valid (..., K)).

    A candidate survives iff its best class score after NMS exceeds
    obj_threshold. All leading dims are flattened into one frame batch for
    NMS, so the kernel launches once however many frames there are.
    """
    lead = netout.shape[:-4]
    boxes, scores = decode_netout(netout, anchors, obj_threshold)
    n, c = scores.shape[-2:]
    boxes, scores = greedy_nms_scores(boxes.reshape(-1, n, 4),
                                      scores.reshape(-1, n, c),
                                      nms_threshold, top_k, impl=nms_impl)
    k = boxes.shape[1]
    return (boxes.reshape(*lead, k, 4),
            *best_class(scores.reshape(*lead, k, c), obj_threshold))


def best_class(scores: torch.Tensor, obj_threshold: float):
    """NMS'd class scores (..., K, C) → (labels (..., K), the best class;
    best (..., K), its score; valid (..., K), best > obj_threshold)."""
    labels = scores.argmax(dim=-1)
    best = scores.amax(dim=-1)
    return labels, best, best > obj_threshold


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def boxes_to_list(boxes, labels, scores, valid, ids=None) -> List[Tuple]:
    """Host conversion of one frame's padded results (K rows) → the valid
    rows as [(label_idx, score, (cx, cy, w, h)), ...], by descending
    score, stable on ties. With `ids` (K,), each row carries its own id
    as a fourth field, through the same sort. The one place that orders
    a frame's detections."""
    boxes, labels, scores, valid = (
        _host(a) for a in (boxes, labels, scores, valid))
    rows = np.flatnonzero(valid)
    rows = rows[np.argsort(-scores[rows], kind='stable')]
    fields = [labels[rows].tolist(), scores[rows].tolist(),
              map(tuple, boxes[rows].tolist())]
    if ids is not None:
        fields.append(_host(ids)[rows].tolist())
    return list(zip(*fields))


def named_boxes(dets, names: Sequence[str]) -> List[List[Tuple]]:
    """Batched padded results (boxes (B, K, 4), labels, scores, valid
    (B, K)) → per image [(names[label], score, (cx, cy, w, h))], each
    image's rows as `boxes_to_list` orders them."""
    dets = [_host(a) for a in dets]
    return [[(names[l], s, b)
             for l, s, b in boxes_to_list(*(a[i] for a in dets))]
            for i in range(dets[0].shape[0])]
