"""Greedy per-class NMS over fixed-size score tensors.

Same semantics as `object_tracking_tpu/ops/nms.py`: per class, walk the
candidates in descending score order; a zero score suppresses nothing;
otherwise zero the class score of every lower-ranked candidate with
IoU >= threshold. Scores below the objectness threshold are zeroed before
NMS, so only the K highest-max-score candidates are kept first (top_k).

Every function takes an optional leading frame dimension, (F, N, ·), so a
whole predict call (B·T frames) goes through one call — and, on the card,
one kernel launch.
"""

from __future__ import annotations

import torch

from object_tracking_tpu_torch.ops.boxes import pairwise_iou_center
from object_tracking_tpu_torch.ops.cuda.nms import greedy_walk, nms_scores

IMPLS = ('auto', 'kernel', 'op', 'sort', 'matmul')


def _nms_one_class(scores: torch.Tensor, iou: torch.Tensor,
                   nms_threshold: float) -> torch.Tensor:
    """The per-class rank walk, all frames and classes at once.

    scores (F, K, C), iou (F, K, K) → (F, K, C). Per (frame, class) the
    candidates are ranked by a STABLE descending sort (ties keep index
    order, as `jnp.argsort` does); rank position `pos` suppresses the
    lower-ranked candidates with IoU >= threshold when its candidate is
    still alive and scored. The walk ends at the first zero-score rank,
    which is the count of positive scores: one host sync, not one per rank.
    """
    f, k, c = scores.shape
    if scores.numel() == 0:
        return scores.clone()
    s = scores.transpose(1, 2)                               # (F, C, K)
    order = torch.argsort(-s, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)
    ge = iou >= nms_threshold                                # (F, K, K)
    alive = torch.ones_like(s, dtype=torch.bool)
    positions = int((s > 0).sum(dim=-1).max())
    for pos in range(positions):
        i = order[..., pos]                                  # (F, C)
        active = alive.gather(-1, i[..., None]) & (
            s.gather(-1, i[..., None]) > 0.0)                # (F, C, 1)
        rows = ge.gather(1, i[..., None].expand(f, c, k))    # (F, C, K)
        suppress = rows & (rank > pos)
        alive = torch.where(active, alive & ~suppress, alive)
    return (s * alive).transpose(1, 2)


def _top_k(boxes: torch.Tensor, scores: torch.Tensor, top_k: int):
    """Keep the top_k candidates by best class score, as `lax.top_k` does:
    descending, and on ties the lower index first (a stable sort; most
    thresholded candidates tie at 0, where `torch.topk` orders otherwise)."""
    best = scores.amax(dim=-1)                               # (F, N)
    idx = torch.argsort(-best, dim=-1, stable=True)[..., :top_k]
    boxes = boxes.gather(1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
    scores = scores.gather(1, idx[..., None].expand(-1, -1,
                                                    scores.shape[-1]))
    return boxes, scores


def greedy_nms_scores(boxes: torch.Tensor, scores: torch.Tensor,
                      nms_threshold: float = 0.45,
                      top_k: int = 128,
                      impl: str = 'auto'):
    """Per-class greedy NMS on a fixed-size candidate set.

    Args:
      boxes: ([F,] N, 4) center-format (cx, cy, w, h).
      scores: ([F,] N, C) per-class scores, already thresholded.
      nms_threshold: IoU at or above which a box suppresses lower-ranked.
      top_k: candidate cap; 0 / >= N means exact full-N NMS.
      impl: 'kernel' (the CUDA kernel, CUDA tensors only), 'op' (the
        kernel's custom op `torch.ops.ott_torch.nms_scores` on either
        device: the kernel on a CUDA tensor, its plain twin on a CPU one;
        the exported serving program uses it, so that one graph serves on
        both), 'sort' (per-class rank walk), 'matmul' (all classes per
        round by argmax), or 'auto' ('kernel' on a CUDA tensor, 'sort' on
        a CPU tensor). 'kernel' and 'op' on a CUDA tensor are the same
        call. Identical results up to the IoU formula: 'kernel' and 'op'
        use the TPU kernel's inter / max(union, 1e-12), the others
        ops/boxes.py's inter / (union + 1e-10).

    Returns:
      (kept_boxes ([F,] K, 4), kept_scores ([F,] K, C)), K = min(top_k, N).
    """
    if impl not in IMPLS:
        raise ValueError(f'impl must be one of {IMPLS}, got {impl!r}')
    unbatched = boxes.dim() == 2
    if unbatched:
        boxes, scores = boxes[None], scores[None]
    if impl == 'auto':
        impl = 'kernel' if boxes.device.type == 'cuda' else 'sort'
    if impl == 'kernel' and boxes.device.type != 'cuda':
        raise ValueError(f"impl='kernel' needs CUDA tensors, got "
                         f"{boxes.device}")
    n = boxes.shape[1]
    if top_k and top_k < n:
        boxes, scores = _top_k(boxes, scores, top_k)
    if impl in ('kernel', 'op'):
        new_scores = nms_scores(boxes.contiguous(), scores.contiguous(),
                                nms_threshold)
    else:
        iou = pairwise_iou_center(boxes, boxes)
        # 'matmul' is the JAX package's all-classes-per-round walk; the IoU
        # row of each pick is a gather here, exact on every backend (a
        # one-hot product would go through TF32 where that is enabled)
        walk = greedy_walk if impl == 'matmul' else _nms_one_class
        new_scores = walk(scores, iou, nms_threshold)
    if unbatched:
        return boxes[0], new_scores[0]
    return boxes, new_scores
