"""Batched greedy-NMS kernel for Hopper: wrapper, plain twin, launch count.

Counterpart of the TPU kernel `object_tracking_tpu/ops/pallas/nms_pallas.py`
(`nms_scores_pallas`, body `_nms_kernel`). The kernel is
`csrc/nms_scores.cu`; its header says what bounds it on the H100 (the
latency of the dependent walk, not bytes or operations) and how the design
answers that (one block per frame, the IoU >= threshold relation as a
shared-memory bitmask, one warp per class).

`nms_scores` takes F frames at once, so a predict call makes ONE launch
for all of its B·T frames. On a CPU tensor it runs `nms_scores_plain`, the
same walk in PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

MAX_K = 1024    # candidates per frame the kernel takes (32 words of 32)

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from object_tracking_tpu_torch.ops.cuda import _build
        fn = _build.load('nms_scores').nms_scores_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pallas_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(F, K, 4) center-format → (F, K, K) IoU, in the TPU kernel's formula:
    inter / max(union, 1e-12) with union = (area_i + area_j) - inter."""
    cx, cy, w, h = boxes.unbind(-1)

    def overlap(center, size):
        lo = center - size * 0.5
        hi = center + size * 0.5
        return torch.clamp_min(
            torch.minimum(hi[..., :, None], hi[..., None, :])
            - torch.maximum(lo[..., :, None], lo[..., None, :]), 0.0)

    inter = overlap(cx, w) * overlap(cy, h)
    area = w * h
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def greedy_walk(scores: torch.Tensor, iou: torch.Tensor,
                nms_threshold: float) -> torch.Tensor:
    """The TPU kernel's walk on (F, K, C) scores and an (F, K, K) IoU.

    Each round, every class picks its best live, not-done candidate
    (argmax, first index on ties), marks it done, and kills the not-done
    candidates whose IoU with it is >= threshold; a class with no positive
    candidate left is a no-op. Each productive round settles one
    positive-score box of its class, so the walk runs as many rounds as the
    most populated (frame, class) has positive scores: one host sync to
    count them, instead of one per round.
    """
    f, k, c = scores.shape
    if scores.numel() == 0:
        return scores.clone()
    rounds = int((scores > 0).sum(dim=1).max())
    ge = iou >= nms_threshold                               # (F, K, K)
    alive = torch.ones_like(scores, dtype=torch.bool)
    done = torch.zeros_like(alive)
    rows = torch.arange(k, device=scores.device)[None, :, None]
    for _ in range(rounds):
        cand = torch.where(alive & ~done, scores, 0.0)
        best = cand.argmax(dim=1)                           # (F, C)
        active = (cand.amax(dim=1) > 0.0)[:, None, :]       # (F, 1, C)
        onehot = rows == best[:, None, :]                   # (F, K, C)
        sel = ge.gather(1, best[:, :, None].expand(f, c, k))  # (F, C, K)
        suppress = sel.transpose(1, 2) & ~done & ~onehot
        alive = alive & ~(suppress & active)
        done = done | (onehot & active)
    return scores * alive


def nms_scores_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     nms_threshold: float = 0.45) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (F, K, 4), (F, K, C) →
    (F, K, C) scores * alive."""
    return greedy_walk(scores, pallas_iou(boxes), nms_threshold)


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f'boxes must be (F, K, 4), got {tuple(boxes.shape)}')
    if scores.dim() != 3 or scores.shape[:2] != boxes.shape[:2]:
        raise ValueError(f'scores must be (F, K, C) with boxes (F, K, 4), '
                         f'got {tuple(scores.shape)} and '
                         f'{tuple(boxes.shape)}')
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f'nms_scores takes float32, got {boxes.dtype} and '
                        f'{scores.dtype}')
    if boxes.device != scores.device:
        raise ValueError(f'boxes on {boxes.device}, scores on '
                         f'{scores.device}')
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError('nms_scores takes contiguous tensors')


def nms_scores(boxes: torch.Tensor, scores: torch.Tensor,
               nms_threshold: float = 0.45) -> torch.Tensor:
    """Per-class greedy NMS for F frames in one launch.

    boxes (F, K, 4) center-format, scores (F, K, C) thresholded, both
    float32 and contiguous → (F, K, C) with suppressed scores zeroed.
    CPU tensors run `nms_scores_plain`; CUDA tensors launch the kernel
    (and count the launch in `nms_scores.launches`) or raise.
    """
    _check(boxes, scores)
    if boxes.device.type == 'cpu':
        return nms_scores_plain(boxes, scores, nms_threshold)
    if boxes.device.type != 'cuda':
        raise ValueError(f'nms_scores runs on cuda or cpu, not '
                         f'{boxes.device}')
    f, k, c = scores.shape
    if k > MAX_K:
        raise ValueError(f'nms_scores takes at most {MAX_K} candidates per '
                         f'frame, got {k}')
    out = torch.empty_like(scores)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _launcher()(boxes.data_ptr(), scores.data_ptr(),
                          out.data_ptr(), f, k, c, float(nms_threshold),
                          stream)
    if err != 0:
        raise RuntimeError(f'nms_scores kernel launch failed: '
                           f'cudaError {err}')
    nms_scores.launches += 1
    return out


nms_scores.launches = 0
