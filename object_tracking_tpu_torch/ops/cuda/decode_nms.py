"""Fused YOLOv2 decode + greedy NMS kernel for Hopper: wrapper, plain twin,
launch count.

Counterpart of the TPU kernel
`object_tracking_tpu/ops/pallas/decode_nms_pallas.py` (`decode_nms_fused`,
body `_kernel`): the region decode of a detector head (sigmoid, softmax,
conf × probs, threshold, the cell/anchor box build) and then the greedy
walk of `nms_scores` over the FULL lattice of N = GH·GW·A candidates, with
no top-k cap. The kernel is `csrc/decode_nms.cu`, three passes (decode,
the bitmask and the walk of `csrc/nms_common.cuh`) that count as one
launch; its header says what bounds it and how the design answers that.
`launch_plan` holds every size the launch uses.

No entry point calls it, as in the JAX package: it is a public op, the
fused form of `decode_netout` → `greedy_nms_scores(top_k=0)`. F frames
take one launch. On a CPU tensor it runs `decode_nms_fused_plain`; on a
CUDA tensor it launches the kernel (and counts the launch in
`decode_nms_fused.launches`) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from object_tracking_tpu_torch.ops.cuda.nms import (
    MAX_K, SMEM_LIMIT, greedy_walk, mask_plan, pallas_iou, walk_plan)

MAX_N = MAX_K         # candidates per frame the kernel takes
DECODE_THREADS = 256  # kDecodeThreads (csrc/decode_nms.cu)
DECODE_TILE = 64      # candidates a decode block takes

_fn = None


def decode_smem(tile: int, c: int) -> int:
    """Shared memory of a decode block, as csrc/decode_nms.cu::decode_smem
    sizes the launch; here it chooses the tile. The tile's netout rows,
    then conf, max logit and sum a candidate."""
    return 4 * (tile * (5 + c) + 3 * tile)


@functools.lru_cache(maxsize=256)
def launch_plan(frames: int, n: int, c: int) -> dict:
    """Every size of one `decode_nms_fused` launch: each pass's grid,
    block, tile and dynamic shared memory, and the bitmask scratch
    (F·N·⌈N/32⌉ words). Raises above MAX_N or where a pass would not fit.
    Cached per shape, since every launch asks for it: treat the dict as
    read-only."""
    if n > MAX_N:
        raise ValueError(f'decode_nms_fused takes at most {MAX_N} '
                         f'candidates per frame, got {n}')
    tile = DECODE_TILE
    while tile > 1 and decode_smem(tile, c) > SMEM_LIMIT:
        tile //= 2
    plan = {'decode': {'grid': (-(-n // tile), frames),
                       'threads': DECODE_THREADS, 'tile': tile,
                       'smem': decode_smem(tile, c)},
            'mask': mask_plan(frames, n),
            'walk': walk_plan(frames, n, c),
            'scratch_bytes': frames * n * (-(-n // 32)) * 4}
    for name in ('decode', 'mask', 'walk'):
        if plan[name]['smem'] > SMEM_LIMIT:
            raise ValueError(f'decode_nms_fused: the {name} pass needs '
                             f'{plan[name]["smem"]} B of shared memory')
    return plan


def _launcher():
    global _fn
    if _fn is None:
        from object_tracking_tpu_torch.ops.cuda import _build
        fn = _build.load('decode_nms').decode_nms_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_nms_fused_plain(netout: torch.Tensor, anchors: torch.Tensor,
                           obj_threshold: float = 0.5,
                           nms_threshold: float = 0.45
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in its order of operations:
    netout (F, GH, GW, A, 5+C) float32, anchors (A, 2) →
    (boxes (F, N, 4), scores (F, N, C) thresholded * alive).

    The softmax divides by a sum taken over classes in index order (not
    `torch.softmax`, which sums in another order and, on the CPU,
    multiplies by a reciprocal), and the grid sizes divide as tensors
    (PyTorch multiplies by the reciprocal of a Python scalar on CUDA).
    """
    f, gh, gw, a, d = netout.shape
    dev = netout.device
    col = torch.arange(gw, dtype=torch.float32, device=dev)[None, :, None]
    row = torch.arange(gh, dtype=torch.float32, device=dev)[:, None, None]
    gw_t = torch.tensor(float(gw), device=dev)
    gh_t = torch.tensor(float(gh), device=dev)
    x = (col + torch.sigmoid(netout[..., 0])) / gw_t
    y = (row + torch.sigmoid(netout[..., 1])) / gh_t
    w = anchors[:, 0] * torch.exp(netout[..., 2]) / gw_t
    h = anchors[:, 1] * torch.exp(netout[..., 3]) / gh_t
    boxes = torch.stack([x, y, w, h], dim=-1).reshape(f, -1, 4)

    net = netout.reshape(f, -1, d)
    conf = torch.sigmoid(net[..., 4:5])
    logits = net[..., 5:]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    total = e[..., 0]
    for j in range(1, e.shape[-1]):
        total = total + e[..., j]
    probs = conf * (e / total[..., None])
    scores = probs * (probs > obj_threshold)
    return boxes, greedy_walk(scores, pallas_iou(boxes), nms_threshold)


def decode_nms_fused(netout: torch.Tensor, anchors,
                     obj_threshold: float = 0.5,
                     nms_threshold: float = 0.45
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode + per-class greedy NMS of a YOLOv2 region head, all frames
    in one launch.

    netout ([F,] GH, GW, A, 5+C), cast to contiguous float32; anchors
    (A·2,) or (A, 2) in grid-cell units → (boxes ([F,] N, 4) center-format
    relative, scores ([F,] N, C) with suppressed scores zeroed),
    N = GH·GW·A ≤ MAX_N = 8192 on CUDA. Candidate k is (row·GW + col)·A + a.
    """
    if netout.dim() not in (4, 5):
        raise ValueError(f'netout must be ([F,] GH, GW, A, 5+C), got '
                         f'{tuple(netout.shape)}')
    if netout.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'decode_nms_fused runs on cuda or cpu, not '
                         f'{netout.device}')
    unbatched = netout.dim() == 4
    x = (netout[None] if unbatched else netout).to(torch.float32)
    x = x.contiguous()
    f, gh, gw, a, d = x.shape
    if d < 6:
        raise ValueError(f'netout needs 5 + C channels with C >= 1, '
                         f'got {d}')
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=x.device).reshape(a, 2).contiguous()
    if x.device.type == 'cpu':
        boxes, scores = decode_nms_fused_plain(x, anchors, obj_threshold,
                                               nms_threshold)
    else:
        n = gh * gw * a
        plan = launch_plan(f, n, d - 5)
        boxes = torch.empty(f, n, 4, dtype=torch.float32, device=x.device)
        scores = torch.empty(f, n, d - 5, dtype=torch.float32,
                             device=x.device)
        mask = torch.empty(plan['scratch_bytes'] // 4, dtype=torch.int32,
                           device=x.device)
        dp, mp, wp = plan['decode'], plan['mask'], plan['walk']
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _launcher()(x.data_ptr(), anchors.data_ptr(),
                              boxes.data_ptr(), scores.data_ptr(),
                              mask.data_ptr(), f, gh, gw, a, d - 5,
                              float(obj_threshold), float(nms_threshold),
                              dp['tile'], mp['rows'], wp['classes'],
                              wp['tile_rows'], int(wp['frame_mask']),
                              stream)
        if err != 0:
            raise RuntimeError(f'decode_nms_fused kernel launch failed: '
                               f'cudaError {err}')
        decode_nms_fused.launches += 1
    if unbatched:
        return boxes[0], scores[0]
    return boxes, scores


decode_nms_fused.launches = 0
