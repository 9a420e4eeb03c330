"""Batched greedy-NMS kernel for Hopper: wrapper, launch plan, plain twin,
launch count.

Counterpart of the TPU kernel `object_tracking_tpu/ops/pallas/nms_pallas.py`
(`nms_scores_pallas`, body `_nms_kernel`). The kernel is
`csrc/nms_scores.cu` on the design of `csrc/nms_common.cuh`; their notes
say what bounds it on the H100 (the latency of each (frame, class) walk,
not bytes or operations) and how the design answers that: a mask pass
writes the IoU >= threshold relation as a bitmask over a grid that fills
the card, and a walk pass runs one warp per (frame, class) as a sorted
scan.

`nms_scores` takes F frames at once, so a predict call makes ONE launch
(two kernel passes) for all of its B·T frames. It goes through the custom
op `torch.ops.ott_torch.nms_scores` (`nms_scores_op`), which a traced
program records as one call: on a CPU tensor it runs `nms_scores_plain`,
the same walk in PyTorch; on a CUDA tensor it launches the kernel or
raises. `launch_plan` chooses every size the launch uses, in
plain Python that the CPU tests reach; the launcher derives each pass's
shared memory from the plan's choices and refuses a plan that does not
fit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# The kernels' own constants (csrc/nms_common.cuh; tests/test_torch_nms_scan.py
# holds these copies equal to them)
MAX_K = 8192          # kMaxN: candidates per frame the kernels take
SMEM_LIMIT = 232448   # kMaxSmem: shared memory a block may opt into (227 KB)
MASK_THREADS = 256    # kMaskThreads: mask pass, 8 warps a block
MAX_WALK_CLASSES = 8  # kMaxWalkWarps: walk pass, a warp per class, 8 a block
BATCH = 16            # kBatch: loads in flight per thread
SMS = 132             # streaming multiprocessors of an H100 SXM

_fn = None


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def mask_plan(frames: int, n: int) -> dict:
    """The mask pass: blocks of `rows` rows of one frame's bitmask, 32, 16
    or 8 rows, the most that still gives two blocks per SM; the frame's
    box corners in shared memory (5 floats a candidate)."""
    rows = 32
    while rows > 8 and frames * _ceil(n, rows) < 2 * SMS:
        rows //= 2
    return {'grid': (_ceil(n, rows), frames), 'threads': MASK_THREADS,
            'rows': rows, 'smem': 5 * n * 4}


def walk_smem(n: int, classes: int, tile_rows: int,
              frame_mask: bool) -> int:
    """Shared memory of a walk block, as csrc/nms_common.cuh::walk_smem
    sizes the launch; here it chooses the plan. Per warp, the sort keys
    (8 B a candidate, padded to a power of two),
    32 staged mask rows, `removed`, `kept` and the 32 staged rows'
    indices; the score tile, with an odd row stride; and with
    `frame_mask`, the frame's whole bitmask."""
    words = _ceil(n, 32)
    return (8 * classes * _pow2(n) + 4 * classes * (34 * words + 32)
            + 4 * tile_rows * (classes | 1)
            + (4 * n * words if frame_mask else 0))


def walk_plan(frames: int, n: int, c: int) -> dict:
    """The walk pass: one warp per (frame, class), `classes` warps a block.
    Fewer classes a block while the blocks do not fill the SMs or the
    block does not fit in shared memory; then the tallest score tile that
    fits, at most 1024 rows. Where the frame's whole bitmask is one load
    a thread (K = 128: 512 words), the block copies it into shared memory
    with its scores (`frame_mask`), so the scan never waits on device
    memory; a larger mask is staged 32 rows at a time."""
    classes = max(1, min(MAX_WALK_CLASSES, c))
    while classes > 1 and (frames * _ceil(c, classes) < SMS
                           or walk_smem(n, classes, 32, False)
                           > SMEM_LIMIT):
        classes -= 1
    frame_mask = n * _ceil(n, 32) <= BATCH * 32 * classes
    tile_rows = min(_ceil(n, 32) * 32, 1024)
    while tile_rows > 32 and walk_smem(n, classes, tile_rows,
                                       frame_mask) > SMEM_LIMIT:
        tile_rows -= 32
    return {'grid': (frames * _ceil(c, classes),),
            'threads': 32 * classes, 'classes': classes,
            'tile_rows': tile_rows, 'frame_mask': frame_mask,
            'smem': walk_smem(n, classes, tile_rows, frame_mask)}


@functools.lru_cache(maxsize=256)
def launch_plan(frames: int, k: int, c: int) -> dict:
    """Every size of one `nms_scores` launch: each pass's grid, block,
    tile and dynamic shared memory, and the bitmask scratch (F·K·⌈K/32⌉
    words). Raises above MAX_K or where a pass would not fit. Cached per
    shape, since every launch asks for it: treat the dict as read-only."""
    if k > MAX_K:
        raise ValueError(f'nms_scores takes at most {MAX_K} candidates per '
                         f'frame, got {k}')
    plan = {'mask': mask_plan(frames, k),
            'walk': walk_plan(frames, k, c),
            'scratch_bytes': frames * k * _ceil(k, 32) * 4}
    for name in ('mask', 'walk'):
        if plan[name]['smem'] > SMEM_LIMIT:
            raise ValueError(f'nms_scores: the {name} pass needs '
                             f'{plan[name]["smem"]} B of shared memory')
    return plan


def _launcher():
    global _fn
    if _fn is None:
        from object_tracking_tpu_torch.ops.cuda import _build
        fn = _build.load('nms_scores').nms_scores_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
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


def _launch(boxes: torch.Tensor, scores: torch.Tensor,
            nms_threshold: float) -> torch.Tensor:
    """One launch of the kernel's two passes on CUDA tensors, counted in
    `nms_scores.launches`; raises on a failed build or launch."""
    f, k, c = scores.shape
    plan = launch_plan(f, k, c)
    out = torch.empty_like(scores)
    mask = torch.empty(plan['scratch_bytes'] // 4, dtype=torch.int32,
                       device=boxes.device)
    mp, wp = plan['mask'], plan['walk']
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _launcher()(boxes.data_ptr(), scores.data_ptr(),
                          out.data_ptr(), mask.data_ptr(), f, k, c,
                          float(nms_threshold), mp['rows'],
                          wp['classes'], wp['tile_rows'],
                          int(wp['frame_mask']), stream)
    if err != 0:
        raise RuntimeError(f'nms_scores kernel launch failed: '
                           f'cudaError {err}')
    nms_scores.launches += 1
    return out


# The kernel as the custom op `ott_torch::nms_scores`, so that a traced
# program (torch.export, `serving.py`) records one call of it: the CUDA
# implementation launches the kernel, the CPU one runs the plain twin, and
# the fake one gives tracing the output's shape. Registering builds
# nothing; the kernel builds at its first launch.
@torch.library.custom_op('ott_torch::nms_scores', mutates_args=(),
                         device_types='cuda')
def nms_scores_op(boxes: torch.Tensor, scores: torch.Tensor,
                  nms_threshold: float) -> torch.Tensor:
    _check(boxes, scores)
    return _launch(boxes, scores, nms_threshold)


@nms_scores_op.register_kernel('cpu')
def _nms_scores_cpu(boxes: torch.Tensor, scores: torch.Tensor,
                    nms_threshold: float) -> torch.Tensor:
    _check(boxes, scores)
    return nms_scores_plain(boxes, scores, nms_threshold)


@nms_scores_op.register_fake
def _nms_scores_fake(boxes: torch.Tensor, scores: torch.Tensor,
                     nms_threshold: float) -> torch.Tensor:
    _check(boxes, scores)
    return torch.empty_like(scores)


def nms_scores(boxes: torch.Tensor, scores: torch.Tensor,
               nms_threshold: float = 0.45) -> torch.Tensor:
    """Per-class greedy NMS for F frames in one launch.

    boxes (F, K, 4) center-format, scores (F, K, C) thresholded, both
    float32 and contiguous → (F, K, C) with suppressed scores zeroed.
    Calls the custom op `torch.ops.ott_torch.nms_scores`: CPU tensors run
    `nms_scores_plain`; CUDA tensors launch the kernel's two passes (and
    count one launch in `nms_scores.launches`) or raise; K ≤ MAX_K on
    CUDA.
    """
    if boxes.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'nms_scores runs on cuda or cpu, not '
                         f'{boxes.device}')
    return torch.ops.ott_torch.nms_scores(boxes, scores,
                                          float(nms_threshold))


nms_scores.launches = 0
