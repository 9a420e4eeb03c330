"""Identity-assignment kernel for Hopper: launch plan and launcher.

Replaces no TPU kernel: the JAX package leaves
`object_tracking_tpu/ops/matching.py::assign_tracks` to XLA, which fuses
it under `jax.jit` inside a `lax.scan` over the frames. Run eagerly it is
~1,000 PyTorch launches a frame, so the kernel `csrc/assign_tracks.cu`
does a whole window, all T frames of all B clips, in one launch. Its
header says what bounds it on the H100 (latency: a dependent chain of T
frames, each a greedy scan) and how the design answers that (one block
per clip, the table in shared memory across the frames, a block-wide
sort of the gated pairs and a one-warp scan).

`ops/matching.py` registers the kernel as the custom op
`ott_torch::assign_tracks`, with its plain twin `assign_tracks_plain` as
the CPU implementation, and counts launches in `assign_tracks.launches`.
Here: `launch_plan`, which chooses the threads and shared memory per
(S, M) in plain Python that the CPU tests reach, and `launch`, which
allocates the outputs and launches on the current stream or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from object_tracking_tpu_torch.ops.cuda.nms import SMEM_LIMIT

# The kernel's own constants (csrc/assign_tracks.cu;
# tests/test_torch_assign_kernel.py holds these copies equal to them)
MAX_SLOTS = 1024      # kMaxSlots: track slots S a clip
MAX_DETS = 4096       # kMaxDets: detections M a frame
MAX_THREADS = 1024    # kMaxThreads
MISC = 64             # kMisc: ints of scan and frame scalars
POINTERS = 20         # kPointers: the launcher's pointer arguments
MIN_THREADS = 128
PAIRS_PER_THREAD = 16

_fn = None


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def smem_bytes(s: int, m: int, keys_in_smem: bool) -> int:
    """Shared memory of a block, as csrc/assign_tracks.cu::smem_bytes
    sizes the launch: the sort keys (8 B each, a power of two at least
    S·M, when they fit), 11 floats and 7 ints a slot, 5 floats and 4 ints
    a detection, MISC ints."""
    keys = 8 * _pow2(s * max(m, 1)) if keys_in_smem else 0
    return keys + 4 * (18 * s + 9 * m + MISC)


@functools.lru_cache(maxsize=256)
def launch_plan(s: int, m: int) -> dict:
    """Every size of one launch at S slots and M detections a frame: the
    threads of a block (a power of two from 128 to 1024, about 16 IoU pairs
    a thread), whether the sort keys live in shared memory (where all S·M
    would fit beside the table) or in a device scratch of `key_cap` keys a
    clip, and the dynamic shared memory. Raises above MAX_SLOTS or
    MAX_DETS. Cached per shape, since every launch asks for it: treat the
    dict as read-only."""
    if not 1 <= s <= MAX_SLOTS:
        raise ValueError(f'assign_tracks takes 1 to {MAX_SLOTS} track '
                         f'slots, got {s}')
    if not 0 <= m <= MAX_DETS:
        raise ValueError(f'assign_tracks takes at most {MAX_DETS} '
                         f'detections a frame, got {m}')
    threads = min(MAX_THREADS, max(MIN_THREADS,
                                   _pow2(-(-s * m // PAIRS_PER_THREAD))))
    keys_in_smem = smem_bytes(s, m, True) <= SMEM_LIMIT
    smem = smem_bytes(s, m, keys_in_smem)
    if smem > SMEM_LIMIT:
        raise ValueError(f'assign_tracks at S={s}, M={m} needs {smem} B of '
                         f'shared memory')
    return {'threads': threads, 'keys_in_smem': keys_in_smem,
            'key_cap': _pow2(s * max(m, 1)), 'smem': smem}


def _launcher():
    global _fn
    if _fn is None:
        from object_tracking_tpu_torch.ops.cuda import _build
        fn = _build.load('assign_tracks').assign_tracks_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(table: Tuple[torch.Tensor, ...], boxes: torch.Tensor,
           labels: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
           max_age: int, vel_smooth: float) -> Tuple[torch.Tensor, ...]:
    """One launch on CUDA tensors, checked by the caller: the 7 table
    tensors (TrackState's order) and the window's detections (B, T, M, ...)
    → the 7 new table tensors, det_ids (B, T, M) int32 and the matched
    detections per clip (B,) int32. Raises on a failed build or launch."""
    b, s = table[0].shape[:2]
    t, m = boxes.shape[1:3]
    plan = launch_plan(s, m)
    if boxes.data_ptr() % 16:           # the kernel reads a box as float4
        boxes = boxes.clone()
    out = tuple(torch.empty_like(x) for x in table)
    det_ids = torch.empty((b, t, m), dtype=torch.int32, device=boxes.device)
    matches = torch.empty((b,), dtype=torch.int32, device=boxes.device)
    scratch = None if plan['keys_in_smem'] else torch.empty(
        b * plan['key_cap'], dtype=torch.int64, device=boxes.device)
    ptrs = (ctypes.c_void_p * POINTERS)(
        *(x.data_ptr() for x in (*table, boxes, labels, valid, *out,
                                 det_ids, matches)),
        None if scratch is None else scratch.data_ptr())
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _launcher()(ptrs, b, s, m, t, int(max_age),
                          float(iou_threshold), float(vel_smooth),
                          float(1.0 - vel_smooth), plan['threads'],
                          int(plan['keys_in_smem']), stream)
    if err != 0:
        raise RuntimeError(f'assign_tracks kernel launch failed: '
                           f'cudaError {err}')
    return (*out, det_ids, matches)
