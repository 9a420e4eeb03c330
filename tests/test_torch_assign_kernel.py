"""The identity-assignment kernel's algorithm on the CPU, and the kernel
itself on a card (`ops/cuda/csrc/assign_tracks.cu`, `ops/cuda/assign.py`,
`ops/matching.py::assign_tracks`).

The kernel replaces the greedy loop's repeated global argmax with one
sorted scan over the gated pairs; the plain twin `assign_tracks_plain`
does the same scan in PyTorch. Here the scan is held to `_greedy_pairs`
on random, tied and NaN-holding IoU matrices; the launch plan fits from
the serving shape up to the caps and raises beyond them; the custom op
`ott_torch::assign_tracks` gives tracing the right shapes, passes
`torch.library.opcheck`, and a `torch.export` of `serving.ClipProgram`
records one call of it for a whole window; and the counters read what the
window assigned. The window form's parity with the JAX package is in
`test_torch_matching.py`.

Tests marked `card` run the kernel against `assign_tracks_plain` on a
seeded 40-frame sequence, and on dense, tied frames at shapes that take
each of the kernel's sort branches (keys in shared memory or in a device
scratch; rank sort or bitonic network), up to the caps; they skip
without a CUDA card. This file
imports no JAX, so on the card's machine it runs alone:

    python -m pytest --noconftest -q tests/test_torch_assign_kernel.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from object_tracking_tpu_torch.ops import matching as tm
from object_tracking_tpu_torch.ops.boxes import pairwise_iou_center
from object_tracking_tpu_torch.ops.cuda import assign as cuda_assign
from object_tracking_tpu_torch.ops.cuda.nms import SMEM_LIMIT
from object_tracking_tpu_torch.serving import (_batched_track_state,
                                               make_clip_program)
from object_tracking_tpu_torch.utils.profiling import Recorder, recording

CSRC = Path(tm.__file__).resolve().parent / 'cuda' / 'csrc'


def sequence(seed, b, frames, m, objects, classes=12, blank=()):
    """B clips of `frames` frames, M detection rows each: `objects` boxes
    moving at constant velocity with noise, each dropping out at random
    (its track coasts) and now and then flipping class, clutter in the
    other rows, rows shuffled per frame, and no valid row in the frames
    listed in `blank`. → numpy boxes (B, F, M, 4) float32, labels
    (B, F, M) int32, valid (B, F, M) bool."""
    rng = np.random.RandomState(seed)
    start = rng.uniform(0.1, 0.9, (b, 1, objects, 2))
    vel = rng.uniform(-0.02, 0.02, (b, 1, objects, 2))
    size = rng.uniform(0.05, 0.2, (b, 1, objects, 2))
    cls = rng.randint(0, classes, (b, 1, objects))
    boxes = rng.uniform(0.05, 0.95, (b, frames, m, 4)) * [1, 1, .2, .2]
    labels = rng.randint(0, classes, (b, frames, m))
    valid = rng.rand(b, frames, m) > 0.5
    t = np.arange(frames)[None, :, None, None]
    boxes[:, :, :objects, :2] = (start + vel * t + rng.normal(
        0, 0.003, (b, frames, objects, 2)))
    boxes[:, :, :objects, 2:] = size
    flip = rng.rand(b, frames, objects) < 0.05
    labels[:, :, :objects] = np.where(flip, (cls + 1) % classes, cls)
    valid[:, :, :objects] = rng.rand(b, frames, objects) > 0.2
    valid[:, list(blank)] = False
    order = np.argsort(rng.rand(b, frames, m), axis=-1)
    return (np.take_along_axis(boxes, order[..., None], 2).astype(np.float32),
            np.take_along_axis(labels, order, 2).astype(np.int32),
            np.take_along_axis(valid, order, 2))


def clustered(seed, b, frames, m, objects, classes):
    """B clips of `frames` frames whose M detection rows are all valid
    copies of `objects` boxes, each coordinate nudged by one 1/256 step or
    none. The boxes sit on a 1/256 grid, so many pairs tie in IoU, and a
    track overlaps every copy of its object, so the gated pairs are dense.
    The objects drift by whole grid steps; object k has class
    k % classes. → numpy boxes, labels, valid as `sequence`."""
    rng = np.random.RandomState(seed)
    grid = 1 / 256
    centre = rng.randint(64, 192, (b, 1, objects, 2)) * grid
    size = rng.randint(24, 48, (b, 1, objects, 2)) * grid
    drift = rng.randint(-2, 3, (b, 1, objects, 2)) * grid
    t = np.arange(frames)[None, :, None, None]
    k = rng.randint(0, objects, (b, frames, m))
    clip, frame = np.arange(b)[:, None, None], np.arange(frames)[None, :, None]
    at = (centre + drift * t)[clip, frame, k]
    wh = np.broadcast_to(size, (b, frames, objects, 2))[clip, frame, k]
    boxes = np.concatenate([at, wh], -1) + rng.randint(
        -1, 2, (b, frames, m, 4)) * grid
    return (boxes.astype(np.float32), (k % classes).astype(np.int32),
            np.ones((b, frames, m), bool))


def masked_iou(rng, kind, b=4, s=16, m=24):
    """(B, S, M) IoU matrices as `_assign_frame` hands them to the
    matcher: values in [0, 1], masked pairs at -1; 'tied' draws from five
    values (the gates among them), 'nan' plants a NaN in clip 1."""
    if kind == 'tied':
        iou = rng.choice([0.2, 0.3, 0.5, 0.7, 1.0], (b, s, m))
    else:
        iou = rng.beta(0.5, 1.0, (b, s, m))
    iou = np.where(rng.rand(b, s, m) < 0.3, -1.0, iou).astype(np.float32)
    if kind == 'nan':
        iou[1, 3, 5] = np.nan
    return torch.from_numpy(iou)


@pytest.mark.parametrize('gate', [0.3, 0.5, 1.0])
@pytest.mark.parametrize('kind', ['random', 'tied', 'nan'])
def test_sorted_scan_equals_greedy_pairs(gate, kind):
    rng = np.random.RandomState(7)
    for _ in range(5):
        iou = masked_iou(rng, kind)
        want = tm._greedy_pairs(iou, gate, min(iou.shape[1:]))
        got = tm._sorted_scan_pairs(iou, gate)
        assert torch.equal(got, want)
        if kind == 'nan':
            assert (got[1] == -1).all()
    # a random draw never reaches IoU 1.0; the tied draws hold it
    assert (want >= 0).sum() > 0 or (gate == 1.0 and kind != 'tied')


def test_gate_outside_zero_one_raises():
    state = tm.init_track_state(4, 1)
    boxes = torch.zeros(1, 2, 4)
    flags = torch.zeros(1, 2, dtype=torch.bool)
    for gate in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match=r'gate in \(0, 1\]'):
            tm.assign_tracks(state, boxes, flags.int(), flags,
                             iou_threshold=gate)


# test shapes of this file and test_torch_matching.py, the serving shape,
# the caps
@pytest.mark.parametrize('s,m', [(4, 8), (16, 8), (16, 24), (64, 128),
                                 (64, 1), (1, 4096), (1024, 4096)])
def test_launch_plan_fits(s, m):
    plan = cuda_assign.launch_plan(s, m)
    t = plan['threads']
    assert 128 <= t <= 1024 and t & (t - 1) == 0
    assert plan['smem'] <= SMEM_LIMIT
    assert plan['smem'] == cuda_assign.smem_bytes(s, m, plan['keys_in_smem'])
    assert plan['key_cap'] >= s * m and plan['key_cap'] & (
        plan['key_cap'] - 1) == 0
    if (s, m) == (64, 128):
        assert plan['keys_in_smem'] and t == 512
    if (s, m) == (1024, 4096):
        assert not plan['keys_in_smem'] and t == 1024


@pytest.mark.parametrize('s,m', [(1025, 8), (64, 4097), (0, 8)])
def test_launch_plan_raises_beyond_the_caps(s, m):
    with pytest.raises(ValueError, match='assign_tracks takes'):
        cuda_assign.launch_plan(s, m)


def test_launch_plan_is_cached_per_shape():
    assert cuda_assign.launch_plan(64, 128) is cuda_assign.launch_plan(64, 128)


def test_python_constants_equal_the_kernels():
    text = (CSRC / 'assign_tracks.cu').read_text()
    got = {k: int(v) for k, v in re.findall(
        r'constexpr (?:int|size_t) (k\w+) = (\d+);', text)}
    assert got['kMaxSlots'] == cuda_assign.MAX_SLOTS
    assert got['kMaxDets'] == cuda_assign.MAX_DETS
    assert got['kMaxThreads'] == cuda_assign.MAX_THREADS
    assert got['kMaxSmem'] == SMEM_LIMIT
    assert got['kMisc'] == cuda_assign.MISC
    assert got['kPointers'] == cuda_assign.POINTERS
    # the layout the launcher sizes: 18 words a slot, 9 a detection
    assert '4 * (18 * (size_t)S + 9 * (size_t)M + kMisc)' in text


def op_args(b=2, t=3, s=8, m=6, seed=0):
    boxes, labels, valid = sequence(seed, b, t, m, objects=4, classes=3)
    return (*tm.init_track_state(s, b), torch.from_numpy(boxes),
            torch.from_numpy(labels), torch.from_numpy(valid), 0.3, 3, 0.6)


def test_fake_gives_the_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    args = op_args()
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        out = torch.ops.ott_torch.assign_tracks(*fake)
    real = torch.ops.ott_torch.assign_tracks(*args)
    assert len(out) == len(real) == 9
    for f, r in zip(out, real):
        assert f.shape == r.shape and f.dtype == r.dtype
    assert tuple(out[7].shape) == (2, 3, 6) and tuple(out[8].shape) == (2,)


def test_op_passes_opcheck():
    torch.library.opcheck(torch.ops.ott_torch.assign_tracks.default,
                          op_args())


class NetoutStub(nn.Module):
    """Stands in for MultiObjDetTracker in a ClipProgram: a (B, T, 2, 2,
    2, 8) netout from the frames' means, the state carried through."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(4.0))

    def forward(self, images, train, initial_state, return_state):
        b, t = images.shape[:2]
        x = images.mean(dim=-1)[:, :, :2, :2, None, None] * self.scale
        netout = x.expand(b, t, 2, 2, 2, 8) - torch.arange(8.0) / 4
        c, h = initial_state
        return {'track': netout, 'state': (c + 0.0, h + 0.0)}


def test_export_of_clip_program_records_one_assign_node():
    program = make_clip_program(NetoutStub(), np.ones((2, 2), np.float32),
                                obj_threshold=0.1)
    b, t = 2, 4
    frames = torch.randint(0, 256, (b, t, 64, 64, 3), dtype=torch.uint8)
    state = (torch.zeros(b, 2, 2, 8), torch.zeros(b, 2, 2, 8))
    tracks = _batched_track_state(b, 8, 'cpu')
    with torch.no_grad():
        exported = torch.export.export(program, (frames, state, tracks))
    targets = [n.target for n in exported.graph.nodes]
    assert targets.count(torch.ops.ott_torch.assign_tracks.default) == 1
    out = exported.module()(frames, state, tracks)
    want = program(frames, state, tracks)
    assert tuple(out[1].shape) == (b, t, 8)      # K = the 2x2x2 lattice
    assert torch.equal(out[1], want[1]) and (out[1] >= 0).any()
    for got, ref in zip(out[3], want[3]):
        assert torch.equal(got, ref)


def test_counters_on_the_cpu():
    """B·T frames, none by the kernel; B·T·min(S, M) steps; the matches
    are the valid detections that kept an id their clip had before."""
    b, t, s, m = 2, 6, 8, 6
    boxes, labels, valid = sequence(3, b, t, m, objects=4, classes=2)
    state, recorder = tm.init_track_state(s, b), Recorder()
    with recording(recorder):
        state, ids = tm.assign_tracks(state, torch.from_numpy(boxes),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(valid))
    counters = recorder.reading()['counters']
    seen, matched = [set() for _ in range(b)], 0
    for c in range(b):
        for f in range(t):
            frame = ids[c, f].tolist()
            matched += sum(i in seen[c] for i in frame)
            seen[c].update(i for i in frame if i >= 0)
    assert counters['assign.frames'] == b * t
    assert counters['assign.kernel_frames'] == 0
    assert counters['assign.steps'] == b * t * min(s, m)
    assert counters['assign.matches'] == matched > 0


# ----------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the assignment kernel has no '
                    'interpret mode')
    return torch.device('cuda', 0)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def gated_pairs(state, boxes, labels, valid, gate=0.3) -> int:
    """The most pairs at or above the gate in one clip's frame: the keys
    the kernel sorts there (no IoU in these frames is NaN)."""
    pred = torch.cat([state.boxes[..., :2] + state.vel,
                      state.boxes[..., 2:]], dim=-1)
    iou = pairwise_iou_center(pred, boxes)
    ok = (state.active[:, :, None] & valid[:, None, :]
          & (state.labels[:, :, None] == labels[:, None, :]))
    return int(((iou >= gate) & ok).flatten(1).sum(dim=1).max())


def kernel_against_plain(card, s, t, boxes, labels, valid):
    """The kernel over windows of T frames against the plain twin frame by
    frame, both from an empty table: ids, every integer field and the
    float fields bit for bit after each window; one launch a window.
    → what the frames exercised: the table full, a valid detection left
    without an id, a track retired, the most gated pairs in a frame."""
    b, frames = boxes.shape[:2]
    boxes, labels, valid = (torch.from_numpy(a).to(card)
                            for a in (boxes, labels, valid))
    kernel = tm.init_track_state(s, b, card)
    plain = tm.init_track_state(s, b, card)
    launches = tm.assign_tracks.launches
    seen = dict(full=False, minus_one=False, retired=False, gated=0)
    for w0 in range(0, frames, t):
        window = slice(w0, w0 + t)
        before = kernel
        kernel, kids = tm.assign_tracks(kernel, boxes[:, window],
                                        labels[:, window], valid[:, window])
        pids = []
        for f in range(w0, min(w0 + t, frames)):
            seen['gated'] = max(seen['gated'], gated_pairs(
                plain, boxes[:, f], labels[:, f], valid[:, f]))
            plain, ids, _ = tm.assign_tracks_plain(
                plain, boxes[:, f:f + 1], labels[:, f:f + 1],
                valid[:, f:f + 1])
            pids.append(ids)
        torch.cuda.synchronize()
        assert torch.equal(kids, torch.cat(pids, dim=1)), \
            f'ids @ window {w0 // t}'
        for name, x, y in zip(tm.TrackState._fields, kernel, plain):
            assert same_bits(x, y), f'{name} @ window {w0 // t}'
        seen['full'] |= bool(kernel.active.all())
        seen['minus_one'] |= bool(((kids == -1) & valid[:, window]).any())
        seen['retired'] |= bool((before.active & (
            (kernel.ids != before.ids) | ~kernel.active)).any())
    assert tm.assign_tracks.launches - launches == -(-frames // t)
    return seen


@pytest.mark.card
@pytest.mark.parametrize('b', [8, 1])
def test_kernel_equals_plain_on_card(card, b):
    """40 frames at S=64, M=128 in windows of T=4: ids, every integer
    field and the float fields bit for bit; the table fills (excess
    detections get -1), and frames 17 to 20 hold no valid detection, so
    every track retires; one launch a window."""
    seen = kernel_against_plain(card, 64, 4, *sequence(
        11 + b, b, 40, 128, objects=90, blank=range(17, 21)))
    assert seen['full'] and seen['minus_one'] and seen['retired']


# (S, M, B, frames, clustered objects and classes, or None for `sequence`,
# keys in shared memory, bitonic sort): the serving shape with dense
# frames, M=512 (past the S·M that shared memory holds) sparse and dense,
# and the caps
BRANCHES = {
    'smem-bitonic': (64, 128, 2, 8, (2, 1), True, True),
    'scratch-rank': (64, 512, 2, 8, None, False, False),
    'scratch-bitonic': (64, 512, 2, 8, (4, 1), False, True),
    'caps-bitonic': (1024, 4096, 1, 3, (256, 16), False, True),
}


@pytest.mark.card
@pytest.mark.parametrize('branch', list(BRANCHES))
def test_kernel_equals_plain_in_each_sort_branch(card, branch):
    """Bit for bit against the plain twin where the sort keys live in
    shared memory or in the device scratch, and where a frame's gated
    pairs take the rank sort (at most 4 a thread) or the bitonic network
    (more); the dense frames tie many IoUs, so the flat index breaks the
    ties there."""
    s, m, b, frames, dense, in_smem, bitonic = BRANCHES[branch]
    plan = cuda_assign.launch_plan(s, m)
    assert plan['keys_in_smem'] == in_smem
    data = (clustered(17, b, frames, m, *dense) if dense else
            sequence(17, b, frames, m, objects=90, classes=12))
    seen = kernel_against_plain(card, s, 4, *data)
    assert (seen['gated'] > 4 * plan['threads']) == bitonic
    assert seen['gated'] > 0 and seen['minus_one']
