"""Port parity: track-identity assignment vs the JAX ops/matching.py.

`assign_tracks` runs a seeded 10-frame sequence for two clips at once
(the port's leading B) against JAX's per-clip calls; every TrackState
field and every id must be exactly equal. The sequence fills a small
table, retires tracks by max_age, flips classes and drops detections so
tracks coast. JAX runs op by op here: under `jax.jit` XLA contracts the
velocity EMA into a fused multiply-add, and `vel` then differs from the
port (and from op-by-op JAX) in the last bit.

The window form (boxes (B, T, M, 4), one op call for T frames) equals T
per-frame calls, and both equal JAX's per-clip, per-frame calls, at B in
{1, 8} and T in {1, 4}, through a full table, retirements and a frame with
no valid detection.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.ops import matching as jm
from object_tracking_tpu_torch.ops import matching as tm
from test_torch_assign_kernel import sequence


def _sequence(rng, frames=10, objects=6, m=8):
    """Per frame: boxes (M, 4), labels (M,), valid (M,) — objects move at
    constant velocity; some frames drop them (coasting), flip their class
    (mismatch) or add clutter."""
    start = rng.uniform(0.2, 0.8, (objects, 2))
    vel = rng.uniform(-0.02, 0.02, (objects, 2))
    size = rng.uniform(0.08, 0.2, (objects, 2))
    obj_labels = rng.randint(0, 3, objects)
    seq = []
    for t in range(frames):
        boxes = np.zeros((m, 4), np.float32)
        labels = np.zeros((m,), np.int32)
        valid = np.zeros((m,), bool)
        for o in range(objects):
            boxes[o, :2] = start[o] + vel[o] * t + rng.normal(0, 0.003, 2)
            boxes[o, 2:] = size[o]
            labels[o] = obj_labels[o]
            valid[o] = rng.rand() > 0.25 and not (o == 0 and 3 <= t < 7)
            if rng.rand() < 0.1:
                labels[o] = (labels[o] + 1) % 3
        boxes[objects:] = rng.uniform(0.1, 0.9, (m - objects, 4)) * [1, 1,
                                                                     .2, .2]
        labels[objects:] = rng.randint(0, 3, m - objects)
        valid[objects:] = rng.rand(m - objects) > 0.5
        seq.append((boxes, labels, valid))
    return seq


def _to_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.mark.parametrize('max_tracks,max_age', [(4, 1), (16, 2)])
def test_assign_tracks_sequence_matches_jax(rng, max_tracks, max_age):
    seqs = [_sequence(rng), _sequence(rng)]
    tstate = tm.init_track_state(max_tracks, batch=2)
    jstates = [jm.init_track_state(max_tracks) for _ in range(2)]
    saw_full = saw_retired = saw_minus_one = saw_coast = False
    for t in range(len(seqs[0])):
        boxes = np.stack([s[t][0] for s in seqs])
        labels = np.stack([s[t][1] for s in seqs])
        valid = np.stack([s[t][2] for s in seqs])
        tstate, tids = tm.assign_tracks(
            tstate, torch.from_numpy(boxes), torch.from_numpy(labels),
            torch.from_numpy(valid), max_age=max_age)
        for b in range(2):
            prev_active = np.asarray(jstates[b].active)
            prev_ids = np.asarray(jstates[b].ids)
            jstates[b], jids = jm.assign_tracks(
                jstates[b], jnp.asarray(boxes[b]), jnp.asarray(labels[b]),
                jnp.asarray(valid[b]), max_age=max_age)
            np.testing.assert_array_equal(tids[b].numpy(), np.asarray(jids))
            got = _to_np(tstate)
            for name, ref in _to_np(jstates[b]).items():
                np.testing.assert_array_equal(got[name][b], ref,
                                              err_msg=f'{name} @ t={t}')
            active = np.asarray(jstates[b].active)
            saw_full |= bool(active.all())
            saw_coast |= bool((active & (np.asarray(jstates[b].age) > 0)
                               & (np.asarray(jstates[b].vel) != 0).any(-1)
                               ).any())
            # a retired slot goes inactive or, in a full table, is
            # refilled by a new id in the same frame
            saw_retired |= bool((prev_active & (~active | (
                np.asarray(jstates[b].ids) != prev_ids))).any())
            saw_minus_one |= bool(((np.asarray(jids) == -1)
                                   & valid[b]).any())
    assert saw_retired and saw_coast
    if max_tracks == 4:
        assert saw_full and saw_minus_one


@pytest.mark.parametrize('max_tracks,max_age', [(4, 1), (16, 2)])
@pytest.mark.parametrize('b,t', [(1, 1), (1, 4), (8, 1), (8, 4)])
def test_window_form_equals_frames_and_jax(b, t, max_tracks, max_age):
    frames, m = 8, 8
    boxes, labels, valid = (torch.from_numpy(a) for a in sequence(
        b * 10 + t, b, frames, m, objects=6, classes=3, blank=(5,)))
    window = per_frame = tm.init_track_state(max_tracks, b)
    jstates = [jm.init_track_state(max_tracks) for _ in range(b)]
    saw_full = saw_minus_one = saw_retired = False
    for w0 in range(0, frames, t):
        span = slice(w0, w0 + t)
        window, wids = tm.assign_tracks(window, boxes[:, span],
                                        labels[:, span], valid[:, span],
                                        max_age=max_age)
        assert tuple(wids.shape) == (b, t, m)
        for f in range(w0, w0 + t):
            before = per_frame.active
            per_frame, fids = tm.assign_tracks(
                per_frame, boxes[:, f], labels[:, f], valid[:, f],
                max_age=max_age)
            np.testing.assert_array_equal(wids[:, f - w0].numpy(),
                                          fids.numpy(), err_msg=f't={f}')
            if f == 5:
                assert (fids == -1).all()
            for c in range(b):
                jstates[c], jids = jm.assign_tracks(
                    jstates[c], jnp.asarray(boxes[c, f].numpy()),
                    jnp.asarray(labels[c, f].numpy()),
                    jnp.asarray(valid[c, f].numpy()), max_age=max_age)
                np.testing.assert_array_equal(fids[c].numpy(),
                                              np.asarray(jids))
            saw_full |= bool(per_frame.active.all(dim=1).any())
            saw_minus_one |= bool(((fids == -1) & valid[:, f]).any())
            saw_retired |= bool((before & ~per_frame.active).any())
        got_w, got_f = _to_np(window), _to_np(per_frame)
        for c in range(b):
            for name, ref in _to_np(jstates[c]).items():
                np.testing.assert_array_equal(got_f[name][c], ref,
                                              err_msg=f'{name} @ t={f}')
                np.testing.assert_array_equal(got_w[name][c], ref,
                                              err_msg=f'{name} @ t={f}')
    assert saw_retired
    if max_tracks == 4:
        assert saw_full and saw_minus_one


def test_greedy_match_matches_jax(rng):
    a = np.concatenate([rng.uniform(0.2, 0.8, (10, 2)),
                        rng.uniform(0.1, 0.3, (10, 2))], 1).astype(np.float32)
    b = (a[rng.permutation(10)][:7]
         + rng.normal(0, 0.02, (7, 4))).astype(np.float32)
    va, vb = rng.rand(10) > 0.2, rng.rand(7) > 0.2
    ref = jm.greedy_match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                          jnp.asarray(vb))
    out = tm.greedy_match(torch.from_numpy(a), torch.from_numpy(va),
                          torch.from_numpy(b), torch.from_numpy(vb))
    assert (np.asarray(ref) >= 0).sum() >= 3
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_hungarian_and_track_manager_match_jax(rng):
    seq = _sequence(rng, frames=8)
    jt, tt = jm.TrackManager(max_age=2), tm.TrackManager(max_age=2)
    for boxes, labels, valid in seq:
        boxes, labels = boxes[valid], labels[valid]
        assert tt.update(boxes, labels) == jt.update(boxes, labels)
    a, b = seq[0][0], seq[1][0]
    assert tm.hungarian_match(a, b, 0.3) == jm.hungarian_match(a, b, 0.3)
    assert tm.hungarian_match(a, b, 0.3, seq[0][1], seq[1][1]) == \
        jm.hungarian_match(a, b, 0.3, seq[0][1], seq[1][1])
    assert tm.hungarian_match(a[:0], b) == []
