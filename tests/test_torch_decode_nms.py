"""Port parity: the fused decode+NMS kernel's plain twin vs JAX.

`decode_nms_fused` on a CPU tensor runs its plain twin,
`decode_nms_fused_plain`, in place of the CUDA kernel. It takes the same
seeded netouts as the JAX `decode_nms_fused` (the Pallas kernel in
interpret mode) and the port's staged path, `decode_netout` →
`greedy_nms_scores(top_k=0, impl='sort')`. Tolerance: atol 1e-5 on boxes
and scores (sigmoid, exp and the softmax round differently in the two
frameworks and in the two formulations) and identical kept sets, the
nonzero pattern of the scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.ops.pallas import decode_nms_fused as jax_fused
from object_tracking_tpu_torch.config import YOLOV2_ANCHORS
from object_tracking_tpu_torch.ops.cuda import decode_nms as cuda_dn
from object_tracking_tpu_torch.ops.decode import decode_netout
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores

TOL = dict(atol=1e-5, rtol=0)
SMALL_ANCHORS = np.array([0.8, 0.8, 1.5, 1.5, 2.5, 2.0], np.float32)
YOLO_ANCHORS = np.array(YOLOV2_ANCHORS, np.float32)
# name → (grid, anchors, classes, conf shift, class-0 shift, live at least)
HEADS = {
    '4x4x3x9': (4, SMALL_ANCHORS, 4, 1.5, 0.0, 4),
    '13x13x5x25': (13, YOLO_ANCHORS, 20, 3.0, 3.0, 200),
    '13x13x5x85': (13, YOLO_ANCHORS, 80, 4.0, 6.0, 200),
    # 608² input: N = 1805, above the 1024 candidates the kernel once took
    '19x19x5x25': (19, YOLO_ANCHORS, 20, 3.0, 3.0, 400),
}


def _netout(rng, name, frames=None):
    grid, anchors, classes, conf, boost, _ = HEADS[name]
    lead = () if frames is None else (frames,)
    net = rng.randn(*lead, grid, grid, len(anchors) // 2,
                    5 + classes).astype(np.float32)
    net[..., 4] += conf                  # raise conf: candidates survive
    net[..., 2:4] += 1.0                 # wider boxes: more suppression
    # one dominant class per candidate, spread over the classes: the
    # walk's rounds (the most kept boxes of one class) stay few, which
    # keeps the Pallas interpreter fast
    top = rng.randint(0, classes, net.shape[:-1])
    np.put_along_axis(net[..., 5:], top[..., None],
                      np.take_along_axis(net[..., 5:], top[..., None], -1)
                      + boost, -1)
    return net, anchors


def _twin(net, anchors, obj=0.5):
    boxes, scores = cuda_dn.decode_nms_fused(torch.from_numpy(net), anchors,
                                             obj)
    return boxes.numpy(), scores.numpy()


def _close(boxes, scores, ref_boxes, ref_scores):
    np.testing.assert_allclose(boxes, ref_boxes, **TOL)
    np.testing.assert_allclose(scores, ref_scores, **TOL)
    np.testing.assert_array_equal(scores > 0, ref_scores > 0)


@pytest.mark.parametrize('name', HEADS)
def test_twin_matches_pallas_interpret(rng, name):
    net, anchors = _netout(rng, name)
    jb, js = (np.asarray(a) for a in jax_fused(jnp.asarray(net), anchors,
                                                interpret=True))
    boxes, scores = _twin(net, anchors)
    live = int((decode_netout(torch.from_numpy(net), anchors,
                              0.5)[1] > 0).sum())
    assert live >= HEADS[name][-1]
    if name != '4x4x3x9':
        assert (js > 0).sum() < live                 # NMS suppressed some
    assert boxes.shape == (net[..., 0].size, 4)
    _close(boxes, scores, jb, js)


@pytest.mark.parametrize('name', HEADS)
def test_twin_matches_staged_port_path(rng, name):
    net, anchors = _netout(rng, name)
    b, s = decode_netout(torch.from_numpy(net), anchors, 0.5)
    ref_boxes, ref_scores = greedy_nms_scores(b, s, 0.45, top_k=0,
                                              impl='sort')
    _close(*_twin(net, anchors), ref_boxes.numpy(), ref_scores.numpy())


def test_frames_in_one_call_equal_single_calls(rng):
    net, anchors = _netout(rng, '13x13x5x25', frames=3)
    boxes, scores = _twin(net, anchors)
    assert boxes.shape == (3, 845, 4) and scores.shape == (3, 845, 20)
    for f in range(3):
        fb, fs = _twin(net[f], anchors)
        np.testing.assert_array_equal(boxes[f], fb)
        np.testing.assert_array_equal(scores[f], fs)
        jb, js = (np.asarray(a) for a in jax_fused(jnp.asarray(net[f]),
                                                    anchors, interpret=True))
        _close(boxes[f], scores[f], jb, js)


def test_all_dead_frame_gives_zero_scores(rng):
    net, anchors = _netout(rng, '13x13x5x25', frames=2)
    net[1, ..., 4] = -30.0                     # conf ~ 1e-13: nothing lives
    boxes, scores = _twin(net, anchors)
    assert (scores[1] == 0).all() and (scores[0] > 0).any()
    assert np.isfinite(boxes).all()
    _, js = jax_fused(jnp.asarray(net[1]), anchors, interpret=True)
    assert (np.asarray(js) == 0).all()


def test_overflowing_width_suppresses_nothing(rng):
    """exp(tw) overflows to w = inf: the box's IoU with any other box is
    0 (its union is inf) and with itself NaN, so it suppresses nothing
    and nothing suppresses it — in the twin as in the Pallas kernel."""
    net, anchors = _netout(rng, '13x13x5x25')
    net[6, 6, 2, 2] = 100.0
    net[6, 6, 2, 4:6] = (5.0, 8.0)             # and it lives
    k = (6 * 13 + 6) * 5 + 2                   # (row·GW + col)·A + a
    boxes, scores = _twin(net, anchors)
    assert np.isinf(boxes[k, 2])
    assert np.isfinite(np.delete(boxes, k, 0)).all()
    assert scores[k].max() > 0                 # kept
    jb, js = (np.asarray(a) for a in jax_fused(jnp.asarray(net), anchors,
                                                interpret=True))
    np.testing.assert_array_equal(np.isinf(boxes), np.isinf(jb))
    fin = np.isfinite(boxes)
    np.testing.assert_allclose(boxes[fin], jb[fin], **TOL)
    np.testing.assert_allclose(scores, js, **TOL)
    np.testing.assert_array_equal(scores > 0, js > 0)
    dead = net.copy()
    dead[6, 6, 2, 4] = -30.0                   # the same box, dead
    _, without = _twin(dead, anchors)
    np.testing.assert_array_equal(np.delete(scores, k, 0),
                                  np.delete(without, k, 0))


def test_wrapper_runs_twin_on_cpu_and_checks_inputs(rng):
    net, anchors = _netout(rng, '4x4x3x9', frames=2)
    x = torch.from_numpy(net)
    before = cuda_dn.decode_nms_fused.launches
    boxes, scores = cuda_dn.decode_nms_fused(x, anchors)
    plain = cuda_dn.decode_nms_fused_plain(
        x, torch.from_numpy(anchors).reshape(-1, 2))
    np.testing.assert_array_equal(boxes.numpy(), plain[0].numpy())
    np.testing.assert_array_equal(scores.numpy(), plain[1].numpy())
    assert cuda_dn.decode_nms_fused.launches == before
    # float64 is cast to float32 first, as the JAX wrapper casts
    b64, s64 = cuda_dn.decode_nms_fused(x.double(), anchors)
    assert b64.dtype == torch.float32
    np.testing.assert_array_equal(s64.numpy(), scores.numpy())
    with pytest.raises(ValueError, match='cuda or cpu'):
        cuda_dn.decode_nms_fused(x.to('meta'), anchors)
    with pytest.raises(ValueError):
        cuda_dn.decode_nms_fused(x[0, 0], anchors)          # 3-d
    with pytest.raises(ValueError, match='C >= 1'):
        cuda_dn.decode_nms_fused(x[..., :5], anchors)       # no classes
