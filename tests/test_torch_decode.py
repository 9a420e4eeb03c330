"""Port parity: netout decode and decode+NMS vs the JAX ops/decode.py.

Tolerance 1e-5 on boxes and scores (sigmoid/softmax/exp round differently
in the two frameworks); labels and valid exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import YOLOV2_ANCHORS as JAX_ANCHORS
from object_tracking_tpu.ops import decode as jdec
from object_tracking_tpu_torch.config import YOLOV2_ANCHORS
from object_tracking_tpu_torch.ops import decode as tdec

ANCHORS = np.asarray(YOLOV2_ANCHORS, np.float32)


def _netout(rng, lead=(), gh=13, gw=13, a=5, c=12, conf_shift=1.5):
    netout = rng.randn(*lead, gh, gw, a, 5 + c).astype(np.float32)
    netout[..., 4] += conf_shift
    netout[..., 5] += 2.0              # one dominant class: live scores
    return netout


def test_anchor_copy_matches_jax():
    assert YOLOV2_ANCHORS == JAX_ANCHORS


@pytest.mark.parametrize('thresh', [0.3, 0.5])
def test_decode_netout(rng, thresh):
    netout = _netout(rng)
    jb, js = jdec.decode_netout(jnp.asarray(netout), ANCHORS, thresh)
    tb, ts = tdec.decode_netout(torch.from_numpy(netout), ANCHORS, thresh)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    assert ((ts.numpy() > 0) == (np.asarray(js) > 0)).all()


def test_decode_netout_leading_dims(rng):
    netout = _netout(rng, lead=(2, 3), gh=4, gw=4, a=2, c=3)
    tb, ts = tdec.decode_netout(torch.from_numpy(netout), ANCHORS[:4], 0.3)
    assert tb.shape == (2, 3, 32, 4) and ts.shape == (2, 3, 32, 3)
    jb, js = jdec.decode_netout(jnp.asarray(netout[1, 2]), ANCHORS[:4], 0.3)
    np.testing.assert_allclose(tb[1, 2].numpy(), np.asarray(jb), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ts[1, 2].numpy(), np.asarray(js), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('nms_impl', ['sort', 'matmul'])
@pytest.mark.parametrize('obj_threshold', [0.3, 0.5])
def test_decode_and_nms_batched_matches_jax(rng, nms_impl, obj_threshold):
    """(B, T) netouts decode and NMS in one batched call; every frame
    equals JAX's per-frame decode_and_nms (top-128 cap of 845)."""
    netout = _netout(rng, lead=(2, 2))
    out = tdec.decode_and_nms(torch.from_numpy(netout), ANCHORS,
                              obj_threshold=obj_threshold, nms_impl=nms_impl)
    boxes, labels, scores, valid = (a.numpy() for a in out)
    assert boxes.shape == (2, 2, 128, 4) and valid.shape == (2, 2, 128)
    for b in range(2):
        for t in range(2):
            jb, jl, js, jv = (np.asarray(a) for a in jdec.decode_and_nms(
                jnp.asarray(netout[b, t]), jnp.asarray(ANCHORS),
                obj_threshold=obj_threshold, nms_impl='sort'))
            assert jv.sum() > 0
            assert np.abs(js - obj_threshold).min() > 1e-4
            np.testing.assert_allclose(boxes[b, t], jb, atol=1e-5, rtol=0)
            np.testing.assert_allclose(scores[b, t], js, atol=1e-5, rtol=0)
            np.testing.assert_array_equal(labels[b, t], jl)
            np.testing.assert_array_equal(valid[b, t], jv)


def test_boxes_to_list_matches_jax(rng):
    netout = _netout(rng, gh=4, gw=4, a=2, c=3)
    jres = jdec.decode_and_nms(jnp.asarray(netout), jnp.asarray(ANCHORS[:4]),
                               obj_threshold=0.3, nms_impl='sort')
    tres = tdec.decode_and_nms(torch.from_numpy(netout), ANCHORS[:4],
                               obj_threshold=0.3)
    jl, tl = jdec.boxes_to_list(*jres), tdec.boxes_to_list(*tres)
    assert len(jl) == len(tl) > 0
    for (jlab, jsc, jbox), (tlab, tsc, tbox) in zip(jl, tl):
        assert jlab == tlab
        np.testing.assert_allclose(tsc, jsc, atol=1e-5)
        np.testing.assert_allclose(tbox, jbox, atol=1e-5)
