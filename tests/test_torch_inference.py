"""Slice parity: the port's JointPredictor vs the JAX one, end to end.

Same converted weights and seeded frames through both predictors:
streamed `predict_window` calls, `predict_video` with a partial last
window, streamed `predict_batch` calls at B=2; the greedy and the
hungarian matchers; bn_mode 'batch' and 'running'. Labels, the set and
order of valid detections, and track ids must be exactly equal; scores
and boxes agree to 1e-5 with running statistics. With batch statistics
the model's float32 outputs themselves carry ~1e-4 of rounding (see
test_torch_models.py), which exp() scales into the box widths, so boxes
and scores are held to rtol=1e-3, atol=1e-4 there. Before every call the
test checks that no class score of the window lies within 1e-4 of
obj_threshold, so that a flipped detection is a real fault, not noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.inference import JointPredictor as JPredictor
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu_torch.config import YOLOV2_ANCHORS
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.inference import JointPredictor
from object_tracking_tpu_torch.models import MultiObjDetTracker
from torch_parity import randomize_bn

SMALL = dict(num_classes=3, num_anchors=2, convlstm_features=8,
             width_div=8)
ANCHORS = np.asarray(YOLOV2_ANCHORS[:4], np.float32)
LABELS = ('a', 'b', 'c')
OBJ_THRESHOLD = 0.25


def _pair(rng, bn_mode, matcher):
    jmodel = JTracker(**SMALL)
    variables = randomize_bn(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 64, 64, 3))), rng)
    # a wider track head spreads the class scores over (0, 1), so few lie
    # near obj_threshold
    variables['params']['tconv_2']['kernel'] *= 4.0
    kwargs = dict(labels=LABELS, obj_threshold=OBJ_THRESHOLD,
                  net_size=(64, 64), bn_mode=bn_mode, matcher=matcher)
    jpred = JPredictor(jmodel, variables, ANCHORS, **kwargs)
    model = MultiObjDetTracker(**SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    return jpred, JointPredictor(model, ANCHORS, device='cpu', **kwargs)


def _guard(jpred, clips, state, batch_bn):
    """No class score (conf * softmax) of these clips lies within 1e-4 of
    obj_threshold, under the JAX predictor's carried state."""
    if state is None:
        state = jpred.model.zero_state(clips.shape[0], 2, 2)
    out = jpred.model.apply(jpred.variables, clips, train=batch_bn,
                            initial_state=state,
                            mutable=['batch_stats'] if batch_bn else False)
    if batch_bn:
        out = out[0]
    netout = np.asarray(out['track'])
    conf = 1.0 / (1.0 + np.exp(-netout[..., 4:5]))
    logits = netout[..., 5:] - netout[..., 5:].max(-1, keepdims=True)
    probs = conf * np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    assert np.abs(probs - OBJ_THRESHOLD).min() > 1e-4
    assert (probs > OBJ_THRESHOLD).any()


def _same_frames(port, ref, bn_mode):
    tol = dict(rtol=0, atol=1e-5) if bn_mode == 'running' else \
        dict(rtol=1e-3, atol=1e-4)
    assert len(port) == len(ref)
    for p_frame, r_frame in zip(port, ref):
        assert [(d['label'], d['track_id']) for d in p_frame] == \
            [(d['label'], d['track_id']) for d in r_frame]
        np.testing.assert_allclose([d['score'] for d in p_frame],
                                   [d['score'] for d in r_frame], **tol)
        np.testing.assert_allclose(np.reshape([d['box'] for d in p_frame],
                                              (-1, 4)),
                                   np.reshape([d['box'] for d in r_frame],
                                              (-1, 4)), **tol)


@pytest.mark.parametrize('bn_mode,matcher', [('batch', 'greedy'),
                                             ('running', 'hungarian')])
def test_predict_window_streams_like_jax(rng, bn_mode, matcher):
    jpred, pred = _pair(rng, bn_mode, matcher)
    detections = 0
    for _ in range(2):
        frames = rng.rand(4, 64, 64, 3).astype(np.float32)
        _guard(jpred, frames[None], jpred._state, bn_mode == 'batch')
        ref = jpred.predict_window(frames)
        out = pred.predict_window(frames)
        _same_frames(out, ref, bn_mode)
        detections += sum(map(len, ref))
    assert detections > 0
    assert pred._state[0].shape == (1, 2, 2, 8)


def test_predict_video_partial_window_like_jax(rng):
    jpred, pred = _pair(rng, 'running', 'greedy')
    frames = rng.rand(6, 64, 64, 3).astype(np.float32)
    _guard(jpred, frames[None, :4], None, False)
    ref = jpred.predict_video(list(frames), window=4)
    out = pred.predict_video(list(frames), window=4)
    assert len(out) == 6
    _same_frames(out, ref, 'running')
    assert sum(map(len, ref)) > 0


def test_predict_batch_streams_like_jax(rng):
    jpred, pred = _pair(rng, 'batch', 'greedy')
    for _ in range(2):
        clips = rng.rand(2, 4, 64, 64, 3).astype(np.float32)
        _guard(jpred, clips, getattr(jpred, '_bstate', None), True)
        ref = jpred.predict_batch(clips)
        out = pred.predict_batch(clips)
        assert len(out) == 2
        for clip_out, clip_ref in zip(out, ref):
            _same_frames(clip_out, clip_ref, 'batch')
    assert max(d['track_id'] for clip in out for f in clip for d in f) > 0


def test_predict_batch_requires_greedy_and_cuda_never_falls_back(
        monkeypatch):
    model = MultiObjDetTracker(**SMALL)
    pred = JointPredictor(model, ANCHORS, LABELS, net_size=(64, 64),
                          matcher='hungarian', device='cpu')
    with pytest.raises(ValueError, match='greedy'):
        pred.predict_batch(np.zeros((2, 4, 64, 64, 3), np.float32))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        JointPredictor(model, ANCHORS, LABELS)
