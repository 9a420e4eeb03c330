"""Port parity: YOLOv2Detector vs the JAX detector, on converted weights.

Small size (width_div=8, 64x64 input, 3 classes, 5 anchors), float32,
running BatchNorm statistics randomised first so they are not an
identity, and the head conv scaled up so that class scores spread over
(0, 1). Tolerances: netout and conv_feat rtol 1e-4, atol 1e-5; decoded
boxes and scores atol 1e-5 with identical labels and valid masks. Every
input is checked first to have no class score within 1e-4 of the
threshold, so that a flipped detection is a real fault, not rounding.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import DetectorConfig as JConfig
from object_tracking_tpu.models.yolov2 import YOLOv2Detector as JDetector
from object_tracking_tpu.ops.decode import decode_and_nms as jax_decode
from object_tracking_tpu_torch.config import DetectorConfig
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.models import (CfgDetector, VGG16PriorSource,
                                              YOLOv2Detector)
from object_tracking_tpu_torch.models.yolov2 import rerandomize_head
from object_tracking_tpu_torch.ops.decode import decode_and_nms
from torch_parity import randomize_bn

TOL = dict(rtol=1e-4, atol=1e-5)
DEC_TOL = dict(rtol=0, atol=1e-5)
SCENE = os.path.join(os.path.dirname(__file__), 'fixtures', 'scene_0.jpg')
CFG = dict(labels=('a', 'b', 'c'), image_h=64, image_w=64, width_div=8,
           obj_threshold=0.3)


@pytest.fixture(scope='module')
def pair():
    jdet = JDetector(JConfig(**CFG))
    variables = randomize_bn(jdet.variables, np.random.RandomState(0))
    variables['params']['conv_23']['kernel'] *= 8.0
    jdet.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    det = YOLOv2Detector(DetectorConfig(**CFG), device='cpu')
    det.model.load_state_dict(from_flax(variables), strict=True)
    return jdet, det


def _guard(netout):
    """No class score (conf * softmax) within 1e-4 of the threshold, and
    at least one above it."""
    netout = np.asarray(netout, np.float64)
    conf = 1.0 / (1.0 + np.exp(-netout[..., 4:5]))
    e = np.exp(netout[..., 5:] - netout[..., 5:].max(-1, keepdims=True))
    probs = conf * e / e.sum(-1, keepdims=True)
    assert np.abs(probs - CFG['obj_threshold']).min() > 1e-4
    assert (probs > CFG['obj_threshold']).any()


def _same_detections(out, ref):
    assert len(out) == len(ref) > 0
    for (label, score, box), (rlabel, rscore, rbox) in zip(out, ref):
        assert label == rlabel
        np.testing.assert_allclose(score, rscore, **DEC_TOL)
        np.testing.assert_allclose(box, rbox, **DEC_TOL)


def test_forward_matches_jax(pair, rng):
    jdet, det = pair
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    out, ref = det.forward(x), jdet.forward(jnp.asarray(x))
    for key in ('netout', 'conv_feat'):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   **TOL)


def test_decode_and_nms_matches_jax(pair, rng):
    jdet, det = pair
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    netout = det.forward(x)['netout']
    _guard(netout.numpy())
    out = [a.numpy() for a in decode_and_nms(
        netout[0], det.anchors, CFG['obj_threshold'], 0.45)]
    ref = [np.asarray(a) for a in jax_decode(
        jdet.forward(jnp.asarray(x))['netout'][0],
        jnp.asarray(jdet.config.anchors), obj_threshold=CFG['obj_threshold'],
        nms_threshold=0.45)]
    assert ref[3].any()
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a, r, **DEC_TOL)


def test_forward_batch_matches_jax(pair, rng):
    jdet, det = pair
    x = rng.rand(3, 64, 64, 3).astype(np.float32)
    _guard(det.forward(x)['netout'].numpy())
    out = [a.numpy() for a in det.forward_batch(x)]
    ref = [np.asarray(a) for a in jdet.forward_batch(jnp.asarray(x))]
    assert out[1].shape == (3, 16, 4) and out[4].any()
    np.testing.assert_allclose(out[0], ref[0], **TOL)          # conv_feat
    for a, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a, r, **DEC_TOL)
    _same_detections(det.detect_images(x)[1],
                     det.detect_images(x[1:2])[0])


def test_image_path_surfaces_match_jax(pair, tmp_path):
    jdet, det = pair
    _, x = det._prep(SCENE)
    _guard(det.forward(x)['netout'].numpy())
    out_path = str(tmp_path / 'drawn.jpg')
    _same_detections(det.predict(SCENE, out_path), jdet.predict(SCENE))
    assert os.path.getsize(out_path) > 0
    _same_detections(det.detect(SCENE), jdet.detect(SCENE))
    for layer in ('conv_feat', 'netout'):
        np.testing.assert_allclose(det.extract(SCENE, layer),
                                   jdet.extract(SCENE, layer), **TOL)
    named, feats = det.extract_spatio_info(SCENE)
    jnamed, jfeats = jdet.extract_spatio_info(SCENE)
    _same_detections(named, jnamed)
    np.testing.assert_allclose(feats, jfeats, **TOL)
    keep = named[0][0]
    filtered, _ = det.extract_spatio_info(SCENE, class_filter=(keep,))
    assert all(d[0] == keep for d in filtered)
    _same_detections(filtered, jdet.extract_spatio_info(
        SCENE, class_filter=(keep,))[0])


def test_layer_dims(pair):
    jdet, det = pair
    for layer in ('conv_feat', 'netout'):
        assert det.get_layer_dims(layer) == jdet.get_layer_dims(layer)
    assert det.get_layer_dims('netout') == (2, 2, 40)
    with pytest.raises(KeyError):
        det.get_layer_dims('nope')


def test_rerandomize_head():
    det = YOLOv2Detector(DetectorConfig(**CFG), device='cpu')
    before = {k: v.clone() for k, v in det.model.state_dict().items()}
    rerandomize_head(det.model, torch.Generator().manual_seed(0), 13, 13)
    after = det.model.state_dict()
    for key in ('conv_23.weight', 'conv_23.bias'):
        assert not torch.equal(after[key], before[key])
    # N(0, 1) / (GH·GW): 40 x 128 weights, std within 10 % of 1/169
    assert abs(float(after['conv_23.weight'].std()) * 169 - 1) < 0.1
    for key in before:
        if not key.startswith('conv_23'):
            assert torch.equal(after[key], before[key]), key
    again = YOLOv2Detector(DetectorConfig(**CFG), device='cpu')
    rerandomize_head(again.model, torch.Generator().manual_seed(0), 13, 13)
    assert torch.equal(again.model.conv_23.weight, after['conv_23.weight'])
    with pytest.raises(KeyError):
        rerandomize_head(det.model, torch.Generator(), 13, 13, 'conv_99')


def test_detectors_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'yolov2-micro.cfg')
    for make in (lambda: YOLOv2Detector(DetectorConfig(**CFG)),
                 lambda: CfgDetector(cfg),
                 lambda: VGG16PriorSource(64, 64, width_div=8,
                                          fc_features=16)):
        with pytest.raises(RuntimeError, match='CUDA'):
            make()
