"""Port parity: the darknet cfg compiler (models/darknet_cfg.py) vs JAX.

Parsing, plans and loaded weight trees must equal the JAX package's
exactly; the compiled nets, on the same (converted) variables with
randomised BatchNorm statistics, must give the same heads and final
activation to rtol 1e-4, atol 1e-5, and the decoded detections the same
labels with boxes and scores to atol 1e-5. The cfgs are those of
tests/test_darknet_cfg.py: a stride-2 conv on an even input (pads (0, 1),
not torch's (1, 1)), the tiny-yolo size-2/stride-1 pool (pads (0, 1) with
-inf), route + reorg, shortcut and upsample; and the committed
yolov2-micro fixture.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.models import darknet_cfg as jcfg
from object_tracking_tpu_torch.convert import from_flax, to_flax
from object_tracking_tpu_torch.models import darknet_cfg as tcfg
from object_tracking_tpu_torch.models.darknet_cfg import CfgDetector
from tests.test_darknet_cfg import TINY_CFG, V3_CFG, YOLOV2_CFG
from tests.test_models import make_fake_weights_file
from torch_parity import randomize_bn

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
MICRO_CFG = os.path.join(FIXTURES, 'yolov2-micro.cfg')
MICRO_WEIGHTS = os.path.join(FIXTURES, 'yolov2-micro.weights')
MICRO = open(MICRO_CFG).read()
CFGS = {'tiny': TINY_CFG, 'v3': V3_CFG, 'micro': MICRO, 'yolov2': YOLOV2_CFG}
TOL = dict(rtol=1e-4, atol=1e-5)
DEC_TOL = dict(rtol=0, atol=1e-5)


@pytest.mark.parametrize('name', CFGS)
def test_parse_compile_and_specs_equal_jax(name):
    """Equal to JAX's, but that the port's [yolo] plan entries and head
    specs also carry `scale_x_y`, 1.0 where the cfg leaves it out."""
    text = CFGS[name]
    assert tcfg.parse_darknet_cfg(text) == jcfg.parse_darknet_cfg(text)
    sections = tcfg.parse_darknet_cfg(text)
    jhwc, jplan = jcfg.compile_cfg(sections)
    assert tcfg.compile_cfg(sections) == (jhwc, tuple(
        layer + (1.0,) if layer[0] == 'yolo' else layer for layer in jplan))
    _, plan = tcfg.compile_cfg(sections)
    assert tcfg.head_specs(plan) == tuple(
        dict(s, scale_x_y=1.0) if s['kind'] == 'yolo' else s
        for s in jcfg.head_specs(jplan))


def test_compile_resolves_negative_routes():
    _, plan = tcfg.compile_cfg(tcfg.parse_darknet_cfg(YOLOV2_CFG))
    routes = [l for l in plan if l[0] == 'route']
    assert routes[0] == ('route', (16,))          # -9 from index 25
    assert routes[1] == ('route', (27, 24))       # -1, -4 from index 28


def test_unsupported_section_raises():
    with pytest.raises(ValueError, match='unsupported'):
        tcfg.compile_cfg(tcfg.parse_darknet_cfg(
            '[net]\nheight=32\nwidth=32\nchannels=3\n[gru]\n'))


def _pair(text, rng):
    jmodel, (h, w, c) = jcfg.build_from_cfg(text)
    x = rng.rand(2, h, w, c).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if 'batch_stats' in variables:
        variables = randomize_bn(variables, rng)
    model, in_hwc = tcfg.build_from_cfg(text)
    assert in_hwc == (h, w, c)
    model.load_state_dict(from_flax(variables), strict=True)
    return jmodel, variables, model, x


@pytest.mark.parametrize('name', ['tiny', 'v3', 'micro'])
def test_compiled_net_matches_flax(name, rng):
    jmodel, variables, model, x = _pair(CFGS[name], rng)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert len(out['heads']) == len(ref['heads']) >= 1
    for o, r in zip(out['heads'] + [out['final']],
                    ref['heads'] + [ref['final']]):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    assert tuple(out['final'].shape[1:]) == tcfg.plan_shapes(
        model.plan, model.in_hwc)[-1]


def test_padding_pins():
    """flax 'SAME': a stride-2 3x3 conv on 32 pads (0, 1); a size-2
    stride-1 pool pads (0, 1); a stride-1 3x3 conv pads (1, 1)."""
    assert tcfg._same_pads(32, 3, 2) == (0, 1)
    assert tcfg._same_pads(16, 2, 1) == (0, 1)
    assert tcfg._same_pads(13, 3, 1) == (1, 1)
    assert tcfg._same_pads(26, 2, 2) == (0, 0)


def test_yolo3_decode_matches_jax_and_hand_computed(rng):
    netout = np.zeros((1, 1, 1, 5 + 2), np.float32)
    netout[0, 0, 0, 4] = 10.0          # sigmoid→~1
    netout[0, 0, 0, 5] = 10.0
    boxes, scores = tcfg.decode_yolo3_netout(
        torch.from_numpy(netout), [[16.0, 32.0]], net_size=(64, 64),
        obj_threshold=0.1)
    np.testing.assert_allclose(boxes[0].numpy(),
                               [0.5, 0.5, 16 / 64, 32 / 64], rtol=1e-5)
    assert float(scores[0, 0]) > 0.9
    anchors = np.asarray([[10, 13], [16, 30], [33, 23]], np.float32)
    netout = rng.randn(2, 8, 8, 3, 7).astype(np.float32)
    out = tcfg.decode_yolo3_netout(torch.from_numpy(netout), anchors,
                                   (32, 32), 0.3)
    for f in range(2):
        ref = jcfg.decode_yolo3_netout(jnp.asarray(netout[f]),
                                       jnp.asarray(anchors), (32, 32), 0.3)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o[f].numpy(), np.asarray(r),
                                       **DEC_TOL)


def test_decode_cfg_outputs_matches_jax(rng):
    """Two [yolo] heads decoded, merged and NMS'd: every batch element in
    one call equals JAX's per-element call."""
    jmodel, variables, model, x = _pair(V3_CFG, rng)
    specs = tcfg.head_specs(model.plan)
    with torch.no_grad():
        heads = model(torch.from_numpy(x))['heads']
    out = [a.numpy() for a in tcfg.decode_cfg_outputs(
        heads, specs, (32, 32), obj_threshold=0.0, top_k=16)]
    assert out[0].shape == (2, 16, 4) and out[3].dtype == bool
    for f in range(2):
        ref = jcfg.decode_cfg_outputs([h[f:f + 1].numpy() for h in heads],
                                      (32, 32), obj_threshold=0.0, top_k=16,
                                      specs=specs)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o[f], np.asarray(r), **DEC_TOL)


def test_weights_load_like_jax_and_export_byte_identical(tmp_path):
    ref = jcfg.load_weights_for_cfg(MICRO_WEIGHTS, MICRO)
    out = tcfg.load_weights_for_cfg(MICRO_WEIGHTS, MICRO)
    for coll in ('params', 'batch_stats'):
        assert out[coll].keys() == ref[coll].keys()
        for layer in ref[coll]:
            for leaf in ref[coll][layer]:
                np.testing.assert_array_equal(out[coll][layer][leaf],
                                              ref[coll][layer][leaf])
    seen = int(np.fromfile(MICRO_WEIGHTS, dtype=np.uint64, count=1,
                           offset=12)[0])
    src = open(MICRO_WEIGHTS, 'rb').read()
    path = tmp_path / 'roundtrip.weights'
    tcfg.export_weights_for_cfg(out, MICRO, str(path), seen=seen)
    assert path.read_bytes() == src
    det = CfgDetector(MICRO_CFG, weights_path=MICRO_WEIGHTS, device='cpu')
    tcfg.export_weights_for_cfg(to_flax(det.module.state_dict()), MICRO,
                                str(path), seen=seen)
    assert path.read_bytes() == src


def test_weight_loader_rejects_mismatched_cfg():
    with pytest.raises(ValueError, match='mismatch'):
        tcfg.load_weights_for_cfg(MICRO_WEIGHTS, TINY_CFG)


def test_cfg_detector_matches_jax_on_the_fixture(rng):
    jdet = jcfg.CfgDetector(MICRO_CFG, weights_path=MICRO_WEIGHTS,
                            labels=('1', '2'), obj_threshold=0.3)
    det = CfgDetector(MICRO_CFG, weights_path=MICRO_WEIGHTS,
                      labels=('1', '2'), obj_threshold=0.3, device='cpu')
    assert det.get_layer_dims() == jdet.get_layer_dims() == (5, 5, 35)
    with pytest.raises(KeyError):
        det.get_layer_dims('conv_feat')
    x = rng.rand(2, 160, 160, 3).astype(np.float32)
    out = [a.numpy() for a in det.forward_batch(x)]
    ref = [np.asarray(a) for a in jdet.forward_batch(jnp.asarray(x))]
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, **DEC_TOL)


def test_cfg_detector_end_to_end(tmp_path):
    """The full-width yolov2 cfg, synthetic darknet weights and an image
    file → sorted detections and a drawn output; heads as JAX's."""
    import cv2
    path = make_fake_weights_file(num_classes=3)
    try:
        det = CfgDetector(YOLOV2_CFG, weights_path=path,
                          labels=('a', 'b', 'c'), obj_threshold=0.0,
                          device='cpu')
        jdet = jcfg.CfgDetector(YOLOV2_CFG, weights_path=path,
                                labels=('a', 'b', 'c'), obj_threshold=0.0)
    finally:
        os.unlink(path)
    img = (np.random.RandomState(0).rand(96, 128, 3) * 255).astype(np.uint8)
    img_path, out_path = str(tmp_path / 'in.jpg'), str(tmp_path / 'out.jpg')
    cv2.imwrite(img_path, img)
    dets = det.predict(img_path, out_path)
    assert os.path.exists(out_path)
    assert dets and all(d[0] in ('a', 'b', 'c') and len(d[2]) == 4
                        for d in dets)
    scores = [d[1] for d in dets]
    assert scores == sorted(scores, reverse=True)
    # unit-variance random weights: activations grow to ~1e3 through 22
    # layers, so the tolerance is relative to the output's scale
    x = np.asarray(cv2.resize(img[:, :, ::-1], (64, 64)),
                   np.float32)[None] / 255.0
    out = det.forward(x)['heads'][0].numpy()
    ref = np.asarray(jdet.forward(jnp.asarray(x))['heads'][0])
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_label_fallbacks_warn_like_jax():
    coco = TINY_CFG.replace('filters=21', 'filters=255').replace(
        'classes=2', 'classes=80')
    det = CfgDetector(coco, device='cpu')
    assert det.labels == jcfg.CfgDetector(coco).labels
    assert det.labels[0] == 'person' and len(det.labels) == 80
    with pytest.warns(UserWarning, match='positional'):
        named = CfgDetector(TINY_CFG, labels=('a', 'b', 'c'), device='cpu')
    assert named.labels == ('class_0', 'class_1')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert CfgDetector(TINY_CFG, labels=('x', 'y'),
                           device='cpu').labels == ('x', 'y')
    with pytest.raises(ValueError, match='head'):
        CfgDetector('[net]\nheight=32\nwidth=32\nchannels=3\n'
                    '[convolutional]\nfilters=4\nsize=1\n', device='cpu')
