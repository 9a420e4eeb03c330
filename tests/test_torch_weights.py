"""Port parity: darknet `.weights` ingestion and export (ops/weights.py)
and `convert.to_flax`.

The port's loader is a numpy copy of the JAX package's, so on the same
file it must give the same arrays exactly; its exporter must write the
same bytes. The files are the full-size Darknet-19 streams that
tests/test_models.py synthesizes, in both header layouts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import DetectorConfig as JConfig
from object_tracking_tpu.models.yolov2 import YOLOv2Detector as JDetector
from object_tracking_tpu.ops import weights as jweights
from object_tracking_tpu_torch.config import DetectorConfig
from object_tracking_tpu_torch.convert import from_flax, to_flax
from object_tracking_tpu_torch.models import MultiObjDetTracker, YOLOv2Detector
from object_tracking_tpu_torch.ops import weights
from tests.test_models import make_fake_weights_file

LABELS = ('a', 'b', 'c')


@pytest.fixture(scope='module')
def files():
    paths = {v: make_fake_weights_file(version=v)
             for v in ((0, 0, 0), (0, 2, 0))}
    yield paths
    for path in paths.values():
        os.unlink(path)


def _leaves(tree, prefix=''):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield f'{prefix}{key}', np.asarray(value)


@pytest.mark.parametrize('version', [(0, 0, 0), (0, 2, 0)])
def test_loader_equals_jax_loader(files, version):
    ref = dict(_leaves(jweights.load_yolov2_weights(files[version], 3)))
    out = dict(_leaves(weights.load_yolov2_weights(files[version], 3)))
    assert out.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_loader_shapes_and_file_order(files):
    path = files[(0, 0, 0)]
    loaded = weights.load_yolov2_weights(path, num_classes=3)
    assert loaded['params']['conv_1']['kernel'].shape == (3, 3, 3, 32)
    assert loaded['params']['conv_22']['kernel'].shape == (3, 3, 1280, 1024)
    assert loaded['params']['conv_23']['kernel'].shape == (1, 1, 1024, 40)
    assert loaded['batch_stats']['norm_1']['mean'].shape == (32,)
    raw = np.fromfile(path, np.float32)        # beta, gamma, mean, var
    np.testing.assert_array_equal(loaded['params']['norm_1']['bias'],
                                  raw[4:36])
    np.testing.assert_array_equal(loaded['params']['norm_1']['scale'],
                                  raw[36:68])
    v2 = weights.load_yolov2_weights(files[(0, 2, 0)], num_classes=3)
    np.testing.assert_array_equal(v2['params']['conv_23']['bias'],
                                  loaded['params']['conv_23']['bias'])


def test_detector_ingests_weights_like_jax(files, rng):
    path = files[(0, 2, 0)]
    det = YOLOv2Detector(DetectorConfig(labels=LABELS, image_h=64,
                                        image_w=64, weights_path=path),
                         device='cpu')
    jdet = JDetector(JConfig(labels=LABELS, image_h=64, image_w=64,
                             weights_path=path))
    np.testing.assert_array_equal(
        det.model.conv_1.weight.detach().numpy(),
        np.asarray(jdet.variables['params']['conv_1']['kernel']
                   ).transpose(3, 2, 0, 1))
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    out, ref = det.forward(x), jdet.forward(jnp.asarray(x))
    # unit-variance random weights: activations grow to ~1e3 through 22
    # layers, so the tolerance is relative to the output's scale
    for key in ('netout', 'conv_feat'):
        scale = float(np.abs(np.asarray(ref[key])).max())
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-5 * scale)
    assert out['netout'].shape == (1, 2, 2, 5, 8)
    assert det.get_layer_dims('conv_feat') == jdet.get_layer_dims() == \
        (2, 2, 1024)


def test_export_is_byte_identical(files, tmp_path):
    """Loading into the port's detector and exporting its state_dict
    (through to_flax) writes the source file back byte for byte; so does
    the JAX exporter on the port loader's tree."""
    src = files[(0, 2, 0)]
    det = YOLOv2Detector(DetectorConfig(labels=LABELS, image_h=64,
                                        image_w=64, weights_path=src),
                         device='cpu')
    seen = int(np.fromfile(src, dtype=np.uint64, count=1, offset=12)[0])
    out = tmp_path / 'port.weights'
    weights.export_yolov2_weights(to_flax(det.model.state_dict()),
                                  str(out), seen=seen)
    assert open(src, 'rb').read() == out.read_bytes()
    ref = tmp_path / 'jax.weights'
    jweights.export_yolov2_weights(
        weights.load_yolov2_weights(src, 3), str(ref), seen=seen)
    assert ref.read_bytes() == out.read_bytes()


def test_head_keeps_its_init_when_the_file_has_none():
    """A stream without the head conv_23 (too short for it): every other
    layer is loaded, conv_23 keeps its seeded random init."""
    path = make_fake_weights_file(with_head=False)
    try:
        cfg = dict(labels=LABELS, image_h=64, image_w=64)
        fresh = YOLOv2Detector(DetectorConfig(**cfg), device='cpu')
        det = YOLOv2Detector(DetectorConfig(weights_path=path, **cfg),
                             device='cpu')
    finally:
        os.unlink(path)
    assert torch.equal(det.model.conv_23.weight, fresh.model.conv_23.weight)
    assert not torch.equal(det.model.conv_1.weight,
                           fresh.model.conv_1.weight)


def test_to_flax_inverts_from_flax():
    model = MultiObjDetTracker(num_classes=3, num_anchors=2,
                               convlstm_features=8, width_div=8)
    jvars = jax.tree_util.tree_map(np.asarray, to_flax(model.state_dict()))
    assert jvars['params']['detector']['conv_1']['kernel'].shape == \
        (3, 3, 3, 4)                                           # HWIO
    assert 'mean' in jvars['batch_stats']['detector']['norm_1']
    back = from_flax(jvars)
    state = model.state_dict()
    assert back.keys() == state.keys()
    for key, value in state.items():
        assert torch.equal(back[key], value), key
