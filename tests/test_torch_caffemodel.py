"""Port parity: `.caffemodel` ingestion (ops/caffemodel.py) vs JAX.

The port's reader, writer and VGG16 mapping are numpy copies of the JAX
package's: the same layers give the same bytes and the same arrays,
exactly. Loaded into the port's VGG16PriorSource, a caffemodel gives the
same features as the npz path (rtol 1e-6) and as the JAX prior source on
the same weights (rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest

from object_tracking_tpu.models import VGG16PriorSource as JSource
from object_tracking_tpu.ops import caffemodel as jcaffe
from object_tracking_tpu_torch.models import VGG16PriorSource
from object_tracking_tpu_torch.ops import caffemodel
from tests.test_caffemodel import _synth_layers

SMALL = dict(image_h=64, image_w=64, width_div=8, fc_features=64)


@pytest.mark.parametrize('v1', [True, False])
def test_roundtrip_equals_jax(tmp_path, rng, v1):
    layers = _synth_layers(rng)
    path, ref_path = tmp_path / 'port.caffemodel', tmp_path / 'jax.caffemodel'
    caffemodel.write_caffemodel(str(path), layers, v1=v1)
    jcaffe.write_caffemodel(str(ref_path), layers, v1=v1)
    assert path.read_bytes() == ref_path.read_bytes()
    back = caffemodel.read_caffemodel(str(path))
    ref = jcaffe.read_caffemodel(str(path))
    assert back.keys() == ref.keys() == {n for n, _ in layers}
    for name, blobs in layers:
        for a, b, r in zip(blobs, back[name], ref[name]):
            np.testing.assert_array_equal(b, r)
            np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b)


def test_vgg16_mapping_equals_jax(tmp_path, rng):
    path = str(tmp_path / 'synth.caffemodel')
    caffemodel.write_caffemodel(path, _synth_layers(rng), v1=True)
    blobs = caffemodel.read_caffemodel(path)
    out = caffemodel.caffemodel_to_vgg16_params(blobs, fc_features=64)
    ref = jcaffe.caffemodel_to_vgg16_params(blobs, fc_features=64)
    assert out.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_mapping_matches_npz_path_and_jax(tmp_path, rng):
    path = str(tmp_path / 'synth.caffemodel')
    caffemodel.write_caffemodel(path, _synth_layers(rng), v1=True)
    mapped = caffemodel.caffemodel_to_vgg16_params(
        caffemodel.read_caffemodel(path), fc_features=64)
    npz_path = str(tmp_path / 'synth.npz')
    np.savez(npz_path, **mapped)

    a = VGG16PriorSource(device='cpu', **SMALL)
    caffemodel.load_caffemodel_into(a, path)
    b = VGG16PriorSource(weights_path=npz_path, device='cpu', **SMALL)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    fa, *_ = a.forward_batch(x)
    fb, *_ = b.forward_batch(x)
    np.testing.assert_allclose(fa, fb, rtol=1e-6, atol=1e-6)
    fc, *_ = VGG16PriorSource(device='cpu', **SMALL).forward_batch(x)
    assert np.abs(fa - fc).max() > 1e-3      # the ingest changed the init
    ref = JSource(**SMALL)
    jcaffe.load_caffemodel_into(ref, path)
    fr, *_ = ref.forward_batch(x)
    np.testing.assert_allclose(fa, fr, rtol=1e-4,
                               atol=1e-5 * np.abs(fr).max())


def test_shape_mismatch_rejected(tmp_path, rng):
    path = str(tmp_path / 'synth.caffemodel')
    caffemodel.write_caffemodel(path, _synth_layers(rng), v1=True)
    wrong = VGG16PriorSource(image_h=64, image_w=64, width_div=4,
                             fc_features=64, device='cpu')
    with pytest.raises(ValueError, match='width_div'):
        caffemodel.load_caffemodel_into(wrong, path)


def test_missing_layer_rejected(tmp_path, rng):
    path = str(tmp_path / 'partial.caffemodel')
    caffemodel.write_caffemodel(path, _synth_layers(rng)[:-1], v1=True)
    with pytest.raises(KeyError):
        caffemodel.caffemodel_to_vgg16_params(
            caffemodel.read_caffemodel(path), fc_features=64)


def test_not_a_caffemodel_rejected(tmp_path):
    path = tmp_path / 'junk.caffemodel'
    path.write_bytes(b'\x00' * 64)
    with pytest.raises(ValueError):
        caffemodel.read_caffemodel(str(path))
