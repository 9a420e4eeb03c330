"""Port parity: VGG16 and VGG16PriorSource vs the JAX package.

Width-divided VGG16 (width_div=8, fc 32, a 2-class dense head, 64x64
input), float32, on the flax module's own variables converted with
`convert.from_flax`: conv5_3, pool5, fc7 and det_netout to rtol 1e-4,
atol 1e-5. Decoded detections: same labels, scores and boxes to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.models import VGG16PriorSource as JSource
from object_tracking_tpu.models.vgg16 import VGG16 as JVGG16
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.models import VGG16, VGG16PriorSource

TOL = dict(rtol=1e-4, atol=1e-5)
DEC_TOL = dict(rtol=0, atol=1e-5)


class OneBoxDelegate:
    """A prior source emitting one valid centred box per image."""

    def forward_batch(self, images, top_k=16):
        n = len(images)
        boxes = np.zeros((n, top_k, 4), np.float32)
        boxes[:, 0] = (0.5, 0.5, 0.2, 0.2)
        valid = np.zeros((n, top_k), bool)
        valid[:, 0] = True
        return (np.zeros((n, 1, 1, 4), np.float32), boxes,
                np.zeros((n, top_k), np.int32),
                valid.astype(np.float32), valid)


def test_vgg16_matches_flax(rng):
    jmodel = JVGG16(fc_features=32, det_classes=2, width_div=8)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = jmodel.apply(variables, jnp.asarray(x))
    model = VGG16(fc_features=32, det_classes=2, width_div=8)
    model.load_state_dict(from_flax(variables), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.keys() == ref.keys()
    for key in ref:
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   **TOL)
    assert out['det_netout'].shape == (2, 2, 2, 1, 7)


def test_layer_dims():
    src = VGG16PriorSource(image_h=64, image_w=64, width_div=8,
                           fc_features=32, device='cpu')
    ref = JSource(image_h=64, image_w=64, width_div=8, fc_features=32)
    for layer in ('conv5_3', 'pool5', 'fc7'):
        assert src.get_layer_dims(layer) == ref.get_layer_dims(layer)
    assert src.get_layer_dims('pool5') == (2, 2, 64)
    with pytest.raises(KeyError):
        src.get_layer_dims('nope')


@pytest.mark.parametrize('layer', ['conv5_3', 'pool5', 'fc7'])
def test_forward_batch_with_delegate(rng, layer):
    src = VGG16PriorSource(image_h=64, image_w=64, width_div=8,
                           fc_features=32, device='cpu',
                           detection_delegate=OneBoxDelegate())
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    feats, boxes, labels, scores, valid = src.forward_batch(
        images, layer=layer, top_k=8)
    assert feats.shape == (2,) + src.get_layer_dims(layer)
    assert boxes.shape == (2, 8, 4) and valid[:, 0].all()
    assert np.isfinite(feats).all()


def test_no_delegate_gives_empty_boxes(rng):
    src = VGG16PriorSource(image_h=32, image_w=32, width_div=8,
                           fc_features=32, device='cpu')
    _, boxes, _, _, valid = src.forward_batch(
        rng.rand(1, 32, 32, 3).astype(np.float32), layer='pool5')
    assert not valid.any() and (boxes == 0).all()


def test_npz_weight_roundtrip(tmp_path, rng):
    src = VGG16PriorSource(image_h=32, image_w=32, width_div=8,
                           fc_features=32, det_labels=('a',), device='cpu')
    kern = rng.randn(3, 3, 3, 8).astype(np.float32) * 0.01
    bias = rng.randn(8).astype(np.float32)
    head = rng.randn(1, 1, 64, 6).astype(np.float32) * 0.01
    path = tmp_path / 'w.npz'
    np.savez(path, **{'conv1_1/kernel': kern, 'conv1_1/bias': bias,
                      'det_head/kernel': head})
    src.load_npz_weights(str(path))
    np.testing.assert_array_equal(
        src.module.conv1_1.weight.detach().numpy(), kern.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(src.module.conv1_1.bias.detach().numpy(),
                                  bias)
    np.testing.assert_array_equal(
        src.module.det_head.weight.detach().numpy(),
        head.transpose(3, 2, 0, 1))
    np.savez(path, **{'conv9_9/kernel': kern})
    with pytest.raises(KeyError):
        src.load_npz_weights(str(path))


def _headed(bias):
    """Dense head with a zero kernel: `bias` fires in every cell."""
    kwargs = dict(image_h=64, image_w=64, det_labels=('a', 'b'),
                  conf_threshold=0.8, nms_threshold=0.3, width_div=8,
                  fc_features=128)
    src = VGG16PriorSource(device='cpu', **kwargs)
    ref = JSource(**kwargs)
    params = {'det_head/kernel': np.zeros((1, 1, 64, 7), np.float32),
              'det_head/bias': np.asarray(bias, np.float32)}
    src.load_params(params)
    variables = jax.tree_util.tree_map(np.asarray,
                                       ref.variables['params'])
    variables['det_head'] = {'kernel': params['det_head/kernel'],
                             'bias': params['det_head/bias']}
    src.load_params({f'{name}/{leaf}': value
                     for name, leaves in variables.items()
                     for leaf, value in leaves.items()})
    ref.variables = {'params': variables}
    return src, ref


def test_det_head_per_class_detections_like_jax(rng):
    # bias fires class 'b' with high confidence in every cell; per-class
    # NMS at 0.3 collapses the overlapping cell boxes
    src, ref = _headed([0, 0, 0, 0, 10.0, -5.0, 5.0])
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    out = src.forward_batch(images, layer='fc7', top_k=8)
    jout = ref.forward_batch(images, layer='fc7', top_k=8)
    feats, boxes, labels, scores, valid = out
    assert valid.any() and (labels[valid] == 1).all()
    assert (scores[valid] > 0.9).all() and feats.shape == (2, 1, 1, 128)
    np.testing.assert_allclose(feats, jout[0], **TOL)
    for o, r in zip(out[1:], jout[1:]):
        np.testing.assert_allclose(o, r, **DEC_TOL)


def test_det_head_below_conf_threshold_is_empty(rng):
    # conf logit 0 → sigmoid = 0.5 < CONF_THRESH 0.8
    src, _ = _headed([0, 0, 0, 0, 0.0, -5.0, 5.0])
    _, _, _, _, valid = src.forward_batch(
        rng.rand(1, 64, 64, 3).astype(np.float32), layer='fc7', top_k=8)
    assert not valid.any()


def test_det_head_extract_spatio_info_like_jax(tmp_path, rng):
    import cv2
    src, ref = _headed([0, 0, 0, 0, 10.0, 5.0, -5.0])
    path = str(tmp_path / 'img.jpg')
    cv2.imwrite(path, rng.randint(0, 255, (64, 64, 3)).astype(np.uint8))
    named, feats = src.extract_spatio_info(path, layer='fc7')
    jnamed, jfeats = ref.extract_spatio_info(path, layer='fc7')
    assert named and named[0][0] == 'a' and feats.shape == (1, 1, 128)
    assert [d[0] for d in named] == [d[0] for d in jnamed]
    np.testing.assert_allclose([d[1] for d in named],
                               [d[1] for d in jnamed], **DEC_TOL)
    np.testing.assert_allclose(feats, jfeats, **TOL)
    # class_filter drops non-matching classes
    named_f, _ = src.extract_spatio_info(path, class_filter=('b',))
    assert named_f == [] and src.detect(path, class_filter=('b',)) == []
