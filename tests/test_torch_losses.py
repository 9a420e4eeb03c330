"""Port parity of the losses (`models/losses.py`) against the JAX losses,
on the cases of tests/test_loss.py.

Tolerances: `yolo_loss` and each aux term rtol 1e-5 (atol 1e-7 for terms
that are 0), its gradient w.r.t. the predictions rtol 1e-5 of the largest
element; BCE and `heatmap_accuracy` rtol 1e-6. Both sides run the same
float32 operations; sums are taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.models.losses import (binary_crossentropy as jbce,
                                               heatmap_accuracy as jacc,
                                               yolo_loss as jloss)
from object_tracking_tpu_torch.models.losses import (binary_crossentropy,
                                                     heatmap_accuracy,
                                                     yolo_loss)
from test_loss import ANCHORS, make_case

KEYS = ('loss', 'loss_xy', 'loss_wh', 'loss_conf', 'loss_class', 'recall')


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('step,warm_up', [(1_000_000, 0), (0, 10),
                                          (10, 10), (9, 10)])
def test_yolo_loss_and_aux_match_jax(rng, step, warm_up):
    """With and without the warm-up branch (it holds while step <
    warm_up_batches)."""
    y_pred, y_true, tboxes = make_case(rng)
    ref, ref_aux = jloss(jnp.array(y_pred), jnp.array(y_true),
                         jnp.array(tboxes), jnp.array(ANCHORS), step,
                         warm_up_batches=warm_up)
    got, aux = yolo_loss(t(y_pred), t(y_true), t(tboxes), ANCHORS, step,
                         warm_up_batches=warm_up)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_yolo_loss_gradient_matches_jax(rng):
    y_pred, y_true, tboxes = make_case(rng, b=1, nobj=3)
    ref = np.asarray(jax.grad(lambda p: jloss(
        p, jnp.array(y_true), jnp.array(tboxes), jnp.array(ANCHORS))[0])(
        jnp.array(y_pred)))
    x = t(y_pred).requires_grad_()
    yolo_loss(x, t(y_true), t(tboxes), ANCHORS)[0].backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_yolo_loss_options_match_jax(rng):
    """Loss scales, the IoU threshold and class weights; an all-zero class
    row takes class 0, as jnp.argmax does."""
    y_pred, y_true, tboxes = make_case(rng, nc=3)
    y_true[0, 0, 0, 0, 4] = 1.0                 # objectness, no class set
    y_true[0, 0, 0, 0, 5:] = 0.0
    kw = dict(object_scale=3.0, no_object_scale=0.5, coord_scale=2.0,
              class_scale=1.5, best_iou_threshold=0.4)
    weights = np.asarray([0.5, 2.0, 1.0], np.float32)
    ref, ref_aux = jloss(jnp.array(y_pred), jnp.array(y_true),
                         jnp.array(tboxes), jnp.array(ANCHORS),
                         class_weights=jnp.array(weights), **kw)
    got, aux = yolo_loss(t(y_pred), t(y_true), t(tboxes), ANCHORS,
                         class_weights=t(weights), **kw)
    for k in KEYS:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_yolo_loss_is_float32_under_bfloat16(rng):
    y_pred, y_true, tboxes = make_case(rng)
    got, aux = yolo_loss(t(y_pred).to(torch.bfloat16), t(y_true),
                         t(tboxes), ANCHORS)
    assert got.dtype == torch.float32 and torch.isfinite(got)
    assert all(v.dtype == torch.float32 for v in aux.values())


def test_loss_hand_computed_micro_case():
    """1x1 grid, 1 anchor, 2 classes; prediction exactly on target."""
    y_pred = np.zeros((1, 1, 1, 1, 7), np.float32)
    y_pred[..., 4] = 100.0
    y_pred[..., 5] = 100.0
    y_true = np.zeros((1, 1, 1, 1, 7), np.float32)
    y_true[..., 0:4] = [0.5, 0.5, 2.0, 2.0]
    y_true[..., 4:6] = 1.0
    tboxes = np.zeros((1, 1, 1, 1, 50, 4), np.float32)
    tboxes[..., 0, :] = [0.5, 0.5, 2.0, 2.0]
    loss, aux = yolo_loss(t(y_pred), t(y_true), t(tboxes),
                          np.array([2.0, 2.0], np.float32))
    assert float(loss) < 1e-4
    assert float(aux['recall']) > 0.999


def test_bce_and_heatmap_accuracy_match_jax(rng):
    p = rng.uniform(0.0, 1.0, (4, 8)).astype(np.float32)
    p[0, :2] = (0.0, 1.0)                       # clipped at eps
    target = (rng.rand(4, 8) > 0.5).astype(np.float32)
    np.testing.assert_allclose(float(binary_crossentropy(t(p), t(target))),
                               float(jbce(jnp.array(p), jnp.array(target))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(heatmap_accuracy(t(p), t(target))),
                               float(jacc(jnp.array(p), jnp.array(target))),
                               rtol=1e-6)
