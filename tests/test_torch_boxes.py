"""Port parity: object_tracking_tpu_torch.ops.boxes vs the JAX ops/boxes.py.

Same float32 inputs (seeded numpy) through both; tolerance atol=1e-6
(the operation order is the same, so differences are at most rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.ops import boxes as jbox
from object_tracking_tpu_torch.ops import boxes as tbox

ATOL = 1e-6


def _center_boxes(rng, n):
    return np.stack([rng.uniform(0.1, 0.9, n), rng.uniform(0.1, 0.9, n),
                     rng.uniform(0.01, 0.5, n),
                     rng.uniform(0.01, 0.5, n)], -1).astype(np.float32)


def _check(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('name', ['cxcywh_to_xyxy', 'xyxy_to_cxcywh'])
def test_format_conversions(rng, name):
    b = _center_boxes(rng, 24).reshape(2, 12, 4)
    _check(getattr(tbox, name)(torch.from_numpy(b)),
           getattr(jbox, name)(jnp.asarray(b)))


def test_interval_overlap(rng):
    a = rng.uniform(0, 1, (4, 16)).astype(np.float32)
    args = [np.minimum(a[0], a[1]), np.maximum(a[0], a[1]),
            np.minimum(a[2], a[3]), np.maximum(a[2], a[3])]
    _check(tbox.interval_overlap(*map(torch.from_numpy, args)),
           jbox.interval_overlap(*map(jnp.asarray, args)))


def test_iou_center_broadcasts(rng):
    a = _center_boxes(rng, 10).reshape(10, 1, 4)
    b = _center_boxes(rng, 7).reshape(1, 7, 4)
    _check(tbox.iou_center(torch.from_numpy(a), torch.from_numpy(b)),
           jbox.iou_center(jnp.asarray(a), jnp.asarray(b)))


def test_iou_corner(rng):
    a = jbox.cxcywh_to_xyxy(jnp.asarray(_center_boxes(rng, 9)))
    b = jbox.cxcywh_to_xyxy(jnp.asarray(_center_boxes(rng, 9)))
    a, b = np.array(a), np.array(b)
    _check(tbox.iou_corner(torch.from_numpy(a), torch.from_numpy(b)),
           jbox.iou_corner(jnp.asarray(a), jnp.asarray(b)))


def test_pairwise_iou_center_and_batched(rng):
    a, b = _center_boxes(rng, 12), _center_boxes(rng, 5)
    ref = jbox.pairwise_iou_center(jnp.asarray(a), jnp.asarray(b))
    _check(tbox.pairwise_iou_center(torch.from_numpy(a), torch.from_numpy(b)),
           ref)
    # the port also takes a leading batch dim: each slice is the 2-d result
    batched = tbox.pairwise_iou_center(torch.from_numpy(np.stack([a, a])),
                                       torch.from_numpy(np.stack([b, b])))
    _check(batched[1], ref)


def test_iou_center_eps_on_degenerate_boxes():
    z = np.zeros((1, 4), np.float32)
    _check(tbox.iou_center(torch.from_numpy(z), torch.from_numpy(z)),
           jbox.iou_center(jnp.asarray(z), jnp.asarray(z)))
    assert tbox.EPS == jbox.EPS == 1e-10
