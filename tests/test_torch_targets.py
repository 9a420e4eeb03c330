"""Port parity of YOLO target encoding (`ops/targets.py`) against the JAX
encoder, on the cases of tests/test_targets_heatmap.py and more.

Tolerance: exact. The port encodes every frame at once (a scatter of the
last accepted object per target and per buffer slot), the JAX code loops
over objects; both compute each row with the same float32 operations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.ops.targets import encode_targets as jencode
from object_tracking_tpu.ops.targets import encode_targets_batch as jbatch
from object_tracking_tpu.ops.targets import (
    encode_targets_multiscale as jmultiscale)
from object_tracking_tpu_torch.ops.targets import (encode_targets,
                                                   encode_targets_batch,
                                                   encode_targets_multiscale)
from test_targets_heatmap import ANCHORS, random_objs, to_arrays


def both(boxes, cls, valid, **kw):
    ref = jencode(jnp.array(boxes), jnp.array(cls), jnp.array(valid),
                  jnp.array(ANCHORS), **kw)
    got = encode_targets(torch.from_numpy(boxes), torch.from_numpy(cls),
                         torch.from_numpy(valid), ANCHORS, **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def assert_same(ref, got):
    for r, g in zip(ref, got):
        assert r.shape == g.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize('n,buf', [(12, 50), (45, 50), (45, 16), (3, 1)])
def test_encode_matches_jax(n, buf):
    """Random objects; 45 in a 13x13 grid collide on cells and anchors, and
    a buffer shorter than the accepted objects wraps."""
    objs = random_objs(np.random.RandomState(n + buf), n)
    ref, got = both(*to_arrays(objs), num_classes=3, true_box_buffer=buf)
    assert_same(ref, got)


def test_collision_last_object_wins():
    """Two objects on one cell and anchor: the later one's row is written;
    the buffer holds both, in order."""
    objs = [(100, 100, 140, 150, 0), (102, 98, 141, 152, 2),
            (10, 10, 10, 50, 1)]                     # degenerate: skipped
    ref, got = both(*to_arrays(objs), num_classes=3)
    assert_same(ref, got)
    y, b = got
    hit = y[..., 4] == 1.0
    assert hit.sum() == 1 and y[hit][0, 5 + 2] == 1.0
    assert (b[0, 0, 0, :2, 2] > 0).all() and (b[0, 0, 0, 2:] == 0).all()


def test_encode_skips_degenerate_invalid_and_out_of_grid():
    objs = [(10, 10, 10, 50, 0),          # zero width
            (0, 0, 416, 416, 1),          # center on the grid edge: kept
            (410, 410, 500, 500, 2),      # center beyond the grid
            (-90, -90, -10, -10, 0),      # center before the grid
            (50, 50, 90, 90, 3),          # class out of range
            (60, 60, 100, 120, -1)]       # negative class
    boxes, cls, valid = to_arrays(objs)
    ref, got = both(boxes, cls, valid, num_classes=3)
    assert_same(ref, got)
    assert got[0][..., 4].sum() == 1.0
    boxes, cls, valid = to_arrays(objs)
    valid[:] = False                                  # padding only
    ref, got = both(boxes, cls, valid, num_classes=3)
    assert_same(ref, got)
    assert not got[0].any() and not got[1].any()


def test_encode_batch_over_leading_dims():
    rng = np.random.RandomState(5)
    frames = [to_arrays(random_objs(rng, k)) for k in (0, 5, 30, 50)]
    boxes, cls, valid = (np.stack(a) for a in zip(*frames))
    ref = jbatch(jnp.array(boxes), jnp.array(cls), jnp.array(valid),
                 jnp.array(ANCHORS), num_classes=3, true_box_buffer=20)
    got = encode_targets_batch(
        torch.from_numpy(boxes.reshape(2, 2, 50, 4)),
        torch.from_numpy(cls.reshape(2, 2, 50)),
        torch.from_numpy(valid.reshape(2, 2, 50)), ANCHORS,
        num_classes=3, true_box_buffer=20)
    assert got[0].shape == (2, 2, 13, 13, 5, 8)
    assert got[1].shape == (2, 2, 1, 1, 1, 20, 4)
    assert_same([np.asarray(r).reshape(g.shape) for r, g in zip(ref, got)],
                [g.numpy() for g in got])


def test_encode_targets_multiscale_matches_jax():
    heads = (((10.0, 13.0, 16.0, 30.0, 33.0, 23.0), 4, 4, 2),
             ((80.0, 80.0, 120.0, 100.0), 2, 2, 2))
    boxes = np.asarray([[10, 10, 26, 40], [4, 14, 122, 116],
                        [30, 30, 60, 50], [0, 0, 0, 0]], np.float32)
    cls = np.asarray([0, 1, 1, 0], np.int32)
    valid = np.asarray([True, True, True, False])
    ref_y, ref_b = jmultiscale(jnp.array(boxes), jnp.array(cls),
                               jnp.array(valid), heads, image_h=128,
                               image_w=128, true_box_buffer=4)
    y, b = encode_targets_multiscale(
        torch.from_numpy(boxes), torch.from_numpy(cls),
        torch.from_numpy(valid), heads, image_h=128, image_w=128,
        true_box_buffer=4)
    assert_same([np.asarray(a) for a in ref_y + ref_b],
                [a.numpy() for a in y + b])
    assert y[0][0, 0, 1, 4] == 1.0 and y[1][1, 0, 1, 4] == 1.0
