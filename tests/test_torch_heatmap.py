"""Port parity of the heatmap codec (`ops/heatmap.py`) against the JAX
functions on the CPU: encode and decode agree exactly (they are
comparisons of truncated float32 products), including negative top-left
corners, where truncation toward zero differs from floor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.ops.heatmap import heatmap_decode_rect as jdecode
from object_tracking_tpu.ops.heatmap import heatmap_encode as jencode
from object_tracking_tpu_torch.ops.heatmap import (heatmap_decode_rect,
                                                   heatmap_encode)


def boxes(seed, n, lo=0.0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(lo, 0.8, n).astype(np.float32),
            rng.uniform(lo, 0.8, n).astype(np.float32),
            rng.uniform(0.0, 0.5, n).astype(np.float32),
            rng.uniform(0.0, 0.5, n).astype(np.float32))


@pytest.mark.parametrize('size', [8, 13, 32])
def test_encode_matches_jax(size):
    for x, y, w, h in zip(*boxes(size, 40)):
        want = np.asarray(jencode(x, y, w, h, hmap_size=size))
        got = heatmap_encode(x, y, w, h, hmap_size=size).numpy()
        np.testing.assert_array_equal(got, want)


def test_encode_negative_corner_truncates_toward_zero():
    """cx − w/2 < 0: trunc(−0.3·8) = −2 (floor would give −3), so the
    block spans columns 0..trunc(w·8)−2 and matches JAX's."""
    x, y, w, h = -0.3, -0.05, 0.5, 0.25
    got = heatmap_encode(x, y, w, h, hmap_size=8).reshape(8, 8)
    want = np.asarray(jencode(x, y, w, h, hmap_size=8)).reshape(8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # columns trunc(−2.4) = −2 .. −2 + trunc(4.0) = 2, clamped at 0;
    # floor would start at −3 and end at column 1
    assert got[0].nonzero().flatten().tolist() == [0, 1, 2]
    assert got[:, 0].nonzero().flatten().tolist() == [0, 1, 2]


def test_encode_batched_matches_jax_per_element():
    x, y, w, h = (a.reshape(2, 3, 5) for a in boxes(7, 30, lo=-0.2))
    got = heatmap_encode(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(w), torch.from_numpy(h),
                         hmap_size=8)
    assert got.shape == (2, 3, 5, 64) and got.dtype == torch.float32
    for idx in np.ndindex(2, 3, 5):
        want = np.asarray(jencode(x[idx], y[idx], w[idx], h[idx],
                                  hmap_size=8))
        np.testing.assert_array_equal(got[idx].numpy(), want)


@pytest.mark.parametrize('thresh', [0.5, 0.75])
def test_decode_matches_jax(thresh):
    rng = np.random.RandomState(3)
    for _ in range(20):
        heat = (rng.rand(64) * rng.rand()).astype(np.float32)
        want = [int(v) for v in jdecode(jnp.asarray(heat), thresh, 8)]
        got = [int(v) for v in heatmap_decode_rect(torch.from_numpy(heat),
                                                   thresh, 8)]
        assert got == want


def test_roundtrip_inclusive_block():
    heat = heatmap_encode(0.25, 0.5, 0.25, 0.125, hmap_size=32)
    x1, y1, x2, y2 = heatmap_decode_rect(heat, 0.75, 32)
    assert (int(x1), int(y1), int(x2), int(y2)) == (8, 16, 16, 20)


def test_empty_sentinel():
    x1, y1, x2, y2 = heatmap_decode_rect(torch.zeros(32 * 32), 0.75, 32)
    assert (int(x1), int(y1), int(x2), int(y2)) == (32, 32, -1, -1)
    assert x1.dtype == torch.int32


def test_decode_batched():
    heats = torch.stack([heatmap_encode(0.1, 0.2, 0.3, 0.2, 8),
                         torch.zeros(64)])
    x1, y1, x2, y2 = heatmap_decode_rect(heats, 0.5, 8)
    assert x1.tolist() == [0, 8] and y2.tolist() == [2, -1]
