"""Port parity of augmentation (`data/augment.py`) against the JAX
augmentation.

JAX's PRNG cannot be matched bit for bit, so the test draws the parameters
with `jax.random` exactly as `object_tracking_tpu/data/augment.py`
(`augment_frame`) draws them from a key, hands them to the port's
deterministic body `apply_params`, and compares with the JAX
`augment_sequence(key, ...)` of the same key: one parameter set shared by
the window's frames.

Tolerances: images atol 1e-5 (the resampling matmuls and the blur sum in
another order); boxes exact against JAX run op by op (under jit, XLA may
fuse x·scale − offset into one rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.data.augment import AugmentConfig as JConfig
from object_tracking_tpu.data.augment import augment_sequence as jaugment
from object_tracking_tpu_torch.data.augment import (AugmentConfig,
                                                    apply_params,
                                                    augment_frame,
                                                    augment_sequence,
                                                    augment_sequences_batch,
                                                    draw_params)

H, W, T_LEN, M = 24, 32, 3, 6
PROBS = ('flip_prob', 'blur_prob', 'noise_prob', 'dropout_prob',
         'brightness_prob', 'multiply_prob', 'contrast_prob')
CONFIGS = {'default': {}, 'all_on': {p: 1.0 for p in PROBS},
           'all_off': {p: 0.0 for p in PROBS}}


def jax_params(key, cfg, h=H, w=W):
    """The parameters augment_frame draws from `key`, in its order."""
    k_scale, k_offx, k_offy, k_flip, k_photo = jax.random.split(key, 5)
    scale = jax.random.uniform(k_scale, (), minval=1.0,
                               maxval=cfg.scale_max)
    ks = jax.random.split(k_photo, 12)

    def u(i):
        return jax.random.uniform(ks[i], ())

    out = {
        'scale': scale,
        'offx': jax.random.uniform(k_offx, ()) * ((scale - 1.0) * w),
        'offy': jax.random.uniform(k_offy, ()) * ((scale - 1.0) * h),
        'flip': jax.random.uniform(k_flip, ()) < cfg.flip_prob,
        'blur': u(0) < cfg.blur_prob,
        'noise': jax.random.normal(ks[1], (h, w, 3)),
        'noise_on': u(2) < cfg.noise_prob,
        'keep': jax.random.uniform(ks[3], (h, w, 1)) > cfg.dropout_rate,
        'drop_on': u(4) < cfg.dropout_prob,
        'delta': jax.random.uniform(ks[5], (), minval=-cfg.brightness_delta,
                                    maxval=cfg.brightness_delta),
        'bright_on': u(6) < cfg.brightness_prob,
        'mul': jax.random.uniform(ks[7], (), minval=cfg.multiply_range[0],
                                  maxval=cfg.multiply_range[1]),
        'mul_on': u(8) < cfg.multiply_prob,
        'alpha': jax.random.uniform(ks[9], (), minval=cfg.contrast_range[0],
                                    maxval=cfg.contrast_range[1]),
        'contrast_on': u(10) < cfg.contrast_prob}
    return {k: torch.from_numpy(np.array(v))[None] for k, v in out.items()}


def window(rng):
    images = rng.rand(T_LEN, H, W, 3).astype(np.float32)
    x1 = rng.uniform(0, W - 8, (T_LEN, M))
    y1 = rng.uniform(0, H - 8, (T_LEN, M))
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 12, (T_LEN, M)),
                      y1 + rng.uniform(2, 12, (T_LEN, M))],
                     -1).astype(np.float32)
    return images, boxes


@pytest.mark.parametrize('name', list(CONFIGS))
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_body_on_jax_drawn_params_matches_jax(rng, name, seed):
    kw = CONFIGS[name]
    jcfg, cfg = JConfig(**kw), AugmentConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    key = jax.random.PRNGKey(seed)
    images, boxes = window(rng)
    ref_img, _ = jaugment(key, jnp.array(images), jnp.array(boxes), jcfg)
    with jax.disable_jit():
        _, ref_boxes = jaugment(key, jnp.array(images), jnp.array(boxes),
                                jcfg)
    got_img, got_boxes = apply_params(
        torch.from_numpy(images)[None], torch.from_numpy(boxes)[None],
        jax_params(key, jcfg), cfg)
    np.testing.assert_allclose(got_img[0].numpy(), np.asarray(ref_img),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_boxes[0].numpy(),
                                  np.asarray(ref_boxes))


def test_draw_params_ranges_and_window_coherence():
    cfg = AugmentConfig()
    gens = [torch.Generator().manual_seed(s) for s in range(64)]
    p = draw_params(gens, H, W, cfg)
    assert p['noise'].shape == (64, H, W, 3) and p['keep'].shape == (
        64, H, W, 1)
    assert ((p['scale'] >= 1.0) & (p['scale'] <= cfg.scale_max)).all()
    assert ((p['offx'] >= 0) & (p['offx'] <= (p['scale'] - 1) * W)).all()
    assert ((p['mul'] >= 0.5) & (p['mul'] <= 1.5)).all()
    assert 0 < int(p['flip'].sum()) < 64 and 0 < int(p['blur'].sum()) < 64
    # one parameter set per window: every frame moves the same way
    rng = np.random.RandomState(0)
    images, boxes = window(rng)
    same = np.repeat(images[:1], T_LEN, 0)
    out, _ = augment_sequence(7, torch.from_numpy(same),
                              torch.from_numpy(boxes))
    for t in range(1, T_LEN):
        torch.testing.assert_close(out[t], out[0], rtol=0, atol=0)


def test_seeds_decide_the_draws():
    rng = np.random.RandomState(1)
    images, boxes = window(rng)
    batch = (torch.from_numpy(np.stack([images, images])),
             torch.from_numpy(np.stack([boxes, boxes])))
    a = augment_sequences_batch([3, 4], *batch)
    b = augment_sequences_batch([3, 4], *batch)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0][0], a[0][1])
    frame, fboxes = augment_frame(3, batch[0][0, 0], batch[1][0, 0])
    assert frame.shape == (H, W, 3) and fboxes.shape == (M, 4)
    assert float(frame.min()) >= 0.0 and float(frame.max()) <= 1.0
