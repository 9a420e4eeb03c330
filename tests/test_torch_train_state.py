"""Port parity of the train state and optimizer (`training/state.py`)
against optax, on identical gradients.

Tolerance: 1e-6 (absolute, on parameters of order 1) for Adam, with and
without the global-norm clip, over several steps; the clip factor itself
to rtol 1e-6. Both sides run float32 with their own operation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from object_tracking_tpu.training import make_optimizer as jopt
from object_tracking_tpu_torch.training.state import (TrainState,
                                                      clip_by_global_norm_,
                                                      make_optimizer)


def grads_seq(rng, steps, scale):
    return [{'w': (rng.randn(3, 4) * scale).astype(np.float32),
             'b': (rng.randn(4) * scale).astype(np.float32)}
            for _ in range(steps)]


class _Pair(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize('clip,scale', [(None, 1.0), (None, 1e-6),
                                        (1.0, 1.0), (1.0, 0.01)])
def test_adam_on_identical_gradients_matches_optax(rng, clip, scale):
    """eps is Keras' 1e-7 (scale 1e-6 puts the gradients near it); with
    a clip of 1.0, scale 1 always clips and scale 0.01 never does."""
    params = {'w': rng.randn(3, 4).astype(np.float32),
              'b': rng.randn(4).astype(np.float32)}
    tx = jopt(1e-2, grad_clip_norm=clip)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    state = TrainState.create(_Pair(params['w'], params['b']),
                              make_optimizer(1e-2, grad_clip_norm=clip))
    assert state.optimizer.defaults['eps'] == 1e-7
    for g in grads_seq(rng, 5, scale):
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in state.model.named_parameters():
            p.grad = torch.from_numpy(g[name].copy())
        state.apply_gradients()
    assert state.step == 5
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize('max_norm', [0.5, 2.0, None])
def test_clip_by_global_norm_follows_optax(rng, max_norm):
    """Scaled by max/norm when norm >= max, untouched below (optax); at
    the boundary both branches give the gradients back."""
    g = grads_seq(rng, 1, 1.0)[0]
    norm = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                             for v in g.values())))
    max_norm = norm if max_norm is None else max_norm * norm
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        jax.tree_util.tree_map(jnp.asarray, g), optax.EmptyState())
    got = [torch.from_numpy(g[k].copy()) for k in ('w', 'b')]
    total = clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(float(total), norm, rtol=1e-6)
    for t, k in zip(got, ('w', 'b')):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=1e-7)


def test_learning_rate_roundtrip():
    state = TrainState.create(_Pair(np.ones((3, 4), np.float32),
                                    np.ones(4, np.float32)),
                              make_optimizer(1e-3))
    assert state.learning_rate == pytest.approx(1e-3)
    assert state.with_learning_rate(5e-4) is state
    assert state.learning_rate == pytest.approx(5e-4)
    assert set(state.params) == {'w', 'b'} and state.batch_stats == {}
