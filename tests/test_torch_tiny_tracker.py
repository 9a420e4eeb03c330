"""Port parity of `models/tiny_tracker.py::TinyTracker` and its weight
conversion against the flax module on the CPU.

Small size: LSTM-16, T=3, B=2, 6 feature channels. Weights come from
`TinyTracker.init` in JAX and are carried by `convert.from_flax`. Forward
tolerance rtol 1e-5, atol 1e-6 (both sides float32; the LSTM adds its
bias on the other side of the sum, measured <= 1.2e-7).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.models import TinyTracker as JTiny
from object_tracking_tpu_torch.convert import (from_flax,
                                               load_flax_train_state,
                                               params_from_flax)
from object_tracking_tpu_torch.models import TinyTracker
from object_tracking_tpu_torch.models.darknet19 import init_like_flax
from object_tracking_tpu_torch.training import TrainState, make_optimizer
from torch_parity import numpy_tree

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
H = 16

# (pool, feature (h, w), out_dim, residual): both pools, the bbox head,
# the heatmap head (8² outputs) and the residual head
CASES = [('Global', (5, 5), 4, False), ('Max', (8, 8), 4, False),
         ('Global', (4, 4), 64, False), ('Max', (9, 6), 64, False),
         ('Global', (4, 4), 4, True)]


def inputs(seed, hw, out, b=2, t=3, c=6):
    rng = np.random.RandomState(seed)
    feats = rng.rand(b, t, *hw, c).astype(np.float32)
    det = rng.rand(b, t, out).astype(np.float32)
    return feats, det


def jax_variables(pool, hw, out, residual, seed=1, c=6):
    model = JTiny(lstm_units=H, out_dim=out, pool=pool, residual_det=residual)
    feats, det = inputs(0, hw, out, c=c)
    variables = flax.core.unfreeze(numpy_tree(dict(
        model.init(jax.random.PRNGKey(seed), feats, det))))
    if residual:
        # the zero-initialised correction would hide the output layer's
        # conversion: give it weights
        rng = np.random.RandomState(seed)
        variables['params']['output']['kernel'] = (
            rng.randn(H, out) * 0.3).astype(np.float32)
    return model, variables


def port(pool, hw, out, residual, variables, c=6, **kw):
    model = TinyTracker((*hw, c), lstm_units=H, out_dim=out, pool=pool,
                        residual_det=residual, **kw)
    model.load_state_dict(from_flax(variables), strict=True)
    return model


@pytest.mark.parametrize('pool,hw,out,residual', CASES)
def test_forward_matches_flax(pool, hw, out, residual):
    model, variables = jax_variables(pool, hw, out, residual)
    feats, det = inputs(2, hw, out)
    if residual:
        det[0, 1] = 0.0                            # a missed detection
    want = np.asarray(model.apply(variables, feats, det))
    got = port(pool, hw, out, residual, variables)(
        torch.from_numpy(feats), torch.from_numpy(det))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)


def numpy_lstm(cell, x):
    """flax OptimizedLSTMCell's equations gate by gate, in numpy, from a
    zero carry: the converter must stack exactly these kernels."""
    def dense(name, v):
        return v @ cell[name]['kernel'] + cell[name].get('bias', 0.0)
    b, t, _ = x.shape
    h = np.zeros((b, H), np.float64)
    c = np.zeros((b, H), np.float64)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))      # noqa: E731
    out = []
    for s in range(t):
        i = sig(dense('ii', x[:, s]) + dense('hi', h))
        f = sig(dense('if', x[:, s]) + dense('hf', h))
        g = np.tanh(dense('ig', x[:, s]) + dense('hg', h))
        o = sig(dense('io', x[:, s]) + dense('ho', h))
        c = f * c + i * g
        h = o * np.tanh(c)
        out.append(h)
    return np.stack(out, 1)


def test_lstm_gate_order_and_single_bias():
    """Pin: weight_ih / weight_hh stack the gates (i, f, g, o), transposed,
    and the one bias is the recurrent projections'. Random biases per
    gate make a swapped gate or a dropped bias visible."""
    _, variables = jax_variables('Global', (4, 4), 4, False)
    cell = variables['params']['OptimizedLSTMCell_0']
    rng = np.random.RandomState(5)
    for gate in ('hi', 'hf', 'hg', 'ho'):
        cell[gate]['bias'] = rng.randn(H).astype(np.float32)
    state = from_flax(variables)
    np.testing.assert_array_equal(state['lstm.weight_ih'][H:2 * H].numpy(),
                                  cell['if']['kernel'].T)
    np.testing.assert_array_equal(state['lstm.bias'][2 * H:3 * H].numpy(),
                                  cell['hg']['bias'])
    model = TinyTracker((4, 4, 6), lstm_units=H, out_dim=4)
    model.load_state_dict(state, strict=True)
    x = rng.rand(2, 3, 10).astype(np.float32)
    got = model.lstm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, numpy_lstm(cell, x.astype(np.float64)),
                               rtol=1e-5, atol=1e-6)


def test_max_pool_flattens_nhwc():
    """Pin: 'Max' flattens the pooled map as (h, w, c). A feature volume
    that differs per position and channel makes an NCHW flatten feed the
    LSTM's input kernel the wrong rows."""
    model, variables = jax_variables('Max', (8, 8), 4, False, c=3)
    rng = np.random.RandomState(9)
    feats = rng.rand(1, 3, 8, 8, 3).astype(np.float32) * np.arange(
        1, 4, dtype=np.float32)
    det = rng.rand(1, 3, 4).astype(np.float32)
    net = port('Max', (8, 8), 4, False, variables, c=3)
    want = np.asarray(model.apply(variables, feats, det))
    np.testing.assert_allclose(net(torch.from_numpy(feats),
                                   torch.from_numpy(det)).detach().numpy(),
                               want, **FWD_TOL)
    # an NCHW flatten of the same pooled map gives another output
    pooled = torch.from_numpy(feats).reshape(3, 8, 8, 3).permute(0, 3, 1, 2)
    nchw = torch.nn.functional.max_pool2d(pooled, 4, 4).reshape(1, 3, -1)
    x = torch.cat([nchw, torch.from_numpy(det)], dim=-1)
    wrong = torch.sigmoid(torch.nn.functional.linear(
        net.lstm(x), net.output.weight, net.output.bias))
    assert not np.allclose(wrong.detach().numpy(), want, atol=1e-3)


def test_residual_head_echo_at_init_and_gate():
    """The zero-initialised correction echoes the detection at init; an
    all-zero frame routes to the fill-in head, strictly inside (0, 1)."""
    torch.manual_seed(0)
    net = init_like_flax(TinyTracker((4, 4, 8), lstm_units=8, out_dim=4,
                                     residual_det=True), 0)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.rand(1, 4, 4, 4, 8).astype(np.float32))
    det = rng.rand(1, 4, 4).astype(np.float32)
    det[0, 2] = 0.0
    out = net(feats, torch.from_numpy(det)).detach().numpy()
    for t in (0, 1, 3):
        np.testing.assert_allclose(out[0, t], det[0, t], rtol=0, atol=1e-6)
    assert np.all(out[0, 2] > 0.0) and np.all(out[0, 2] < 1.0)


def test_residual_gate_exact_zero_under_bfloat16():
    """Pin: the gate reads the float32 detection, never the compute-type
    copy. A detection of 1e-44 (a float32 subnormal below bfloat16's
    smallest) rounds to 0 in bfloat16 but is present in float32; an exact
    zero is a miss in both."""
    net = init_like_flax(TinyTracker((2, 2, 4), lstm_units=8, out_dim=4,
                                     residual_det=True,
                                     dtype=torch.bfloat16), 0)
    det = torch.zeros(1, 2, 4)
    det[0, 0, 0] = 1e-44
    feats = torch.rand(1, 2, 2, 2, 4)
    out = net(feats, det)
    assert out.dtype == torch.float32
    # frame 0 present: the echo (plus a zero correction); frame 1 missed
    torch.testing.assert_close(out[0, 0], det[0, 0], rtol=0, atol=1e-6)
    assert bool((out[0, 1] > 0).all() and (out[0, 1] < 1).all())
    assert det.to(torch.bfloat16)[0, 0].abs().sum() == 0


def test_bfloat16_close_to_float32():
    _, variables = jax_variables('Global', (4, 4), 4, False)
    feats, det = (torch.from_numpy(a) for a in inputs(3, (4, 4), 4))
    f32 = port('Global', (4, 4), 4, False, variables)(feats, det)
    bf16 = port('Global', (4, 4), 4, False, variables,
                dtype=torch.bfloat16)(feats, det)
    assert bf16.dtype == torch.float32
    torch.testing.assert_close(bf16, f32, rtol=0, atol=2e-2)


def test_init_like_flax():
    """flax's initialisers: lecun_normal input and dense kernels,
    orthogonal recurrent kernel per gate, zero biases, zero residual
    correction; the same seed gives the same weights."""
    net = init_like_flax(TinyTracker((4, 4, 64), lstm_units=32, out_dim=4,
                                     residual_det=True), 3)
    w_ih = net.lstm.weight_ih.detach()
    fan_in = w_ih.shape[1]
    assert abs(float(w_ih.std()) * fan_in ** 0.5 - 1.0) < 0.05
    assert float(w_ih.abs().max()) <= 2.0 / 0.8796256 / fan_in ** 0.5
    for gate in net.lstm.weight_hh.detach().chunk(4, dim=0):
        torch.testing.assert_close(gate @ gate.T, torch.eye(32), atol=1e-5,
                                   rtol=0)
    assert not net.lstm.bias.any() and not net.fill.bias.any()
    assert not net.output.weight.any() and not net.output.bias.any()
    fill_std = float(net.fill.weight.detach().std())
    assert fill_std * 32 ** 0.5 == pytest.approx(1.0, abs=0.2)
    again = init_like_flax(TinyTracker((4, 4, 64), lstm_units=32, out_dim=4,
                                       residual_det=True), 3)
    assert torch.equal(again.lstm.weight_hh, net.lstm.weight_hh)


def test_converter_raises_on_unmapped_or_missing_gate():
    _, variables = jax_variables('Global', (4, 4), 4, False)
    bad = flax.core.unfreeze(variables)
    del bad['params']['OptimizedLSTMCell_0']['ho']
    with pytest.raises(KeyError, match='missing'):
        from_flax(bad)
    bad = flax.core.unfreeze(variables)
    bad['params']['OptimizedLSTMCell_0']['ii']['bias'] = np.zeros(H)
    with pytest.raises(KeyError, match='ii'):
        from_flax(bad)
    bad = flax.core.unfreeze(variables)
    bad['params']['output']['scale_factor'] = np.ones(4)
    with pytest.raises(KeyError, match='unused key'):
        from_flax(bad)


def test_dense_kernel_transposed():
    _, variables = jax_variables('Global', (4, 4), 64, False)
    state = from_flax(variables)
    kernel = variables['params']['output']['kernel']          # (16, 64)
    assert state['output.weight'].shape == (64, H)
    np.testing.assert_array_equal(state['output.weight'].numpy(), kernel.T)


def test_jax_train_state_resumes_in_the_port():
    """A JAX TinyTracker state after two Adam steps, as numpy, loads into
    the port's TrainState: parameters, step, learning rate and Adam's
    moments (stacked and transposed as their parameters)."""
    from object_tracking_tpu.training import TrainState as JState
    from object_tracking_tpu.training import make_optimizer as jopt
    from object_tracking_tpu.training import make_tiny_train_step as jstep
    model, variables = jax_variables('Global', (4, 4), 4, False)
    feats, det = inputs(4, (4, 4), 4)
    batch = {'feats': feats, 'det': det, 'target': (det > 0.5).astype(
        np.float32)}
    state = JState.create(model.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-3))
    step = jstep()
    for _ in range(2):
        state, _ = step(state, batch)
    adam = state.opt_state.inner_state[0]
    pieces = jax.tree_util.tree_map(np.asarray, {
        'step': state.step, 'params': state.params, 'count': adam.count,
        'mu': adam.mu, 'nu': adam.nu,
        'learning_rate': state.opt_state.hyperparams['learning_rate']})
    net = TinyTracker((4, 4, 6), lstm_units=H, out_dim=4)
    ported = load_flax_train_state(
        TrainState.create(net, make_optimizer(1e-2)), batch_stats={},
        **pieces)
    assert ported.step == 2 and ported.learning_rate == pytest.approx(1e-3)
    mu = params_from_flax(pieces['mu'])
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.detach(),
                                   params_from_flax(pieces['params'])[name])
        assert torch.equal(ported.optimizer.state[p]['exp_avg'], mu[name])
    assert set(mu) == {n for n, _ in net.named_parameters()}
