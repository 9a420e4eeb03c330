"""Port parity: StackedConvLSTM (sequential mode) vs flax.

The dense cases of tests/test_convlstm.py, on the stacked layers: JAX's
`StackedConvLSTM` initialised with flax, its weights carried by
`convert.from_flax`, the same numpy inputs (from a seed) on both sides.

Tolerances: outputs and states rtol 1e-4, atol 1e-5 (float32; the port
projects each layer's inputs for all T steps at once, JAX inside its
scan, which differs only by rounding); gradients per-leaf relative L2
<= 1e-4 against `jax.grad`; the init and the converted bias exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.models.convlstm import StackedConvLSTM as JStacked
from object_tracking_tpu_torch.convert import from_flax, to_flax
from object_tracking_tpu_torch.models.convlstm import StackedConvLSTM
from torch_parity import numpy_tree

TOL = dict(rtol=1e-4, atol=1e-5)
F = 6


def _setup(rng, layers=2, b=2, t=3, h=4, w=4):
    jmodel = JStacked(features=F, num_layers=layers)
    x = rng.randn(b, t, h, w, F).astype(np.float32)          # B,T,H,W,F
    variables = numpy_tree(jmodel.init(jax.random.PRNGKey(1), x))
    model = StackedConvLSTM(F, layers)
    model.load_state_dict(from_flax(variables), strict=True)
    return jmodel, variables, model, x


def _nchw(x: np.ndarray) -> torch.Tensor:
    """(..., H, W, F) numpy → (..., F, H, W) torch."""
    return torch.from_numpy(np.moveaxis(x, -1, -3).copy())


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().numpy(), -3, -1)


@pytest.mark.parametrize('layers', [1, 2, 3])
def test_matches_jax_with_carried_state(rng, layers):
    jmodel, variables, model, x = _setup(rng, layers)
    c0 = rng.randn(layers, 2, 4, 4, F).astype(np.float32)
    h0 = rng.randn(layers, 2, 4, 4, F).astype(np.float32)
    ys, (c, h) = jmodel.apply(variables, x, initial_state=(c0, h0),
                              return_state=True)
    tys, (tc, th) = model(_nchw(x), initial_state=(_nchw(c0), _nchw(h0)),
                          return_state=True)
    assert tys.shape == (2, 3, F, 4, 4) and tc.shape == (layers, 2, F, 4, 4)
    np.testing.assert_allclose(_nhwc(tys), np.asarray(ys), **TOL)
    np.testing.assert_allclose(_nhwc(tc), np.asarray(c), **TOL)
    np.testing.assert_allclose(_nhwc(th), np.asarray(h), **TOL)


def test_output_shape_and_finite(rng):
    jmodel, variables, model, x = _setup(rng)
    y = model(_nchw(x))
    assert y.shape == (2, 3, F, 4, 4) and y.dtype == torch.float32
    assert torch.isfinite(y).all()
    assert np.asarray(jmodel.apply(variables, x)).shape == (2, 3, 4, 4, F)


def test_forget_bias_init(rng):
    """The port's own init is flax's: +1 on the forget gate [F:2F] of every
    layer, 0 elsewhere; the converted bias is JAX's exactly."""
    _, variables, model, _ = _setup(rng, layers=3)
    want = np.zeros((3, 4 * F), np.float32)
    want[:, F:2 * F] = 1.0
    np.testing.assert_array_equal(variables['params']['input_bias'], want)
    np.testing.assert_array_equal(StackedConvLSTM(F, 3).input_bias.detach()
                                  .numpy(), want)
    np.testing.assert_array_equal(model.input_bias.detach().numpy(), want)


def test_matches_per_step_reference(rng):
    """Replaying both layers step by step with JAX convs on the same
    parameters agrees with the port's layer-batched projection."""
    _, variables, model, x = _setup(rng, layers=2, b=1, t=4, h=3, w=3)
    y = _nhwc(model(_nchw(x)))
    params = variables['params']

    def conv(inp, kern):
        return np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(inp), jnp.asarray(kern), (1, 1), 'SAME',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC')))

    def sig(v):
        return 1 / (1 + np.exp(-v))

    seq = [x[:, s] for s in range(4)]
    for layer in range(2):
        wx = params['input_kernel'][layer]
        bx = params['input_bias'][layer]
        wh = params['recurrent_kernel'][layer]
        c_st = np.zeros((1, 3, 3, F), np.float32)
        h_st = np.zeros((1, 3, 3, F), np.float32)
        out = []
        for xt in seq:
            gates = conv(xt, wx) + bx + conv(h_st, wh)
            gi, gf, gg, go = np.split(gates, 4, axis=-1)
            c_st = sig(gf) * c_st + sig(gi) * np.tanh(gg)
            h_st = sig(go) * np.tanh(c_st)
            out.append(h_st)
        seq = out
    for step in range(4):
        np.testing.assert_allclose(y[:, step], seq[step], **TOL)


def test_state_carry_across_windows(rng):
    """Scanning 2T frames at once == two T-windows with carried state, and
    both equal JAX's full clip."""
    jmodel, variables, model, x = _setup(rng, layers=2, b=1, t=6, h=3,
                                         w=3)
    full = model(_nchw(x))
    y1, state = model(_nchw(x[:, :3]), return_state=True)
    y2 = model(_nchw(x[:, 3:]), initial_state=state)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), full, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_nhwc(full),
                               np.asarray(jmodel.apply(variables, x)), **TOL)


def test_gradients_match_jax(rng):
    jmodel, variables, model, x = _setup(rng, layers=2)

    def loss(params):
        return jnp.mean(jmodel.apply({'params': params}, x) ** 2)

    grads = from_flax({'params': numpy_tree(
        jax.grad(loss)(variables['params']))})
    torch.mean(model(_nchw(x)) ** 2).backward()
    for name, p in model.named_parameters():
        want = grads[name].double()
        assert float(want.abs().max()) > 0, name
        err = float((p.grad.double() - want).norm() / want.norm())
        assert err <= 1e-4, (name, err)


def test_channel_mismatch_raises(rng):
    model = StackedConvLSTM(F, 2)
    with pytest.raises(ValueError, match='homogeneous'):
        model(torch.zeros(1, 2, F + 1, 3, 3))
    with pytest.raises(ValueError, match='homogeneous'):
        JStacked(features=F, num_layers=2).init(
            jax.random.PRNGKey(0), np.zeros((1, 2, 3, 3, F + 1), np.float32))


@pytest.mark.parametrize('kernel', ['input_kernel', 'recurrent_kernel'])
def test_init_is_orthonormal_per_layer(kernel):
    """Each layer's kernel has orthonormal 4F output-channel vectors, as
    flax's orthogonal init makes its (kh·kw·F, 4F) columns."""
    torch.manual_seed(0)
    weight = getattr(StackedConvLSTM(F, 3), kernel).detach()
    assert weight.shape == (3, 4 * F, F, 3, 3)
    for layer in range(3):
        rows = weight[layer].reshape(4 * F, -1)
        torch.testing.assert_close(rows @ rows.T, torch.eye(4 * F),
                                   atol=1e-5, rtol=0)
    flax = np.asarray(JStacked(features=F, num_layers=3).init(
        jax.random.PRNGKey(0), np.zeros((1, 1, 3, 3, F), np.float32))
        ['params'][kernel])
    cols = flax.reshape(3, -1, 4 * F)
    for layer in range(3):
        np.testing.assert_allclose(cols[layer].T @ cols[layer],
                                   np.eye(4 * F), atol=1e-5)


def test_to_flax_round_trip(rng):
    _, variables, model, _ = _setup(rng, layers=2)
    back = to_flax(model.state_dict())
    assert set(back) == {'params'}
    for key, value in variables['params'].items():
        np.testing.assert_array_equal(back['params'][key], value)


def test_pipeline_and_bfloat16():
    from object_tracking_tpu_torch.parallel import Mesh
    with pytest.raises(ValueError, match='requires a mesh'):
        StackedConvLSTM(F, 2, pipeline=True)
    one = Mesh({'data': 1, 'model': 1})           # one process, one stage
    with pytest.raises(ValueError, match='must equal the mesh'):
        StackedConvLSTM(F, 2, pipeline=True, mesh=one)
    torch.manual_seed(0)
    dense = StackedConvLSTM(F, 1)
    piped = StackedConvLSTM(F, 1, pipeline=True, mesh=one)
    piped.load_state_dict(dense.state_dict())
    x = torch.randn(2, 3, F, 3, 3)
    torch.testing.assert_close(piped(x), dense(x), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='final state'):
        piped(x, return_state=True)
    model = StackedConvLSTM(F, 2, dtype=torch.bfloat16)
    y, (c, h) = model(torch.zeros(1, 2, F, 3, 3), return_state=True)
    assert y.dtype == c.dtype == h.dtype == torch.bfloat16
    assert model.input_kernel.dtype == torch.float32
