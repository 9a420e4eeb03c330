"""Port parity: Darknet19, FusedConvLSTM and MultiObjDetTracker vs flax.

Small size (width_div=8, 64x64 frames, 3 classes, 2 anchors, ConvLSTM-8),
float32, weights converted with `convert.from_flax`; BatchNorm statistics
and affine terms are randomised first so the running-statistics mode is
not an identity.

Tolerance: rtol=1e-4, atol=1e-5 with running statistics (train=False), as
test_streaming.py uses for the same model. With batch statistics
(train=True) float32 rounding is amplified layer after layer by the
normalisation, so that flax's float32 result is itself ~5e-5 away from a
float64 evaluation of the same network (test_batch_stats_float32_error
measures it and holds the port to no more error than flax); the
batch-statistics outputs are held to rtol=1e-3, atol=3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.models import Darknet19 as JDarknet19
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu.models.convlstm import FusedConvLSTM as JLSTM
from object_tracking_tpu.models.darknet19 import space_to_depth_2x as jstd
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.models import (Darknet19, FusedConvLSTM,
                                              MultiObjDetTracker)
from object_tracking_tpu_torch.models.darknet19 import space_to_depth_2x
from torch_parity import numpy_tree, randomize_bn

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH_STATS_TOL = dict(rtol=1e-3, atol=3e-4)
SMALL = dict(num_classes=3, num_anchors=2)


def _close(t, j, train=False):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(BATCH_STATS_TOL if train else TOL))


def test_space_to_depth_channel_order(rng):
    x = rng.rand(2, 4, 6, 3).astype(np.float32)              # NHWC
    ref = np.asarray(jstd(jnp.asarray(x)))
    out = space_to_depth_2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize('train', [False, True])
def test_darknet19_matches_flax(rng, train):
    jmodel = JDarknet19(width_div=8, **SMALL)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), x), rng)
    if train:
        ref, _ = jmodel.apply(variables, x, train=True,
                              mutable=['batch_stats'])
    else:
        ref = jmodel.apply(variables, x, train=False)
    model = Darknet19(width_div=8, **SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    model.eval()            # serving: batch statistics, nothing written
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = model(torch.from_numpy(x), train=train)
    for key in ('netout', 'conv_feat'):
        assert out[key].dtype == torch.float32
        _close(out[key], ref[key], train)
    for k, v in model.state_dict().items():       # no running-stat writes
        assert torch.equal(v, before[k]), k


def test_train_mode_folds_batch_statistics_like_flax(rng):
    """In train() mode a batch-statistics forward writes flax's running
    statistics (momentum 0.99, biased E[x²] − E[x]² variance); rtol 1e-4,
    atol 1e-7 (a channel mean near 0 is a cancellation)."""
    jmodel = JDarknet19(width_div=8, **SMALL)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), x), rng)
    _, updates = jmodel.apply(variables, x, train=True,
                              mutable=['batch_stats'])
    want = from_flax({'params': variables['params'],
                      'batch_stats': numpy_tree(updates['batch_stats'])})
    model = Darknet19(width_div=8, **SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    model(torch.from_numpy(x), train=True)
    for k, v in model.named_buffers():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_batch_stats_float32_error(rng):
    """Against a float64 run of the port, the port's float32 netout in
    batch-statistics mode is no further off than flax's float32 one."""
    jmodel = JDarknet19(width_div=8, **SMALL)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), x), rng)
    ref, _ = jmodel.apply(variables, x, train=True, mutable=['batch_stats'])
    state = from_flax(variables)
    exact = Darknet19(width_div=8, dtype=torch.float64, **SMALL).double()
    exact.load_state_dict({k: v.double() for k, v in state.items()})
    exact = exact(torch.from_numpy(x).double(), train=True)['netout']
    model = Darknet19(width_div=8, **SMALL)
    model.load_state_dict(state)
    port_err = (model(torch.from_numpy(x), train=True)['netout'].double()
                - exact).abs().max().item()
    flax_err = np.abs(np.asarray(ref['netout'], np.float64)
                      - exact.detach().numpy()).max()
    assert 1e-5 < flax_err < 3e-4
    assert port_err <= 1.5 * flax_err


@pytest.mark.parametrize('train', [False, True])
def test_bfloat16_error_like_flax(rng, train):
    """The port's bfloat16 MultiObjDetTracker lies no further from its own
    float32 result than flax's bfloat16 model lies from flax's float32
    one, within a factor of 2, on the same weights and frames, in both
    BatchNorm modes; and both sides' float32 results agree as
    test_tracker_matches_flax holds them. (Measured: detect 1.7e-3
    (flax) and 1.4e-3 (port) with running statistics; 0.43 and 0.47 with
    batch statistics, whose bfloat16 statistics move the whole map.)"""
    x = rng.rand(2, 3, 64, 64, 3).astype(np.float32)
    variables = randomize_bn(JTracker(convlstm_features=8, width_div=8,
                                      **SMALL).init(
        jax.random.PRNGKey(0), x), rng)
    state = from_flax(variables)

    def flax(dtype):
        model = JTracker(convlstm_features=8, width_div=8, dtype=dtype,
                         **SMALL)
        if train:
            return model.apply(variables, x, train=True,
                               mutable=['batch_stats'])[0]
        return model.apply(variables, x, train=False)

    def port(dtype):
        model = MultiObjDetTracker(convlstm_features=8, width_div=8,
                                   dtype=dtype, **SMALL).eval()
        model.load_state_dict(state, strict=True)
        return model(torch.from_numpy(x), train=train)

    f32, f16 = flax(jnp.float32), flax(jnp.bfloat16)
    p32, p16 = port(torch.float32), port(torch.bfloat16)
    for key in ('detect', 'track'):
        assert p16[key].dtype == torch.float32
        _close(p32[key], f32[key], train)
        flax_err = np.abs(np.asarray(f16[key], np.float64)
                          - np.asarray(f32[key], np.float64)).max()
        port_err = (p16[key].double() - p32[key].double()).abs().max().item()
        assert flax_err > 1e-4, key                  # bfloat16 was used
        assert port_err <= 2.0 * flax_err, (key, port_err, flax_err)


def test_fused_convlstm_with_carried_state(rng):
    jlstm = JLSTM(features=8)
    x = rng.randn(2, 3, 4, 4, 6).astype(np.float32)            # B,T,H,W,C
    c0 = rng.randn(2, 4, 4, 8).astype(np.float32)
    h0 = rng.randn(2, 4, 4, 8).astype(np.float32)
    variables = numpy_tree(jlstm.init(jax.random.PRNGKey(1), x))
    ys, (c, h) = jlstm.apply(variables, x, initial_state=(c0, h0),
                             return_state=True)
    lstm = FusedConvLSTM(6, 8)
    lstm.load_state_dict(from_flax(variables), strict=True)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    tys, (tc, th) = lstm(torch.from_numpy(x).permute(0, 1, 4, 2, 3),
                         initial_state=(nchw(c0), nchw(h0)),
                         return_state=True)
    _close(tys.permute(0, 1, 3, 4, 2), ys)
    _close(tc.permute(0, 2, 3, 1), c)
    _close(th.permute(0, 2, 3, 1), h)


@pytest.mark.parametrize('train', [False, True])
def test_tracker_matches_flax(rng, train):
    jmodel = JTracker(convlstm_features=8, width_div=8, **SMALL)
    x = rng.rand(2, 3, 64, 64, 3).astype(np.float32)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), x), rng)
    z = rng.randn(2, 2, 2, 8).astype(np.float32)
    state0 = (z, -z)
    if train:
        ref, _ = jmodel.apply(variables, x, train=True, initial_state=state0,
                              return_state=True, mutable=['batch_stats'])
    else:
        ref = jmodel.apply(variables, x, train=False, initial_state=state0,
                           return_state=True)
    model = MultiObjDetTracker(convlstm_features=8, width_div=8, **SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    out = model(torch.from_numpy(x), train=train,
                initial_state=tuple(map(torch.from_numpy, state0)),
                return_state=True)
    _close(out['detect'], ref['detect'], train)
    _close(out['track'], ref['track'], train)
    for t_s, j_s in zip(out['state'], ref['state']):
        _close(t_s, j_s, train)
    assert out['track'].shape == (2, 3, 2, 2, 2, 8)


def test_tracker_zero_state_and_later_options():
    model = MultiObjDetTracker(convlstm_features=8, width_div=8, **SMALL)
    c, h = model.zero_state(3, 2, 2)
    assert c.shape == (3, 2, 2, 8) and not c.any() and not h.any()
    assert MultiObjDetTracker(remat=True, convlstm_features=8, width_div=8,
                              **SMALL).remat       # ported with training
    moe = MultiObjDetTracker(moe_experts=4, moe_hidden=8,
                             convlstm_features=8, width_div=8, **SMALL)
    assert not hasattr(moe, 'tconv_2') and moe.tconv_moe.w1.shape[0] == 4
    assert moe.zero_state(3, 2, 2)[0].shape == (3, 2, 2, 8)
    sharded = MultiObjDetTracker(time_shards=2, convlstm_features=8,
                                 width_div=8, **SMALL)   # built; runs with
    with pytest.raises(ValueError, match='requires a mesh'):  # a mesh
        sharded(torch.zeros(1, 2, 64, 64, 3))
    (c, h), (cs, hs) = MultiObjDetTracker(
        convlstm_layers=3, convlstm_features=8, width_div=8,
        **SMALL).zero_state(3, 2, 2)           # the deep head, ported
    assert c.shape == (3, 2, 2, 8) and cs.shape == (2, 3, 2, 2, 8)


def test_from_flax_raises_on_unused_or_missing_keys(rng):
    jmodel = JDarknet19(width_div=8, **SMALL)
    variables = numpy_tree(jmodel.init(jax.random.PRNGKey(0),
                                        np.zeros((1, 32, 32, 3),
                                                 np.float32)))
    state = from_flax(variables)
    assert state['conv_1.weight'].shape == (4, 3, 3, 3)         # OIHW
    unused = {**variables,
              'params': {**variables['params'], 'extra': {'w': np.ones(2)}}}
    with pytest.raises(KeyError, match='unused'):
        from_flax(unused)
    missing = {**variables, 'batch_stats': {
        k: v for k, v in variables['batch_stats'].items() if k != 'norm_3'}}
    with pytest.raises(KeyError, match='missing'):
        from_flax(missing)
    with pytest.raises(KeyError, match='unused'):
        from_flax({**variables, 'intermediates': {}})
