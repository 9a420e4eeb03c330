"""Port parity: MultiObjDetTracker with a deep ConvLSTM head
(`convlstm_layers` > 1: `tconv_lstm`, then `tconv_stack`) vs flax.

Small size (width_div=8, 64x64 frames, 3 classes, 2 anchors, ConvLSTM-8),
float32, weights converted with `convert.from_flax`, BatchNorm statistics
and affine terms randomised (`randomize_bn`) so that running statistics
are not an identity.

Tolerances, as tests/test_torch_models.py sets them for the single-layer
head: rtol 1e-4, atol 1e-5 with running statistics; rtol 1e-3, atol 3e-4
with batch statistics (float32 rounding amplified layer after layer by
the normalisation). The fused train step as tests/test_torch_steps.py
holds it: metrics rtol 1e-4, gradients and parameters per-leaf relative
L2 <= 1e-3, running statistics rtol 1e-4, atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import YOLOV2_ANCHORS
from object_tracking_tpu.inference import JointPredictor as JPredictor
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu.training import TrainState as JState
from object_tracking_tpu.training import make_joint_train_step_fused as jtrainf
from object_tracking_tpu.training import make_optimizer as jopt
from object_tracking_tpu_torch.convert import (from_flax,
                                               load_flax_train_state,
                                               params_from_flax, to_flax)
from object_tracking_tpu_torch.inference import JointPredictor
from object_tracking_tpu_torch.models import MultiObjDetTracker
from object_tracking_tpu_torch.models.darknet19 import init_like_flax
from object_tracking_tpu_torch.training import (TrainState,
                                                make_joint_train_step_fused,
                                                make_optimizer)
from torch_parity import numpy_tree, randomize_bn

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH_STATS_TOL = dict(rtol=1e-3, atol=3e-4)
SMALL = dict(num_classes=3, num_anchors=2, convlstm_features=8, width_div=8)


def _pair(rng, layers, t=3):
    jmodel = JTracker(convlstm_layers=layers, **SMALL)
    variables = randomize_bn(jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, t, 64, 64, 3), np.float32)), rng)
    model = MultiObjDetTracker(convlstm_layers=layers, **SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    return jmodel, variables, model


def _state(rng, layers, b=2):
    z = rng.randn(b, 2, 2, 8).astype(np.float32)
    zs = rng.randn(layers - 1, b, 2, 2, 8).astype(np.float32)
    return ((z, -z), (zs, 0.5 * zs))


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def _as_torch(tree):
    return tuple(_as_torch(n) if isinstance(n, tuple) else
                 torch.from_numpy(n) for n in tree)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('layers', [2, 3])
def test_deep_tracker_matches_flax(rng, layers, train):
    """Both heads and the nested streamed state ((c, h), (cs, hs)) from a
    carried state, in both BatchNorm modes (eval(): nothing written)."""
    jmodel, variables, model = _pair(rng, layers)
    x = rng.rand(2, 3, 64, 64, 3).astype(np.float32)
    state0 = _state(rng, layers)
    if train:
        ref, _ = jmodel.apply(variables, x, train=True, initial_state=state0,
                              return_state=True, mutable=['batch_stats'])
    else:
        ref = jmodel.apply(variables, x, train=False, initial_state=state0,
                           return_state=True)
    model.eval()
    out = model(torch.from_numpy(x), train=train,
                initial_state=_as_torch(state0), return_state=True)
    tol = BATCH_STATS_TOL if train else TOL
    for key in ('detect', 'track'):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), **tol)
    got, want = _leaves(out['state']), _leaves(ref['state'])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[2].shape == (layers - 1, 2, 2, 2, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


def test_deep_zero_state():
    model = MultiObjDetTracker(convlstm_layers=3, **SMALL)
    (c, h), (cs, hs) = model.zero_state(4, 2, 2)
    assert c.shape == h.shape == (4, 2, 2, 8)
    assert cs.shape == hs.shape == (2, 4, 2, 2, 8)
    assert cs.dtype == torch.float32 and not cs.any() and not c.any()
    jz = JTracker(convlstm_layers=3, **SMALL).zero_state(4, 2, 2)
    assert [leaf.shape for leaf in _leaves(jz)] == \
        [tuple(leaf.shape) for leaf in _leaves(model.zero_state(4, 2, 2))]


def test_deep_windowed_state_carry_matches_full_clip(rng):
    """tests/test_streaming.py's carry case on the deep head: 6 frames at
    once == two windows of 3 with the nested state carried, and both
    equal JAX's full clip (running statistics)."""
    jmodel, variables, model = _pair(rng, 2, t=6)
    x = rng.rand(1, 6, 64, 64, 3).astype(np.float32)
    full = model(torch.from_numpy(x))['track']
    out1 = model(torch.from_numpy(x[:, :3]), return_state=True)
    out2 = model(torch.from_numpy(x[:, 3:]), initial_state=out1['state'])
    torch.testing.assert_close(torch.cat([out1['track'], out2['track']], 1),
                               full, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(full.detach().numpy(), np.asarray(
        jmodel.apply(variables, x, train=False)['track']), **TOL)
    cold = model(torch.from_numpy(x[:, 3:]))['track']
    assert not torch.allclose(cold, full[:, 3:], atol=1e-5)


def test_deep_to_flax_round_trip(rng):
    """to_flax(from_flax(v)) == v; and the port's own init, through
    to_flax, runs in flax to the port's outputs."""
    _, variables, model = _pair(rng, 3)
    back = to_flax(model.state_dict())
    stack = variables['params']['tconv_stack']
    for key in ('input_kernel', 'input_bias', 'recurrent_kernel'):
        np.testing.assert_array_equal(back['params']['tconv_stack'][key],
                                      stack[key])
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    fresh = init_like_flax(MultiObjDetTracker(convlstm_layers=2, **SMALL), 3)
    x = rng.rand(1, 2, 64, 64, 3).astype(np.float32)
    ref = JTracker(convlstm_layers=2, **SMALL).apply(
        to_flax(fresh.state_dict()), x, train=False)
    np.testing.assert_allclose(
        fresh(torch.from_numpy(x))['track'].detach().numpy(),
        np.asarray(ref['track']), **TOL)


def test_deep_init_like_flax_keeps_both_kernels_orthogonal():
    """init_like_flax gives every Conv2d lecun_normal first; the stacked
    layers' input kernels are not Conv2d and end orthogonal, as
    `stacked_orthogonal` makes them, with the forget bias +1."""
    model = init_like_flax(MultiObjDetTracker(convlstm_layers=3, **SMALL), 0)
    stack = model.tconv_stack
    for weight in (stack.input_kernel, stack.recurrent_kernel):
        for layer in range(2):
            rows = weight[layer].detach().reshape(32, -1)
            torch.testing.assert_close(rows @ rows.T, torch.eye(32),
                                       atol=1e-5, rtol=0)
    assert stack.input_bias[:, 8:16].eq(1).all()
    assert stack.input_bias[:, :8].eq(0).all()


B, T, NET, M = 2, 3, 64, 5
ANCHORS = np.array([1.0, 1.0, 2.5, 2.0], np.float32)
ENC = dict(net_h=NET, net_w=NET, grid_h=2, grid_w=2, num_classes=3,
           true_box_buffer=M)


def _raw_batch(seed=0):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, 40, (B, T, M, 2))
    wh = rng.uniform(6, 24, (B, T, M, 2))
    return {'images_u8': rng.randint(0, 256, (B, T, NET, NET, 3)).astype(
                np.uint8),
            'boxes': np.concatenate([x1, x1 + wh], -1).astype(np.float32),
            'cls': rng.randint(3, size=(B, T, M)).astype(np.int32),
            'valid': np.arange(M)[None, None, :].repeat(B, 0).repeat(T, 1)
            < 3,
            'aug_seeds': np.arange(B, dtype=np.uint32)}


def _close_leaves(port: dict, ref: dict, tol: float = 1e-3):
    assert set(port) == set(ref)
    for name, got in port.items():
        want = ref[name].double()
        err = float((got.double() - want).norm() / want.norm())
        assert err <= tol, (name, err)


def test_deep_fused_train_step_matches_jax():
    """One fused joint train step at depth 2 from the same weights: the
    metrics, the parameters after Adam (tconv_stack's included), Adam's
    moments carried back, and the running statistics."""
    jmodel = JTracker(convlstm_layers=2, **SMALL)
    variables = numpy_tree(jmodel.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, T, NET, NET, 3))))
    raw = _raw_batch()
    ref_state = JState.create(jmodel.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-3))
    ref_state, ref_metrics = jtrainf(ANCHORS, augment=False, **ENC)(
        ref_state, raw)
    model = MultiObjDetTracker(convlstm_layers=2, **SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    state = TrainState.create(model, make_optimizer(1e-3))
    state, metrics = make_joint_train_step_fused(
        ANCHORS, augment=False, **ENC)(state, raw)
    assert set(metrics) == set(ref_metrics)
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    params = {n: p.detach() for n, p in model.named_parameters()}
    assert {'tconv_stack.input_kernel', 'tconv_stack.input_bias',
            'tconv_stack.recurrent_kernel'} <= set(params)
    _close_leaves(params, params_from_flax(numpy_tree(ref_state.params)))
    stats = from_flax({'params': numpy_tree(ref_state.params),
                       'batch_stats': numpy_tree(ref_state.batch_stats)})
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)

    adam = ref_state.opt_state.inner_state[0]
    carried = load_flax_train_state(
        TrainState.create(MultiObjDetTracker(convlstm_layers=2, **SMALL),
                          make_optimizer(1e-3)),
        **jax.tree_util.tree_map(np.asarray, {
            'step': ref_state.step, 'params': ref_state.params,
            'batch_stats': ref_state.batch_stats, 'count': adam.count,
            'mu': adam.mu, 'nu': adam.nu,
            'learning_rate': ref_state.opt_state.hyperparams[
                'learning_rate']}))
    mu = params_from_flax(numpy_tree(adam.mu))
    for name, p in carried.model.named_parameters():
        torch.testing.assert_close(carried.optimizer.state[p]['exp_avg'],
                                   mu[name], rtol=0, atol=0)


def test_deep_joint_predictor_streams_like_jax(rng):
    """JointPredictor on the deep head (running statistics, greedy ids):
    two streamed windows and a batched pair of streams as JAX's predictor
    gives them; the carried state is the nested float32 tree."""
    jmodel, variables, model = _pair(rng, 2, t=4)
    # a wider track head spreads the class scores over (0, 1)
    variables['params']['tconv_2']['kernel'] *= 16.0
    model.load_state_dict(from_flax(variables), strict=True)
    kwargs = dict(labels=('a', 'b', 'c'), obj_threshold=0.1,
                  net_size=(64, 64), bn_mode='running')
    anchors = np.asarray(YOLOV2_ANCHORS[:4], np.float32)
    jpred = JPredictor(jmodel, variables, anchors, **kwargs)
    pred = JointPredictor(model, anchors, device='cpu', **kwargs)
    detections = 0
    for _ in range(2):
        frames = rng.rand(4, 64, 64, 3).astype(np.float32)
        ref, out = jpred.predict_window(frames), pred.predict_window(frames)
        assert [[(d['label'], d['track_id']) for d in f] for f in out] == \
            [[(d['label'], d['track_id']) for d in f] for f in ref]
        for of, rf in zip(out, ref):
            np.testing.assert_allclose(np.reshape([d['box'] for d in of],
                                                  (-1, 4)),
                                       np.reshape([d['box'] for d in rf],
                                                  (-1, 4)), rtol=0,
                                       atol=1e-5)
        detections += sum(map(len, ref))
    assert detections > 0
    (c, h), (cs, hs) = pred._state
    assert cs.shape == (1, 1, 2, 2, 8) and cs.dtype == torch.float32
    clips = rng.rand(2, 4, 64, 64, 3).astype(np.float32)
    for _ in range(2):
        out = pred.predict_batch(clips)
    assert len(out) == 2 and pred._bstate[1][0].shape == (1, 2, 2, 2, 8)
    pred.predict_batch(clips[:1])            # a batch-size change resets
    assert pred._bstate[0][0].shape[0] == 1
