"""Port parity of the mixture-of-experts routing, the MoE tracking head and
expert parallelism against the JAX package on the CPU.

The same numpy inputs (seeded) go through `object_tracking_tpu.parallel.
expert` and `object_tracking_tpu_torch.parallel.expert`, and through the
two MoE heads and joint models (JAX weights carried by
`convert.from_flax`). Expert parallelism and the data-group routing run
in spawned gloo worlds of 2 and 4 ranks (`torch_ranks.moe_world`), held
against JAX's dense `moe_apply`.

Tolerances: routing is equal (each token's expert and the set of kept
tokens); outputs and auxiliary losses 1e-5 in float32 (JAX's own bar for
its EP test); gradients and the joint step's metrics as
test_torch_steps.py holds the dense steps (per-leaf relative L2 1e-3,
metrics rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import JointConfig as JJoint
from object_tracking_tpu.config import LossConfig as JLoss
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu.models.moe_head import MoEGridHead as JHead
from object_tracking_tpu.parallel import init_moe_params as jinit
from object_tracking_tpu.parallel import moe_apply as jmoe
from object_tracking_tpu.parallel.expert import _route as jroute
from object_tracking_tpu.training import TrainState as JState
from object_tracking_tpu.training import make_joint_train_step as jtrain
from object_tracking_tpu.training import make_optimizer as jopt
from object_tracking_tpu_torch.config import JointConfig
from object_tracking_tpu_torch.convert import (from_flax,
                                               load_flax_train_state,
                                               params_from_flax, to_flax)
from object_tracking_tpu_torch.models import MultiObjDetTracker
from object_tracking_tpu_torch.models.moe_head import MoEGridHead
from object_tracking_tpu_torch.parallel import (init_moe_params, moe_apply,
                                                moe_capacity)
from object_tracking_tpu_torch.parallel.expert import _route
from object_tracking_tpu_torch.training import (TrainState,
                                                make_joint_train_step,
                                                make_optimizer)
from torch_parity import numpy_tree
from torch_ranks import moe_world, run_world

TOL = dict(rtol=1e-5, atol=1e-5)


def _jparams(e=8, d=16, h=32, o=12, seed=0):
    return numpy_tree(jinit(jax.random.PRNGKey(seed), e, d, h, o))


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_moe_capacity_static():
    assert moe_capacity(64, 8, 1.0) == 8
    assert moe_capacity(64, 8, 1.25) == 10
    assert moe_capacity(3, 8, 1.0) == 1          # never zero
    # the full-width head: B=8 clips of T=4 on a 13x13 grid, 4 experts
    assert moe_capacity(8 * 4 * 13 * 13, 4, 1.25) == 1690


def test_init_moe_params_layout_and_scales():
    p = init_moe_params(torch.Generator().manual_seed(0), 4, 64, 128, 12)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        'gate': (64, 4), 'w1': (4, 64, 128), 'b1': (4, 128),
        'w2': (4, 128, 12), 'b2': (4, 12)}
    assert not p['b1'].any() and not p['b2'].any()
    for k, fan_in in (('gate', 64), ('w1', 64), ('w2', 128)):
        assert abs(float(p[k].std()) * fan_in ** 0.5 - 1.0) < 0.1, k
    again = init_moe_params(torch.Generator().manual_seed(0), 4, 64, 128, 12)
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize('groups,factor', [(1, 1.25), (4, 1.0), (2, 0.5)])
def test_moe_apply_matches_jax(rng, groups, factor):
    """Same expert per token, same kept set, outputs and aux to 1e-5."""
    params = _jparams()
    tokens = rng.randn(64, 16).astype(np.float32)
    ref, ref_aux = jmoe(params, jnp.asarray(tokens), num_groups=groups,
                        capacity_factor=factor, return_aux=True)
    out, aux = moe_apply(_t(params), torch.from_numpy(tokens),
                         num_groups=groups, capacity_factor=factor,
                         return_aux=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL)
    cap = moe_capacity(64 // groups, 8, factor)
    tok = tokens.reshape(groups, -1, 16)
    jd, _, _ = jroute(jnp.asarray(tok), params['gate'], 8, cap)
    td, _, _ = _route(torch.from_numpy(tok), _t(params)['gate'], 8, cap)
    jd, td = np.asarray(jd), td.numpy()
    assert np.array_equal(td, jd)                  # slots, hence routing
    assert np.array_equal(td.sum(axis=(2, 3)) > 0, jd.sum(axis=(2, 3)) > 0)


def test_moe_apply_gradients_match_jax(rng):
    params = _jparams()
    tokens = rng.randn(64, 16).astype(np.float32)

    def jloss(p, x):
        y, a = jmoe(p, x, return_aux=True)
        return jnp.sum(y ** 2) + a
    ref = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(tokens))
    p = {k: v.requires_grad_() for k, v in _t(params).items()}
    x = torch.from_numpy(tokens).requires_grad_()
    y, a = moe_apply(p, x, return_aux=True)
    ((y ** 2).sum() + a).backward()
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(ref[0][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-5)


def test_moe_overflow_tokens_drop_to_zero(rng):
    """Capacity 1 and every token forced to one expert: only the first
    token gets expert output (Switch drop semantics)."""
    e, d = 4, 8
    params = _t(_jparams(e=e, d=d, h=8, o=8))
    gate = torch.zeros(d, e)
    gate[:, 2] = 10.0
    params = dict(params, gate=gate, b2=torch.zeros_like(params['b2']))
    tokens = torch.from_numpy(np.abs(rng.randn(8, d)).astype(np.float32)
                              + 0.5)
    out = moe_apply(params, tokens, capacity_factor=e / tokens.shape[0])
    norms = out.norm(dim=-1)
    assert norms[0] > 0 and torch.all(norms[1:] == 0)


def test_moe_groups_route_independently(rng):
    params = _t(_jparams())
    tokens = torch.from_numpy(rng.randn(64, 16).astype(np.float32))
    grouped = moe_apply(params, tokens, num_groups=4)
    per = [moe_apply(params, tokens[i * 16:(i + 1) * 16]) for i in range(4)]
    torch.testing.assert_close(grouped, torch.cat(per), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match='divisible'):
        moe_apply(params, tokens[:63], num_groups=4)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_moe_head_matches_jax(rng, dtype):
    """MoEGridHead on (B, T, GH, GW, D) features: JAX's token order, the
    parameters cast to the compute dtype, the aux loss returned beside
    the output (JAX sows it)."""
    z = rng.randn(2, 3, 2, 2, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    head = JHead(num_experts=4, hidden=8, out_features=12, dtype=jdt)
    variables = head.init(jax.random.PRNGKey(1), jnp.asarray(z))
    ref, inter = head.apply(variables, jnp.asarray(z),
                            mutable=['intermediates'])
    port = MoEGridHead(16, 4, 8, 12, dtype=tdt)
    port.load_state_dict(_t(numpy_tree(variables['params'])))
    with torch.no_grad():
        out, aux = port(torch.from_numpy(z))
    assert out.dtype == tdt and out.shape == (2, 3, 2, 2, 12)
    tol = TOL if dtype == 'float32' else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)
    np.testing.assert_allclose(
        float(aux), float(inter['intermediates']['moe_aux_loss'][0]), **tol)


SMALL = dict(num_classes=2, num_anchors=2, convlstm_features=8, width_div=8,
             moe_experts=4, moe_hidden=16)
NET, T = 64, 2
ANCHORS = np.array([1.0, 1.0, 2.5, 2.0], np.float32)


@pytest.fixture(scope='module')
def jax_moe_model():
    model = JTracker(**SMALL)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, T, NET, NET, 3)))
    return model, numpy_tree(variables)


def _batch(rng, b=2):
    gh = NET // 32
    batch = {
        'images': rng.rand(b, T, NET, NET, 3).astype(np.float32),
        'y_true': np.zeros((b, T, gh, gh, 2, 7), np.float32),
        'true_boxes': np.zeros((b, T, 1, 1, 1, 50, 4), np.float32)}
    batch['y_true'][:, :, 0, 0, 1] = [0.5, 0.5, 0.6, 0.6, 1.0, 0, 1]
    batch['true_boxes'][:, :, 0, 0, 0, 0] = [0.5, 0.5, 0.6, 0.6]
    return batch


def test_moe_tracker_forward_matches_jax(rng, jax_moe_model):
    """The joint model with `tconv_moe` in place of `tconv_2`: the flax
    tree converts, and track, detect and the aux loss agree."""
    jmodel, variables = jax_moe_model
    assert 'tconv_moe' in variables['params']
    assert 'tconv_2' not in variables['params']
    port = MultiObjDetTracker(**SMALL)
    port.load_state_dict(from_flax(variables), strict=True)
    images = _batch(rng)['images']
    ref, inter = jmodel.apply(variables, jnp.asarray(images),
                              mutable=['intermediates'])
    with torch.no_grad():
        out = port(torch.from_numpy(images))
    for key in ('track', 'detect'):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    jaux = inter['intermediates']['tconv_moe']['moe_aux_loss'][0]
    np.testing.assert_allclose(float(out['moe_aux']), float(jaux), **TOL)


def test_moe_joint_train_step_matches_jax(rng, jax_moe_model):
    """One legacy train step from the same weights: the loss carries
    moe_aux_weight · moe_aux, the metrics agree (rtol 1e-4), moe_aux > 0,
    and the parameters after Adam (the MoE head's included) agree to
    per-leaf relative L2 1e-3."""
    jmodel, variables = jax_moe_model
    batch = _batch(rng)
    jstate = JState.create(jmodel.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-3))
    jstate, ref = jtrain(ANCHORS, JLoss(), JJoint(moe_aux_weight=0.01))(
        jstate, batch)
    model = MultiObjDetTracker(**SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    before = model.tconv_moe.w1.detach().clone()
    state = TrainState.create(model, make_optimizer(1e-3))
    state, metrics = make_joint_train_step(
        ANCHORS, joint_cfg=JointConfig(moe_aux_weight=0.01))(state, batch)
    assert set(metrics) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(metrics['moe_aux']) > 0
    assert not torch.equal(model.tconv_moe.w1, before)
    want = params_from_flax(numpy_tree(jstate.params))
    for name, p in model.named_parameters():
        err = float((p.detach().double() - want[name].double()).norm()
                    / want[name].double().norm())
        assert err <= 1e-3, (name, err)


def test_convert_moe_tree_and_train_state(jax_moe_model):
    """from_flax / to_flax carry tconv_moe/{gate,w1,b1,w2,b2} as they are,
    and load_flax_train_state their Adam moments."""
    _, variables = jax_moe_model
    state_dict = from_flax(variables)
    for k in ('gate', 'w1', 'b1', 'w2', 'b2'):
        np.testing.assert_array_equal(
            state_dict[f'tconv_moe.{k}'].numpy(),
            variables['params']['tconv_moe'][k])
    back = to_flax(state_dict)
    for k, v in variables['params']['tconv_moe'].items():
        np.testing.assert_array_equal(back['params']['tconv_moe'][k], v)
    mu = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.5),
                                variables['params'])
    nu = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.25),
                                variables['params'])
    state = TrainState.create(MultiObjDetTracker(**SMALL),
                              make_optimizer(1e-3))
    load_flax_train_state(state, step=3, params=variables['params'],
                          batch_stats=variables['batch_stats'], count=3,
                          mu=mu, nu=nu, learning_rate=1e-4)
    moments = state.optimizer.state[state.model.tconv_moe.w2]
    assert torch.all(moments['exp_avg'] == 0.5)
    assert torch.all(moments['exp_avg_sq'] == 0.25)


# ------------------------------------------------- gloo worlds (2, 4 ranks)
PER = 8


@pytest.fixture(scope='module', params=[2, 4], ids=lambda n: f'{n}ranks')
def moe_run(request, tmp_path_factory):
    n = request.param
    rng = np.random.RandomState(n)
    params = {'ep': _jparams(e=n, seed=1), 'ep_wrong': _jparams(e=n + 1),
              'dense': _jparams(e=4, seed=2)}
    tokens = {'ep': rng.randn(PER * n, 16).astype(np.float32),
              'dense': rng.randn(8 * n, 16).astype(np.float32)}
    results = run_world(moe_world, n, tmp_path_factory.mktemp('moe'),
                        params, tokens, PER, timeout=150)
    return n, params, tokens, results


def test_expert_parallel_matches_grouped_dense(moe_run):
    """Each rank's EP rows are moe_apply(num_groups=n)'s, whether the rank
    holds every expert or only its own."""
    n, params, tokens, results = moe_run
    ref = np.asarray(jmoe(params['ep'], jnp.asarray(tokens['ep']),
                          num_groups=n, capacity_factor=1.25))
    for rank, out in enumerate(results):
        rows = ref[rank * PER:(rank + 1) * PER]
        np.testing.assert_allclose(out['ep'], rows, **TOL)
        np.testing.assert_allclose(out['ep_local'], rows, **TOL)


def test_expert_parallel_gradients_match_dense(moe_run):
    """The all_to_all's backward: token and expert gradients of
    sum(y²) equal JAX's through the dense grouped formulation."""
    n, params, tokens, results = moe_run
    grads = jax.grad(lambda p, x: jnp.sum(jmoe(p, x, num_groups=n) ** 2),
                     argnums=(0, 1))(params['ep'], jnp.asarray(tokens['ep']))
    for rank, out in enumerate(results):
        np.testing.assert_allclose(
            out['ep_token_grad'],
            np.asarray(grads[1])[rank * PER:(rank + 1) * PER], **TOL)
        np.testing.assert_allclose(out['ep_expert_grad'],
                                   np.asarray(grads[0]['w1'])[rank], **TOL)


def test_expert_parallel_rejects_mismatches(moe_run):
    n, _, _, results = moe_run
    for out in results:
        assert f'{n + 1} experts != model axis size {n}' in out['err_experts']
        assert 'not divisible by axis size' in out['err_ragged']


@pytest.mark.parametrize('layout', ['share', 'runs'])
def test_data_group_routing_is_one_global_group(moe_run, layout):
    """A data group's ranks route one group in the global token order
    (num_groups=1 over every rank's tokens): the rows, the aux loss (the
    sum of the ranks' shares) and the gradients summed over the group
    equal JAX's moe_apply on the global tokens."""
    _, params, tokens, results = moe_run
    glob = jnp.asarray(tokens['dense'])

    def jloss(p):
        y, a = jmoe(p, glob, capacity_factor=0.9, return_aux=True)
        return jnp.sum(y ** 2) + a, (y, a)
    (_, (ref, ref_aux)), grads = jax.value_and_grad(
        jloss, has_aux=True)(params['dense'])
    ref = np.asarray(ref)
    for out in results:
        np.testing.assert_allclose(out[layout], ref[out[layout + '_rows']],
                                   **TOL)
        np.testing.assert_allclose(out[layout + '_aux'], float(ref_aux),
                                   **TOL)
        for k, g in out[layout + '_grads'].items():
            np.testing.assert_allclose(g, np.asarray(grads[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
