"""The joint train step's parallel layouts over 2 gloo ranks against the
single-rank port step and JAX's step on a 2-device mesh, on the CPU.

Small size (width_div=8, 64x64 frames, 2 classes, 2 anchors, ConvLSTM-8),
JAX's initial weights carried by `convert.from_flax`, the fused step
without augmentation. One spawned world of 2 ranks
(`torch_ranks.train_world`) runs every layout: data parallel with the
dense and the MoE head, the MoE head on a ragged batch (B=3, which
`shard_batch` replicates), sequence parallel (time_shards=2, dense and
MoE), the pipelined 2-layer stack (with a checkpoint), and two naive
per-rank semantics.

Tolerances, as JAX's dry run holds its layouts
(`__graft_entry__.py:122-131`) and test_torch_steps.py the dense steps:
- the first step's loss and metrics against the single-rank port step:
  rtol 1e-4;
- the two-step parameter update against the single-rank port's: cosine
  > 0.999 and norm ratio within 5 %;
- against JAX's step on a 2-device mesh: gradients per-leaf relative L2
  <= 1e-3, metrics rtol 1e-4 (test_torch_steps.py's bars);
- the MoE routing of the replicated batch against JAX's: the same kept
  slots, the head's output and auxiliary loss 1e-5 (test_torch_expert.py's
  bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from object_tracking_tpu.config import JointConfig as JJoint
from object_tracking_tpu.config import LossConfig as JLoss
from object_tracking_tpu.config import MeshConfig as JMeshConfig
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu.ops.targets import encode_targets as jencode
from object_tracking_tpu.parallel import make_mesh as jmake_mesh
from object_tracking_tpu.parallel import moe_apply as jmoe
from object_tracking_tpu.parallel import moe_capacity as jmoe_capacity
from object_tracking_tpu.parallel.expert import _route as jroute
from object_tracking_tpu.parallel import shard_batch as jshard
from object_tracking_tpu.training import TrainState as JState
from object_tracking_tpu.training import make_joint_train_step_fused as jtrainf
from object_tracking_tpu.training import make_optimizer as jopt
from object_tracking_tpu.training.steps import _joint_loss as jjoint_loss
from object_tracking_tpu_torch.convert import from_flax, params_from_flax
from object_tracking_tpu_torch.models import MultiObjDetTracker
from object_tracking_tpu_torch.training import (CheckpointManager,
                                                TrainState, make_optimizer)
from torch_parity import numpy_tree
from torch_ranks import (ANCHORS, ENC, SMALL, joint_state, run_world,
                         train_world, two_steps)

N = 2
M = ENC['true_box_buffer']
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)


def raw_batch(b, t, seed):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, t, M, 4), np.float32)
    cls = np.zeros((b, t, M), np.int32)
    valid = np.zeros((b, t, M), bool)
    for i in range(b):
        for j in range(t):
            for m in range(1 + (i + j) % 3):
                x1, y1 = rng.uniform(0, 40, 2)
                w, h = rng.uniform(6, 24, 2)
                boxes[i, j, m] = (x1, y1, x1 + w, y1 + h)
                cls[i, j, m] = rng.randint(2)
                valid[i, j, m] = True
    return {'images_u8': rng.randint(0, 256, (b, t, 64, 64, 3)).astype(
                np.uint8),
            'boxes': boxes, 'cls': cls, 'valid': valid,
            'aug_seeds': np.arange(b, dtype=np.uint32)}


def _jax_init(seed, t, **kw):
    model = JTracker(**SMALL, **kw)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, t, 64, 64, 3)))
    return model, numpy_tree(variables)


def _weights(variables):
    return {k: v.numpy() for k, v in from_flax(variables).items()}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    dense = _jax_init(0, 2)
    moe = _jax_init(1, 2, moe_experts=2, moe_hidden=8)
    deep = _jax_init(2, 2, convlstm_layers=N + 1)
    inputs = {'raw': raw_batch(N, 2, 0), 'raw_t': raw_batch(2, 2 * N, 1),
              'raw_ragged': raw_batch(N + 1, 2, 2),
              'dense': _weights(dense[1]), 'moe': _weights(moe[1]),
              'deep': _weights(deep[1])}
    ckpt = str(tmp_path_factory.mktemp('pp_ckpt'))
    results = run_world(train_world, N, tmp_path_factory.mktemp('train'),
                        inputs, ckpt, timeout=240)
    return {'jax': {'dense': dense, 'moe': moe}, 'inputs': inputs,
            'ckpt': ckpt, 'ranks': results}


# layout → (weights, raw batch, single-rank model options)
LAYOUTS = {'dp': ('dense', 'raw', {}),
           'moe': ('moe', 'raw', dict(moe_experts=2, moe_hidden=8)),
           'moe_ragged': ('moe', 'raw_ragged',
                          dict(moe_experts=2, moe_hidden=8)),
           'sp': ('dense', 'raw_t', {}),
           'sp_moe': ('moe', 'raw_t', dict(moe_experts=2, moe_hidden=8)),
           'pp': ('deep', 'raw', dict(convlstm_layers=N + 1))}


def _delta(params, weights):
    return np.concatenate([(params[k] - weights[k].astype(np.float64))
                           .ravel() for k in sorted(params)])


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_two_rank_step_matches_single_rank(run, layout):
    """Each rank's metrics of the first step against the single-rank port
    step on the global batch (rtol 1e-4), and the two-step update of
    every parameter (cosine > 0.999, norm ratio within 5 %), as JAX's dry
    run holds its layouts: after one Adam step the float32 rounding of
    the gradients' sum order has moved the weights apart by more than
    the metrics' tolerance, which the update bars measure instead."""
    weights, batch, kw = LAYOUTS[layout]
    w = run['inputs'][weights]
    ref = two_steps(joint_state(w, **kw), run['inputs'][batch])
    d_ref = _delta(ref['params'], w)
    for out in run['ranks']:
        got = out[layout]
        for k, v in ref['metrics'][0].items():
            np.testing.assert_allclose(got['metrics'][0][k], v,
                                       err_msg=f'{layout} {k}', **METRIC_TOL)
        d = _delta(got['params'], w)
        cos = d @ d_ref / (np.linalg.norm(d) * np.linalg.norm(d_ref))
        ratio = np.linalg.norm(d) / np.linalg.norm(d_ref)
        assert cos > 0.999 and abs(ratio - 1.0) < 0.05, (layout, cos, ratio)
    if layout.endswith('moe'):
        assert ref['metrics'][0]['moe_aux'] > 0


def _jax_prepared(raw):
    enc = jax.vmap(jax.vmap(lambda b, c, v: jencode(
        b, c, v, ANCHORS, image_h=64, image_w=64, grid_h=2, grid_w=2,
        num_classes=2, true_box_buffer=M)))
    y, tb = enc(raw['boxes'], raw['cls'], raw['valid'])
    return {'images': raw['images_u8'].astype(np.float32) / 255.0,
            'y_true': np.asarray(y), 'true_boxes': np.asarray(tb)}


def test_dp_gradients_match_jax_on_a_two_device_mesh(run):
    """JAX's joint loss and its gradients on a 2-device data mesh (the
    batch sharded, GSPMD's global-batch semantics) against each rank's
    summed gradients of the first step: per-leaf relative L2 <= 1e-3,
    metrics rtol 1e-4."""
    model, variables = run['jax']['dense']
    mesh = jmake_mesh(JMeshConfig(data_parallel=N), jax.devices()[:N])
    batch = jshard(mesh, _jax_prepared(run['inputs']['raw']))

    def loss(p):
        return jjoint_loss({'params': p,
                            'batch_stats': variables['batch_stats']},
                           model.apply, batch, ANCHORS, JLoss(), JJoint(),
                           0, train=True)
    (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    ref = params_from_flax(numpy_tree(grads))
    for out in run['ranks']:
        for k, v in metrics.items():
            np.testing.assert_allclose(out['dp']['metrics'][0][k], float(v),
                                       err_msg=k, **METRIC_TOL)
        for name, g in out['dp']['grads'].items():
            want = ref[name].double().numpy()
            err = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert err <= 1e-3, (name, err)


def test_moe_dp_step_matches_jax_on_a_two_device_mesh(run):
    """The MoE head under data parallelism routes one global group, as
    GSPMD does: JAX's fused step on a 2-device mesh gives the same
    metrics, moe_aux included (rtol 1e-4)."""
    model, variables = run['jax']['moe']
    mesh = jmake_mesh(JMeshConfig(data_parallel=N), jax.devices()[:N])
    state = JState.create(model.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-3))
    step = jtrainf(ANCHORS, augment=False, **ENC)
    _, metrics = step(state, jshard(mesh, run['inputs']['raw']))
    assert float(metrics['moe_aux']) > 0
    for out in run['ranks']:
        for k, v in metrics.items():
            np.testing.assert_allclose(out['moe']['metrics'][0][k],
                                       float(v), err_msg=k, **METRIC_TOL)


def test_moe_replicated_batch_routes_as_jax(run):
    """A batch that the data axis does not divide (B=3 on 2 ranks) is
    replicated, as JAX's shard_batch replicates it, and each rank routes
    its tokens as JAX routes the replicated input: one group of all of
    them, capacity moe_capacity(n), in their own order. The same kept
    slots as JAX's `_route`, the head's output and auxiliary loss as
    JAX's `moe_apply` (1e-5), and the step's metrics, moe_aux included,
    as JAX's fused step on a 2-device mesh (rtol 1e-4)."""
    model, variables = run['jax']['moe']
    w = run['inputs']['moe']
    params = {k: w[f'tconv_moe.{k}'] for k in ('gate', 'w1', 'b1', 'w2',
                                               'b2')}
    tol = dict(rtol=1e-5, atol=1e-5)
    for out in run['ranks']:
        route = out['moe_ragged']['route']
        assert not route['group']
        tokens = route['tokens']
        n = tokens.shape[0] * tokens.shape[1]
        cap = jmoe_capacity(n, 2, 1.25)
        assert route['capacity'] == cap
        dispatch, _, _ = jroute(jnp.asarray(tokens, jnp.float32),
                                jnp.asarray(route['gate'], jnp.float32), 2,
                                cap)
        np.testing.assert_array_equal(route['dispatch'],
                                      np.asarray(dispatch))
        y, aux = jmoe(params, jnp.asarray(tokens.reshape(n, -1),
                                          jnp.float32),
                      capacity_factor=1.25, return_aux=True)
        head, head_aux = out['moe_ragged']['head']
        np.testing.assert_allclose(head.reshape(n, -1), np.asarray(y), **tol)
        np.testing.assert_allclose(head_aux, float(aux), **tol)
    mesh = jmake_mesh(JMeshConfig(data_parallel=N), jax.devices()[:N])
    state = JState.create(model.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-3))
    _, metrics = jtrainf(ANCHORS, augment=False, **ENC)(
        state, jshard(mesh, run['inputs']['raw_ragged']))
    assert float(metrics['moe_aux']) > 0
    for out in run['ranks']:
        for k, v in metrics.items():
            np.testing.assert_allclose(out['moe_ragged']['metrics'][0][k],
                                       float(v), err_msg=k, **METRIC_TOL)


def test_naive_per_rank_semantics_differ_from_the_global_step(run):
    """A per-rank BatchNorm (plain DDP's) or a mean of per-rank losses is
    another step: each lies > 1e-3 (relative) from the global-batch loss
    that the port's data-parallel step computes (and JAX's, above)."""
    ref = run['ranks'][0]['dp']['metrics'][0]['loss']
    bn_local = [out['bn_local'] for out in run['ranks']]
    loss_mean = np.mean([out['loss_mean'] for out in run['ranks']])
    assert abs(bn_local[0] - ref) > 1e-3 * abs(ref), (bn_local, ref)
    assert abs(loss_mean - ref) > 1e-3 * abs(ref), (loss_mean, ref)


def test_pp_checkpoint_restores_into_the_dense_model(run):
    """Rank 0 wrote the pipelined run's checkpoint with the stacks
    gathered: it restores (parameters and Adam moments) into the dense
    model built without pp_layers, and holds the trained weights."""
    model = MultiObjDetTracker(**SMALL, convlstm_layers=N + 1)
    state = TrainState.create(model, make_optimizer(1e-3))
    state, at = CheckpointManager(run['ckpt']).restore(state)
    assert at == 2 and state.step == 2
    trained = run['ranks'][0]['pp']['params']
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().double().numpy(),
                                      trained[name], err_msg=name)
    stack = model.tconv_stack.recurrent_kernel
    assert state.optimizer.state[stack]['exp_avg'].shape == stack.shape


def test_every_rank_reports_the_global_metrics(run):
    for layout in LAYOUTS:
        first = run['ranks'][0][layout]['metrics']
        for out in run['ranks'][1:]:
            assert out[layout]['metrics'] == first, layout
