"""Port parity of tensor parallelism (`parallel/sharding.py` and the
column-parallel operators of `parallel/collectives.py`) against the JAX
package on the CPU.

- The plan: the port's `plan_tp_specs` on a `meta`-device module (shapes
  only, no init), mapped through `convert.from_flax`'s transposes, equals
  JAX's `plan_tp_specs` on `jax.eval_shape` of the same model leaf by
  leaf, for the full-width dense, deep (convlstm_layers=2) and MoE joint
  models at tp = 2 and 4, and for JAX's toy trees (tests/test_parallel.py,
  tests/test_expert.py) written in the port's layout; the summaries too.
- The operators, in a 2-rank gloo world, against dense autograd.
- The fused joint train step under dp x tp, in gloo worlds of 2 ranks
  (1 x 2) and 4 ranks (2 x 2, 1 x 4), dense head and moe_experts=2, at
  JAX's slow test's shapes (3 classes, ConvLSTM-16, 64², T=2, B=4,
  min_params 1 << 8) with the dry run's width_div=8:
  - against the port's dense step on the same mesh, in float64: metrics
    rtol 1e-5, gradients and parameters (BatchNorm statistics included)
    relative L2 <= 1e-5 after the first step, on every rank. In float32,
    rounding alone moves them further: the first step's gradients lie up
    to ~2e-5 from the dense step's (BatchNorm leaves: 32 values a channel
    in the deepest layers) and Adam's first update turns that into ~9e-5
    on a few weights whose gradient is near zero;
  - the float32 and float64 first steps against JAX's dense step with its
    network in float64: metrics rtol 1e-4, gradients per-leaf relative L2
    <= 1e-3 (tests/test_torch_steps.py's bars; XLA's own float32 step
    lies 2.2e-2 from the port's at the MoE model's weights);
  - two float32 steps against the single-process dense run with the dry
    run's bars: update cosine >= 0.999, norm ratio within 5 %, loss
    within 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from object_tracking_tpu.config import JointConfig as JJoint
from object_tracking_tpu.config import LossConfig as JLoss
from object_tracking_tpu.config import MeshConfig as JMeshConfig
from object_tracking_tpu.config import YOLOV2_ANCHORS as JANCHORS
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu.ops.targets import encode_targets as jencode
from object_tracking_tpu.parallel import make_mesh as jmake_mesh
from object_tracking_tpu.parallel import plan_tp_specs as jplan
from object_tracking_tpu.parallel import tp_sharding_summary as jsummary
from object_tracking_tpu.training.steps import _joint_loss as jjoint_loss
from object_tracking_tpu_torch.convert import from_flax, params_from_flax
from object_tracking_tpu_torch.models import MultiObjDetTracker
from object_tracking_tpu_torch.parallel import (Mesh, plan_tp_specs,
                                                shard_variables,
                                                tp_sharding_summary)
from object_tracking_tpu_torch.parallel.collectives import gather_blocks
from object_tracking_tpu_torch.parallel.sharding import column_conv
from torch_parity import numpy_tree
from torch_ranks import (TP_ENC, TP_HEADS, TP_MIN_PARAMS, TP_MODEL,
                         op_world, run_world, tp_steps, tp_world)

FULL = dict(num_classes=12, num_anchors=5, convlstm_features=512)
FULL_MODELS = {'dense': {}, 'deep': dict(convlstm_layers=2),
               'moe': dict(moe_experts=4, moe_hidden=256)}
ANCHORS = np.asarray(JANCHORS, np.float32)
B, T, M = 4, 2, TP_ENC['true_box_buffer']
LAYOUTS = ['1x2_dense', '1x2_moe', '2x2_dense', '2x2_moe', '1x4_dense',
           '1x4_moe']


# ----------------------------------------------------------------- plan
def _jax_axes(variables, tp: int):
    """JAX's plan at a model axis of tp as {leaf path: sharded axis}."""
    mesh = jmake_mesh(JMeshConfig(model_parallel=tp))
    specs = jplan(variables, mesh)
    axes = jax.tree_util.tree_map(
        lambda s: next((i for i, a in enumerate(s) if a == 'model'), None),
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return axes, mesh


def _port_axes_from_jax(variables, tp: int):
    """JAX's plan carried to the port's names and layouts: each leaf
    becomes a probe with size 2 on its sharded axis (1 elsewhere), which
    `from_flax` transposes as it transposes the weights."""
    axes, mesh = _jax_axes(variables, tp)

    def probe(leaf, axis):
        shape = [1] * len(np.shape(leaf))
        if axis is not None:
            shape[axis] = 2
        return np.ones(shape, np.float32)
    probes = jax.tree_util.tree_map(probe, variables, axes,
                                    is_leaf=lambda x: x is None)
    port = {k: (list(v.shape).index(2) if 2 in v.shape else None)
            for k, v in from_flax(probes).items()}
    return port, mesh


@pytest.mark.parametrize('tp', [2, 4])
@pytest.mark.parametrize('name', list(FULL_MODELS))
def test_full_width_plan_equals_jax_leaf_by_leaf(name, tp):
    variables = jax.eval_shape(
        lambda: JTracker(**FULL, **FULL_MODELS[name]).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3))))
    want, jmesh = _port_axes_from_jax(variables, tp)
    with torch.device('meta'):
        model = MultiObjDetTracker(**FULL, **FULL_MODELS[name])
    mesh = Mesh({'data': 8 // tp, 'model': tp})
    got = plan_tp_specs(model, mesh)
    assert got == want
    summary = tp_sharding_summary(model, mesh)
    assert summary == jsummary(variables, jmesh)
    if name == 'dense':         # 80.6M parameters, every conv kernel split
        assert summary == {'sharded': (42, 80_304_224),
                           'replicated': (75, 254_762)}
    if name == 'deep':
        assert summary['sharded'][1] == 99_178_592
        assert summary['replicated'][1] == 256_810


def _toy_axis(spec, perm=None):
    """The port axis of a JAX PartitionSpec, `perm` the port's transpose
    of the JAX layout (port axis i = JAX axis perm[i])."""
    axis = next((i for i, a in enumerate(spec) if a == 'model'), None)
    if axis is None or perm is None:
        return axis
    return perm.index(axis)


@pytest.mark.parametrize('tp', [2, 4, 8])
def test_toy_tree_plans_equal_jax(tp):
    """tests/test_parallel.py's tree (big/tiny/odd kernels, a bias, a
    batch statistic) and tests/test_expert.py's MoE tree (the gate's D
    axis shards too), in the port's layout, against JAX's plan."""
    jax_tree = {
        'params': {
            'big': {'kernel': np.zeros((3, 3, 256, 128), np.float32),
                    'bias': np.zeros((128,), np.float32)},
            'tiny': {'kernel': np.zeros((1, 1, 4, 8), np.float32)},
            'odd': {'kernel': np.zeros((3, 3, 256, 127), np.float32)},
            'tconv_moe': {'w1': np.zeros((tp, 64, 128), np.float32),
                          'b1': np.zeros((tp, 128), np.float32),
                          'gate': np.zeros((64, tp), np.float32)}},
        'batch_stats': {'big': {'mean': np.zeros((128,), np.float32)}},
    }
    port_tree = {
        'big.weight': torch.zeros(128, 256, 3, 3),
        'big.bias': torch.zeros(128),
        'tiny.weight': torch.zeros(8, 4, 1, 1),
        'odd.weight': torch.zeros(127, 256, 3, 3),
        'tconv_moe.w1': torch.zeros(tp, 64, 128),
        'tconv_moe.b1': torch.zeros(tp, 128),
        'tconv_moe.gate': torch.zeros(64, tp),
        'big.running_mean': torch.zeros(128)}
    mesh = jmake_mesh(JMeshConfig(model_parallel=tp))
    specs = jplan(jax_tree, mesh)
    p, moe = specs['params'], specs['params']['tconv_moe']
    hwio = (3, 2, 0, 1)
    want = {'big.weight': _toy_axis(p['big']['kernel'], hwio),
            'big.bias': _toy_axis(p['big']['bias']),
            'tiny.weight': _toy_axis(p['tiny']['kernel'], hwio),
            'odd.weight': _toy_axis(p['odd']['kernel'], hwio),
            'tconv_moe.w1': _toy_axis(moe['w1']),
            'tconv_moe.b1': _toy_axis(moe['b1']),
            'tconv_moe.gate': _toy_axis(moe['gate']),
            'big.running_mean': _toy_axis(specs['batch_stats']['big']['mean'])}
    port_mesh = Mesh({'data': 8 // tp, 'model': tp})
    got = plan_tp_specs(port_tree, port_mesh)
    assert got == want
    assert got['big.weight'] == 0 and got['tconv_moe.gate'] == 0
    assert got['tiny.weight'] is None and got['big.running_mean'] is None
    assert tp_sharding_summary(port_tree, port_mesh) == jsummary(jax_tree,
                                                                 mesh)


def test_plan_of_one_model_rank_replicates_everything():
    with torch.device('meta'):
        model = MultiObjDetTracker(**FULL)
    mesh = Mesh({'data': 8, 'model': 1})
    assert set(plan_tp_specs(model, mesh).values()) == {None}
    assert tp_sharding_summary(model, mesh)['sharded'] == (0, 0)
    assert shard_variables(mesh, model) is model      # nothing to shard


def test_shard_variables_refuses_a_pipelined_stack():
    model = MultiObjDetTracker(**TP_MODEL, convlstm_layers=2)
    model.tconv_stack.pipeline = True
    with pytest.raises(ValueError, match='pipelined or time-sharded'):
        shard_variables(Mesh({'data': 1, 'model': 2}), model,
                        min_params=TP_MIN_PARAMS)


# ------------------------------------------------------------ operators
def test_operators_without_a_group_are_the_dense_ops():
    x = torch.randn(2, 4, 5, 5)
    w, b = torch.randn(6, 4, 3, 3), torch.randn(6)
    assert gather_blocks(x, None, 1) is x
    torch.testing.assert_close(column_conv(x, w, b, 1),
                               F.conv2d(x, w, b, padding=1), rtol=0, atol=0)


@pytest.fixture(scope='module')
def ops(tmp_path_factory):
    rng = np.random.RandomState(0)
    inputs = {'blocks': rng.randn(4, 6).astype(np.float32),
              'blocks_w': rng.randn(4, 6).astype(np.float32),
              'x': rng.randn(2, 4, 5, 5).astype(np.float32),
              'w': rng.randn(6, 4, 3, 3).astype(np.float32),
              'b': rng.randn(6).astype(np.float32),
              'y_w': rng.randn(2, 6, 5, 5).astype(np.float32)}
    ranks = run_world(op_world, 2, tmp_path_factory.mktemp('ops'), inputs)
    return inputs, ranks


def _dense_conv(inputs):
    x, w, b = (torch.from_numpy(inputs[k]).double().requires_grad_()
               for k in ('x', 'w', 'b'))
    y = F.conv2d(x, w, b, padding=1)
    (y * torch.from_numpy(inputs['y_w']).double()).sum().backward()
    return y.detach().numpy(), {'x': x.grad.numpy(), 'w': w.grad.numpy(),
                                'b': b.grad.numpy()}


def test_gather_blocks_forward_gathers_and_backward_keeps_the_own_block(
        ops):
    """The consumer after a gather is replicated: each rank holds the
    whole cotangent, and its block's gradient is that block once (not
    summed over the ranks)."""
    inputs, ranks = ops
    for rank, out in enumerate(ranks):
        for dim in (0, 1):
            np.testing.assert_array_equal(out[f'gather_{dim}'],
                                          inputs['blocks'])
            per = inputs['blocks'].shape[dim] // 2
            want = np.take(inputs['blocks_w'],
                           range(rank * per, (rank + 1) * per), axis=dim)
            np.testing.assert_array_equal(out[f'gather_{dim}_grad'], want)


def test_column_conv_matches_the_dense_conv_and_its_gradients(ops):
    """Each rank convolves its block of output channels; with
    replicated_input at the input, dL/dx is summed over the ranks and
    equals the dense conv's; without it each rank holds only its share."""
    inputs, ranks = ops
    y, grads = _dense_conv(inputs)
    tol = dict(rtol=1e-5, atol=1e-5)
    for rank, out in enumerate(ranks):
        mine = slice(rank * 3, (rank + 1) * 3)
        np.testing.assert_allclose(out['column'], y, **tol)
        got = out['column_grads']
        np.testing.assert_allclose(got['x'], grads['x'], **tol)
        np.testing.assert_allclose(got['w'], grads['w'][mine], **tol)
        np.testing.assert_allclose(got['b'], grads['b'][mine], **tol)
        partial = out['no_replicated_input_grads']['x']
        assert np.abs(partial - grads['x']).max() > 1e-2
        # the conv of a layer whose bias stays whole beside a sharded
        # weight: the bias's gradient is summed over the ranks
        whole = out['replicated_bias']
        np.testing.assert_allclose(whole['x'], grads['x'], **tol)
        np.testing.assert_allclose(whole['w'], grads['w'][mine], **tol)
        np.testing.assert_allclose(whole['b'], grads['b'], **tol)


# ---------------------------------------------------------- train steps
def raw_batch(seed):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, T, M, 4), np.float32)
    cls = np.zeros((B, T, M), np.int32)
    valid = np.zeros((B, T, M), bool)
    for i in range(B):
        for j in range(T):
            for m in range(1 + (i + j) % 3):
                x1, y1 = rng.uniform(0, 40, 2)
                w, h = rng.uniform(6, 24, 2)
                boxes[i, j, m] = (x1, y1, x1 + w, y1 + h)
                cls[i, j, m] = rng.randint(TP_ENC['num_classes'])
                valid[i, j, m] = True
    return {'images_u8': rng.randint(0, 256, (B, T, 64, 64, 3)).astype(
                np.uint8),
            'boxes': boxes, 'cls': cls, 'valid': valid,
            'aug_seeds': np.arange(B, dtype=np.uint32)}


def _jax_init(seed, **kw):
    model = JTracker(**TP_MODEL, **kw)
    variables = numpy_tree(model.init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, T, 64, 64, 3))))
    return model, variables


@pytest.fixture(scope='module')
def tp(tmp_path_factory):
    jax_models = {head: _jax_init(i, **kw)
                  for i, (head, kw) in enumerate(TP_HEADS.items())}
    inputs = {'raw': raw_batch(0)}
    for head, (_, variables) in jax_models.items():
        inputs[head] = {k: v.numpy() for k, v in from_flax(variables).items()}
    two = run_world(tp_world, 2, tmp_path_factory.mktemp('tp2'), inputs,
                    [(1, 2)], timeout=240)
    four = run_world(tp_world, 4, tmp_path_factory.mktemp('tp4'), inputs,
                     [(2, 2), (1, 4)], timeout=240)
    ranks = {key: [r[key] for r in world] for world in (two, four)
             for key in world[0]}
    dense = {head: tp_steps(inputs[head], head, inputs['raw'])
             for head in TP_HEADS}
    return {'inputs': inputs, 'jax': jax_models, 'ranks': ranks,
            'dense': dense}


def _split(layout):
    mesh, head = layout.split('_')
    dp, tp = map(int, mesh.split('x'))
    return dp, tp, head


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_step_matches_the_dense_step_on_every_rank(tp, layout):
    """float64, the tensor-parallel run against the dense run on the same
    mesh: first step's metrics rtol 1e-5, gradients and the state after
    it (parameters and BatchNorm statistics) relative L2 <= 1e-5, and
    the global gradient norm of the clip (blocks summed over the model
    group) rtol 1e-5."""
    for rank, out in enumerate(tp['ranks'][layout]):
        errors = out['errors']
        assert errors['metrics'] <= 1e-5, (rank, errors)
        assert errors['grads'] <= 1e-5, (rank, errors)
        assert errors['step1'] <= 1e-5, (rank, errors)
        assert errors['norm'] <= 1e-5, (rank, errors)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_two_steps_match_the_dense_run(tp, layout):
    """float32, two steps against the single-process dense run: the dry
    run's bars (loss within 1e-2, update cosine >= 0.999, norm ratio
    within 5 %); the gathered state loads into the dense model."""
    _, _, head = _split(layout)
    run, ref = tp['ranks'][layout][0]['run'], tp['dense'][head]
    weights = tp['inputs'][head]
    loss, ref_loss = run['metrics'][0]['loss'], ref['metrics'][0]['loss']
    assert np.isfinite(loss) and abs(loss - ref_loss) < 1e-2 + 1e-2 * abs(
        ref_loss)
    names = sorted(dict(MultiObjDetTracker(**TP_MODEL, **TP_HEADS[head])
                        .named_parameters()))
    d = np.concatenate([(run['step2'][k] - weights[k]).ravel().astype(
        np.float64) for k in names])
    d_ref = np.concatenate([(ref['step2'][k] - weights[k]).ravel().astype(
        np.float64) for k in names])
    cos = d @ d_ref / (np.linalg.norm(d) * np.linalg.norm(d_ref))
    ratio = np.linalg.norm(d) / np.linalg.norm(d_ref)
    assert cos >= 0.999 and abs(ratio - 1.0) < 0.05, (cos, ratio)
    model = MultiObjDetTracker(**TP_MODEL, **TP_HEADS[head])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in run['step2'].items()})


def _jax_prepared(raw):
    enc = jax.vmap(jax.vmap(lambda b, c, v: jencode(
        b, c, v, ANCHORS, image_h=64, image_w=64, grid_h=2, grid_w=2,
        num_classes=TP_ENC['num_classes'], true_box_buffer=M)))
    y, tb = enc(raw['boxes'], raw['cls'], raw['valid'])
    return {'images': raw['images_u8'].astype(np.float32) / 255.0,
            'y_true': np.asarray(y), 'true_boxes': np.asarray(tb)}


@pytest.fixture(scope='module')
def jax_steps(tp):
    """JAX's dense joint loss and gradients on the global batch, per head,
    with the network in float64 (the loss stays float32, as yolo_loss
    casts)."""
    batch = _jax_prepared(tp['inputs']['raw'])
    batch['images'] = batch['images'].astype(np.float64)
    out = {}
    with jax.enable_x64(True):
        for head, kw in TP_HEADS.items():
            variables = tp['jax'][head][1]
            model = JTracker(**TP_MODEL, **kw, dtype=jnp.float64)
            params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), variables['params'])

            def loss(p, model=model, variables=variables):
                return jjoint_loss({'params': p,
                                    'batch_stats': variables['batch_stats']},
                                   model.apply, batch, ANCHORS, JLoss(),
                                   JJoint(), 0, train=True)
            (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
            out[head] = ({k: float(v) for k, v in metrics.items()},
                         params_from_flax(numpy_tree(grads)))
    return out


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_first_step_matches_jax_dense_step(tp, jax_steps, layout):
    """The gathered gradients and the metrics of the first
    tensor-parallel step, float32 and float64, against JAX's dense step
    on the same weights and batch with its network in float64: metrics
    rtol 1e-4, gradients per-leaf relative L2 <= 1e-3
    (tests/test_torch_steps.py's bars for a JAX step held in float64:
    XLA's float32 BatchNorm backward cancels in the deep 2x2 layers; at
    the MoE model's weights flax's float32 gradients lie 2.2e-2 from the
    port's float32 ones at norm_3.weight, and the port's are the ones
    within 1e-3 of float64)."""
    _, _, head = _split(layout)
    metrics, grads = jax_steps[head]
    for kind in ('run', 'run64'):
        run = tp['ranks'][layout][0][kind]
        for k, v in metrics.items():
            np.testing.assert_allclose(run['metrics'][0][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=f'{kind} {k}')
        assert set(run['grads']) == set(grads)
        for name, g in run['grads'].items():
            want = grads[name].double().numpy()
            err = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert err <= 1e-3, (kind, name, err)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_each_rank_holds_its_block_of_output_channels(tp, layout):
    """Every sharded leaf is held as 1/tp of its planned axis (a conv's
    output channels), the rest whole, on every rank; a rank's parameter
    bytes are the replicated bytes plus 1/tp of the sharded ones."""
    dp, size, head = _split(layout)
    weights = tp['inputs'][head]
    plan = plan_tp_specs({k: torch.from_numpy(v) for k, v in
                          weights.items()}, Mesh({'data': dp, 'model': size}),
                         min_params=TP_MIN_PARAMS)
    for out in tp['ranks'][layout]:
        summary = out['summary']
        for name, held in out['held'].items():
            shape = list(weights[name].shape)
            if plan[name] is not None:
                shape[plan[name]] //= size
            assert list(held) == shape, name
        assert plan['detector.conv_22.weight'] == 0
        assert out['held']['detector.conv_22.weight'][0] * size == \
            weights['detector.conv_22.weight'].shape[0]
        params = [v for k, v in weights.items() if 'running' not in k]
        assert out['dense_bytes'] == 4 * sum(v.size for v in params)
        stats = 4 * sum(v.size for k, v in weights.items()
                        if 'running' in k)
        assert out['bytes'] == (4 * summary['replicated'][1] - stats
                                + 4 * summary['sharded'][1] // size)
