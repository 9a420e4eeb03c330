"""The standalone detector, multi-head cfg and single-object tracker steps
over a data axis of 2 gloo ranks, against JAX's steps on a 2-device CPU
mesh and against the port's one-rank step.

Small size: Darknet-19 at width_div=8, 64², 2 classes, 2 anchors, random
BatchNorm scales, biases and statistics, B=4; the two-[yolo]-head cfg of
tests/test_darknet_cfg.py at 64², B=4; TinyTracker LSTM-16 over
(B=4, T=3, 4x4x8) features with the bbox head (bce, huber) and the
heatmap head (bce). Weights are JAX's, carried by `convert.from_flax`.
One spawned world of 2 ranks (`torch_ranks.dp_world`) runs every case:
two steps, each rank on its half of two global batches, and a ragged
case (B=3 on 2 ranks: `shard_batch` replicates it, and every rank runs
the one-rank step).

Tolerances, those of tests/test_torch_data_parallel.py:
- the first step's metrics against JAX's on the 2-device mesh: rtol 1e-4;
- the first step's gradients (summed over the group) against JAX's:
  per-leaf relative L2 <= 1e-3;
- the two-step update against the one-rank port step's: cosine > 0.999
  and norm ratio within 5 %; the first step's running statistics
  rtol 1e-4, atol 1e-7;
- the ragged case against the one-rank port step at the same bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from object_tracking_tpu.config import DetectorConfig as JDetectorConfig
from object_tracking_tpu.config import MeshConfig as JMeshConfig
from object_tracking_tpu.models import TinyTracker as JTiny
from object_tracking_tpu.models import YOLOv2Detector as JYOLO
from object_tracking_tpu.models.darknet_cfg import build_from_cfg as jbuild
from object_tracking_tpu.models.darknet_cfg import head_specs as jhead_specs
from object_tracking_tpu.models.losses import yolo_loss as jyolo_loss
from object_tracking_tpu.ops.targets import (
    encode_targets_multiscale as jencode_ms)
from object_tracking_tpu.parallel import make_mesh as jmake_mesh
from object_tracking_tpu.parallel import shard_batch as jshard
from object_tracking_tpu.training.steps import _tiny_loss as jtiny_loss
from object_tracking_tpu_torch.config import LossConfig
from object_tracking_tpu_torch.convert import from_flax, params_from_flax
from object_tracking_tpu_torch.training.steps import head_anchor_cells
from tests.test_darknet_cfg import V3_CFG
from tests.test_torch_detector_steps import ANCHORS, det_batch
from torch_parity import numpy_tree, randomize_bn
from torch_ranks import dp_two_steps, dp_world, run_world

N = 2
NET = 64
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_TOL = dict(rtol=1e-4, atol=1e-7)
LEAF_TOL = 1e-3
V3_64 = V3_CFG.replace('height=32\nwidth=32', f'height={NET}\nwidth={NET}')
FEAT = (4, 4, 8)
TINY = {'tiny_bce': (False, 'bce'), 'tiny_huber': (False, 'huber'),
        'tiny_heatmap': (True, 'bce')}


def _weights(variables) -> dict:
    return {k: v.numpy() for k, v in from_flax(variables).items()}


def _loss_kw() -> dict:
    cfg = LossConfig()
    return dict(warm_up_batches=cfg.warm_up_batches,
                object_scale=cfg.object_scale,
                no_object_scale=cfg.no_object_scale,
                coord_scale=cfg.coord_scale, class_scale=cfg.class_scale,
                best_iou_threshold=cfg.best_iou_threshold)


def _detector():
    jdet = JYOLO(JDetectorConfig(
        labels=('a', 'b'), image_h=NET, image_w=NET, grid_h=NET // 32,
        grid_w=NET // 32, width_div=8, num_anchors=2,
        anchors=tuple(ANCHORS)))
    variables = randomize_bn(jdet.variables, np.random.RandomState(0))

    def loss(params, batch):
        out, _ = jdet.module.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch['images'], train=True, mutable=['batch_stats'])
        value, aux = jyolo_loss(out['netout'], batch['y_true'],
                                batch['true_boxes'], ANCHORS, 0,
                                **_loss_kw())
        return value, {k: aux[k] for k in ('loss', 'recall', 'loss_xy',
                                           'loss_wh', 'loss_conf',
                                           'loss_class')}

    case = {'kind': 'detector', 'weights': _weights(variables),
            'anchors': ANCHORS, 'lr': 1e-4,
            'batches': [det_batch(s, b=4, grid=NET // 32) for s in (1, 2)]}
    return case, variables['params'], loss


def _multihead_batch(seed, heads, b=4):
    rng = np.random.RandomState(seed)
    base = np.asarray([[6.0, 4.0, 44.0, 60.0], [4.0, 4.0, 60.0, 52.0],
                       [16.0, 16.0, 28.0, 26.0]], np.float32)
    boxes = np.tile(base, (b, 1, 1)) + rng.uniform(0, 2, (b, 3, 4)).astype(
        np.float32)
    cls = np.tile(np.asarray([0, 1, 1], np.int32), (b, 1))
    valid = np.ones((b, 3), bool)
    ys, bs = jax.vmap(lambda bx, c, v: jencode_ms(
        bx, c, v, heads, image_h=NET, image_w=NET, true_box_buffer=4))(
        boxes, cls, valid)
    return {'images': rng.rand(b, NET, NET, 3).astype(np.float32),
            'y_true': tuple(np.asarray(y) for y in ys),
            'true_boxes': tuple(np.asarray(t) for t in bs)}


def _multihead():
    jmodel, _ = jbuild(V3_64)
    variables = randomize_bn(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, NET, NET, 3))),
        np.random.RandomState(1))
    shapes = jax.eval_shape(
        lambda x: jmodel.apply(variables, x, train=False),
        jax.ShapeDtypeStruct((1, NET, NET, 3), jnp.float32))
    heads = tuple((tuple(float(v) for v in np.asarray(
        s['anchors'], np.float32).reshape(-1)), int(h.shape[1]),
        int(h.shape[2]), s['num_classes'])
        for s, h in zip(jhead_specs(jmodel.plan), shapes['heads']))
    cells = head_anchor_cells(heads, (NET, NET))

    def loss(params, batch):
        out, _ = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch['images'], train=True, mutable=['batch_stats'])
        total, metrics, recalls = 0.0, {}, []
        for i, anchors in enumerate(cells):
            value, aux = jyolo_loss(out['heads'][i], batch['y_true'][i],
                                    batch['true_boxes'][i], anchors, 0,
                                    **_loss_kw())
            total = total + value
            for k in ('loss', 'loss_xy', 'loss_wh', 'loss_conf',
                      'loss_class'):
                metrics[k] = metrics.get(k, 0.0) + aux[k]
            recalls.append(aux['recall'])
        metrics['recall'] = sum(recalls) / len(recalls)
        return total, metrics

    case = {'kind': 'multihead', 'weights': _weights(variables),
            'cfg': V3_64, 'heads': heads, 'net': (NET, NET), 'lr': 1e-4,
            'batches': [_multihead_batch(s, heads) for s in (3, 4)]}
    return case, variables['params'], loss


def _tiny_batch(seed, out, continuous, b=4, t=3):
    rng = np.random.RandomState(seed)
    det = rng.rand(b, t, out).astype(np.float32)
    det[1, 2] = 0.0                                   # one missed frame
    target = (rng.rand(b, t, out) * 0.6 + 0.2 if continuous
              else rng.rand(b, t, out) > 0.5).astype(np.float32)
    return {'feats': rng.rand(b, t, *FEAT).astype(np.float32),
            'det': det, 'target': target}


def _tiny(name):
    heatmap, loss_name = TINY[name]
    out = 16 if heatmap else 4
    model = JTiny(lstm_units=16, out_dim=out)
    batches = [_tiny_batch(s, out, loss_name == 'huber') for s in (5, 6)]
    variables = numpy_tree(dict(model.init(
        jax.random.PRNGKey(2), batches[0]['feats'], batches[0]['det'])))

    def loss(params, batch):
        return jtiny_loss({'params': params}, model.apply, batch, heatmap,
                          loss_name)

    case = {'kind': 'tiny', 'weights': _weights(variables), 'feat': FEAT,
            'out': out, 'heatmap': heatmap, 'loss': loss_name, 'lr': 1e-2,
            'batches': batches}
    return case, variables['params'], loss


CASES = ['detector', 'multihead', *TINY]


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    built = {'detector': _detector(), 'multihead': _multihead(),
             **{name: _tiny(name) for name in TINY}}
    cases = {name: b[0] for name, b in built.items()}
    ragged = dict(cases['detector'])
    ragged['batches'] = [det_batch(s, b=3, grid=NET // 32) for s in (7, 8)]
    cases['detector_ragged'] = ragged
    ranks = run_world(dp_world, N, tmp_path_factory.mktemp('dp_steps'),
                      cases, timeout=240)
    return {'cases': cases, 'jax': {k: b[1:] for k, b in built.items()},
            'ranks': ranks, 'one_rank': {}}


def one_rank(run, name):
    """The port's one-rank step on the global batches (memoised)."""
    if name not in run['one_rank']:
        run['one_rank'][name] = dp_two_steps(run['cases'][name])
    return run['one_rank'][name]


def rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _jax_step(run, name):
    """JAX's first-step metrics and gradients on the 2-device mesh (the
    global batch sharded over it)."""
    params, loss = run['jax'][name]
    mesh = jmake_mesh(JMeshConfig(data_parallel=N), jax.devices()[:N])
    batch = jshard(mesh, run['cases'][name]['batches'][0])
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, batch)
    return ({k: float(v) for k, v in metrics.items()},
            params_from_flax(numpy_tree(grads)))


@pytest.mark.parametrize('name', CASES)
def test_dp_step_matches_jax_on_a_two_device_mesh(run, name):
    """Each rank's first-step metrics (the global ones) and its gradients
    summed over the group against JAX's loss and gradients on the sharded
    global batch; the tiny eval step's metrics too."""
    metrics, grads = _jax_step(run, name)
    for out in run['ranks']:
        got = out[name]
        assert set(got['metrics'][0]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got['metrics'][0][k], v,
                                       err_msg=f'{name} {k}', **METRIC_TOL)
            if 'eval' in got:
                np.testing.assert_allclose(got['eval'][k], v,
                                           err_msg=f'{name} eval {k}',
                                           **METRIC_TOL)
        assert set(got['grads']) == set(grads)
        for k, want in grads.items():
            err = rel_l2(got['grads'][k], want.double().numpy())
            assert err <= LEAF_TOL, (name, k, err)
    if name.startswith('tiny'):
        assert all('eval' in out[name] for out in run['ranks'])


def _delta(params, weights):
    return np.concatenate([(params[k] - weights[k].astype(np.float64))
                           .ravel() for k in sorted(params)])


@pytest.mark.parametrize('name', CASES + ['detector_ragged'])
def test_dp_update_matches_one_rank_step(run, name):
    """The two-step update of every parameter against the one-rank port
    step's on the global batches (cosine > 0.999, norm ratio within 5 %),
    the first step's metrics (rtol 1e-4) and running statistics."""
    ref = one_rank(run, name)
    w = run['cases'][name]['weights']
    d_ref = _delta(ref['params'], w)
    for out in run['ranks']:
        got = out[name]
        for k, v in ref['metrics'][0].items():
            np.testing.assert_allclose(got['metrics'][0][k], v,
                                       err_msg=f'{name} {k}', **METRIC_TOL)
        for k, v in ref['stats'].items():
            np.testing.assert_allclose(got['stats'][k], v,
                                       err_msg=f'{name} {k}', **STATS_TOL)
        d = _delta(got['params'], w)
        cos = d @ d_ref / (np.linalg.norm(d) * np.linalg.norm(d_ref))
        ratio = np.linalg.norm(d) / np.linalg.norm(d_ref)
        assert cos > 0.999 and abs(ratio - 1.0) < 0.05, (name, cos, ratio)


def test_each_rank_steps_on_half_the_batch_to_the_same_weights(run):
    """Each rank's step saw B/2 of every global batch (a slice, not a
    replica), the ranks report the same metrics and end on the same
    weights."""
    first = run['ranks'][0]
    for name in CASES:
        global_b = [len(next(iter(b.values())))
                    for b in run['cases'][name]['batches']]
        for out in run['ranks']:
            assert out[name]['local_batch'] == [b // N for b in global_b]
            assert out[name]['replicated'] == [False, False]
            assert out[name]['metrics'] == first[name]['metrics'], name
            for k, v in first[name]['params'].items():
                np.testing.assert_array_equal(out[name]['params'][k], v,
                                              err_msg=f'{name} {k}')


def test_ragged_batch_runs_the_one_rank_step(run):
    """B=3 on 2 ranks: shard_batch replicates it and every rank runs the
    one-rank step on the whole batch, with no group: its gradients and
    parameters are the one-rank step's (relative L2 <= 1e-3)."""
    ref = one_rank(run, 'detector_ragged')
    for out in run['ranks']:
        got = out['detector_ragged']
        assert got['local_batch'] == [3, 3]
        assert got['replicated'] == [True, True]
        for k, v in ref['grads'].items():
            assert rel_l2(got['grads'][k], v) <= LEAF_TOL, k
        for k, v in ref['params'].items():
            assert rel_l2(got['params'][k], v) <= LEAF_TOL, k
