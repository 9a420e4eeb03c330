"""Port parity of the joint train/eval steps, plain and fused, against the
JAX steps on the CPU.

Small size (width_div=8, 64x64 frames, T=3, B=2, 2 classes, 2 anchors,
ConvLSTM-8, float32), JAX weights carried by `convert.from_flax`, the
same seeded batch on both sides, augmentation off.

Tolerances, each with its reason:
- loss and every metric: rtol 1e-4, atol 1e-6. Batch-statistics
  BatchNorm amplifies float32 rounding through 22 layers (flax's own
  netout lies ~5e-5 from float64, test_torch_models.py::
  test_batch_stats_float32_error); the losses agree to ~2e-5.
- gradients: per-leaf relative L2 error <= 1e-3 against JAX's gradients
  of the same step; measured <= 2.1e-4 at init (BatchNorm scales and
  biases are the worst leaves).
- parameters after the step: per-leaf relative L2 <= 1e-3.
- running statistics after a step: rtol 1e-4, atol 1e-7 (a channel mean
  near 0 is a cancellation; the absolute errors measured are <= 7e-8).
- Adam on identical gradients: 1e-6 (`test_torch_train_state.py`).
- a JAX state trained 2 steps, carried over, then one more step on each
  side: the metrics and statistics as above, and the port's
  Adam step from the carried moments to 1e-6 of each moment's largest
  element (float32 rounding of 0.9·m + 0.1·g where the two cancel). Its
  gradients are held to JAX's at that state with the network in float64
  (`jax.enable_x64`; the loss stays float32, as yolo_loss casts): flax's
  float32 gradients lie up to 3.0e-2 from those (norm_3.weight), the
  port's 1.0e-5, and the two networks in float64 agree to 6e-8. The
  batch-statistics BatchNorm backward cancels in the deep 2x2 layers, and
  XLA's float32 evaluation of it loses more than the port's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import JointConfig as JJoint
from object_tracking_tpu.config import LossConfig as JLoss
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu.ops.targets import encode_targets as jencode
from object_tracking_tpu.training import TrainState as JState
from object_tracking_tpu.training import make_joint_eval_step as jeval
from object_tracking_tpu.training import make_joint_eval_step_fused as jevalf
from object_tracking_tpu.training import make_joint_train_step as jtrain
from object_tracking_tpu.training import make_joint_train_step_fused as jtrainf
from object_tracking_tpu.training import make_optimizer as jopt
from object_tracking_tpu.training.steps import _joint_loss as jjoint_loss
from object_tracking_tpu_torch.config import JointConfig, LossConfig
from object_tracking_tpu_torch.convert import (from_flax,
                                               load_flax_train_state,
                                               params_from_flax)
from object_tracking_tpu_torch.models import MultiObjDetTracker
from object_tracking_tpu_torch.training import (TrainState,
                                                make_joint_eval_step,
                                                make_joint_eval_step_fused,
                                                make_joint_train_step,
                                                make_joint_train_step_fused,
                                                make_optimizer)
from object_tracking_tpu_torch.training.steps import _joint_loss
from torch_parity import numpy_tree

B, T, NET, GRID, M = 2, 3, 64, 2, 5
ANCHORS = np.array([1.0, 1.0, 2.5, 2.0], np.float32)
SMALL = dict(num_classes=2, num_anchors=2, convlstm_features=8, width_div=8)
ENC = dict(net_h=NET, net_w=NET, grid_h=GRID, grid_w=GRID, num_classes=2,
           true_box_buffer=M)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_TOL = dict(rtol=1e-4, atol=1e-7)
GRAD_TOL = 1e-3
LR = 1e-3


def raw_batch(seed=0):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, T, M, 4), np.float32)
    cls = np.zeros((B, T, M), np.int32)
    valid = np.zeros((B, T, M), bool)
    for b in range(B):
        for t in range(T):
            for m in range(3):
                x1, y1 = rng.uniform(0, 40, 2)
                w, h = rng.uniform(6, 24, 2)
                boxes[b, t, m] = (x1, y1, x1 + w, y1 + h)
                cls[b, t, m] = rng.randint(2)
                valid[b, t, m] = True
    return {'images_u8': rng.randint(0, 256, (B, T, NET, NET, 3)).astype(
                np.uint8),
            'boxes': boxes, 'cls': cls, 'valid': valid,
            'aug_seeds': np.arange(B, dtype=np.uint32)}


def prepared(raw):
    """The legacy batch of the same pixels and boxes, encoded by JAX."""
    enc = jax.vmap(jax.vmap(lambda b, c, v: jencode(
        b, c, v, ANCHORS, image_h=NET, image_w=NET, grid_h=GRID,
        grid_w=GRID, num_classes=2, true_box_buffer=M)))
    y, tb = enc(raw['boxes'], raw['cls'], raw['valid'])
    return {'images': raw['images_u8'].astype(np.float32) / 255.0,
            'y_true': np.asarray(y), 'true_boxes': np.asarray(tb)}


@pytest.fixture(scope='module')
def jax_model():
    model = JTracker(**SMALL)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, T, NET, NET, 3)))
    return model, numpy_tree(variables)


def jax_state(jax_model):
    model, variables = jax_model
    return JState.create(model.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(LR))


def port_state(jax_model, **kw):
    model = MultiObjDetTracker(**SMALL, **kw)
    model.load_state_dict(from_flax(jax_model[1]), strict=True)
    return TrainState.create(model, make_optimizer(LR))


def close_metrics(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].dtype == torch.float32 and port[k].dim() == 0
        np.testing.assert_allclose(float(port[k]), float(ref[k]),
                                   err_msg=k, **METRIC_TOL)


def close_stats(model, ref_stats):
    """The module's running statistics against a flax batch_stats tree."""
    for name, buf in model.named_buffers():
        module, leaf = name.rsplit('.', 1)
        node = ref_stats
        for part in module.split('.'):
            node = node[part]
        want = np.asarray(node['mean' if leaf == 'running_mean' else 'var'])
        np.testing.assert_allclose(buf.numpy(), want, err_msg=name,
                                   **STATS_TOL)


def jax_grads(model, variables, batch, step):
    """JAX's gradients of the joint loss (the train steps' loss) at
    `variables` on a prepared batch, as the port's parameter names, and
    the loss's metrics and batch statistics."""
    def loss(p):
        return jjoint_loss({'params': p,
                            'batch_stats': variables['batch_stats']},
                           model.apply, batch, ANCHORS, JLoss(), JJoint(),
                           step, train=True)
    (_, (metrics, updates)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    return params_from_flax(numpy_tree(grads)), metrics, updates


def assert_leaves_close(port: dict, ref: dict, tol: float = GRAD_TOL):
    """Per-leaf relative L2 error of `port` against `ref`, each <= tol."""
    assert set(port) == set(ref)
    for name, got in port.items():
        want = ref[name].double()
        err = float((got.double() - want).norm() / want.norm())
        assert err <= tol, (name, err)


def test_gradients_and_stats_match_jax(jax_model):
    """The joint loss's gradients (per-leaf relative L2 <= 1e-3) and the
    running statistics one train-mode forward writes (rtol 1e-4)."""
    model, variables = jax_model
    batch = prepared(raw_batch())
    ref_grads, ref_metrics, updates = jax_grads(model, variables, batch, 0)
    state = port_state(jax_model)
    state.model.train()
    tloss, metrics = _joint_loss(
        state.model, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(ANCHORS), LossConfig(), JointConfig(), 0, True)
    tloss.backward()
    close_metrics(metrics, ref_metrics)
    assert_leaves_close({n: p.grad for n, p in
                         state.model.named_parameters()}, ref_grads)
    close_stats(state.model, updates['batch_stats'])


@pytest.mark.parametrize('fused', [False, True])
def test_train_step_matches_jax(jax_model, fused):
    """One train step on each side from the same weights: the metrics,
    the gradients the step took (per-leaf relative L2 <= 1e-3 against
    JAX's gradients of that step; the fused step's /255 and encoding run
    on the port's side), the parameters after Adam (per-leaf relative L2
    <= 1e-3) and the running statistics (rtol 1e-4)."""
    raw = raw_batch()
    ref_state = jax_state(jax_model)
    state = port_state(jax_model)
    if fused:
        ref_step = jtrainf(ANCHORS, augment=False, **ENC)
        step = make_joint_train_step_fused(ANCHORS, augment=False, **ENC)
        batch = raw
    else:
        ref_step, step = jtrain(ANCHORS), make_joint_train_step(ANCHORS)
        batch = prepared(raw)
    # the fused JAX step prepares the raw batch as `prepared` does
    ref_grads = jax_grads(jax_model[0], jax_model[1], prepared(raw), 0)[0]
    ref_state, ref_metrics = ref_step(ref_state, batch)
    state, metrics = step(state, batch)
    close_metrics(metrics, ref_metrics)
    assert state.step == int(ref_state.step) == 1
    params = dict(state.model.named_parameters())
    assert_leaves_close({n: p.grad for n, p in params.items()}, ref_grads)
    assert_leaves_close({n: p.detach() for n, p in params.items()},
                        params_from_flax(numpy_tree(ref_state.params)))
    close_stats(state.model, numpy_tree(ref_state.batch_stats))


def carried(jax_model, steps=2):
    """A JAX state after `steps` fused steps, the numpy pieces of it that
    load_flax_train_state takes, and the next batch."""
    raws = [raw_batch(s) for s in range(steps + 1)]
    ref_step = jtrainf(ANCHORS, augment=False, **ENC)
    ref_state = jax_state(jax_model)
    for raw in raws[:steps]:
        ref_state, _ = ref_step(ref_state, raw)
    adam = ref_state.opt_state.inner_state[0]
    pieces = jax.tree_util.tree_map(np.asarray, {
        'step': ref_state.step, 'params': ref_state.params,
        'batch_stats': ref_state.batch_stats, 'count': adam.count,
        'mu': adam.mu, 'nu': adam.nu,
        'learning_rate': ref_state.opt_state.hyperparams['learning_rate']})
    return ref_state, ref_step, pieces, raws[steps]


def jax_float64_grads(variables, batch, step):
    """JAX's gradients of the joint loss with the network in float64
    (yolo_loss still casts its input to float32), as the port's names."""
    with jax.enable_x64(True):
        model = JTracker(**SMALL, dtype=jnp.float64)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables['params'])
        grads = jax_grads(model, {'params': params,
                                  'batch_stats': variables['batch_stats']},
                          {k: np.asarray(v, np.float64) if k == 'images'
                           else v for k, v in batch.items()}, step)[0]
    return grads


def test_carried_jax_state_continues_the_trajectory(jax_model):
    """A JAX state after 2 fused steps, carried into the port by
    load_flax_train_state, then one more step on each side: the same
    metrics and statistics; the step's gradients within 1e-3 of JAX's
    float64 ones; and Adam continues from the carried moments and count.
    (The parameters are not held to the JAX step's: its Adam moments take
    flax's float32 gradients, 3 % off at this state, and a BatchNorm bias
    of three steps' size then moves ~0.8 % otherwise.)"""
    ref_state, ref_step, pieces, raw = carried(jax_model)
    exact = jax_float64_grads({'params': pieces['params'],
                               'batch_stats': pieces['batch_stats']},
                              prepared(raw), 2)
    state = load_flax_train_state(port_state(jax_model), **pieces)
    assert state.step == 2 and state.learning_rate == pytest.approx(LR)
    mu, nu = params_from_flax(pieces['mu']), params_from_flax(pieces['nu'])
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}

    ref_state, ref_metrics = ref_step(ref_state, raw)
    state, metrics = make_joint_train_step_fused(
        ANCHORS, augment=False, **ENC)(state, raw)
    close_metrics(metrics, ref_metrics)
    assert state.step == int(ref_state.step) == 3
    close_stats(state.model, numpy_tree(ref_state.batch_stats))
    params = dict(state.model.named_parameters())
    assert_leaves_close({n: p.grad for n, p in params.items()}, exact)
    for name, p in params.items():
        opt, g = state.optimizer.state[p], p.grad
        assert float(opt['step']) == 3
        m = 0.9 * mu[name] + 0.1 * g
        v = 0.999 * nu[name] + 0.001 * g * g
        for got, want in ((opt['exp_avg'], m), (opt['exp_avg_sq'], v)):
            assert float((got - want).abs().max()) <= \
                1e-6 * float(want.abs().max()), name
        update = -LR * (m / (1 - 0.9 ** 3)) / (
            torch.sqrt(v / (1 - 0.999 ** 3)) + 1e-7)
        # torch's Adam takes sqrt(v)/sqrt(1-b2^t): another rounding
        torch.testing.assert_close(p.detach() - before[name], update,
                                   rtol=1e-4, atol=1e-4 * LR)


def test_float32_gradients_no_further_from_float64_than_flax(jax_model):
    """Why the carried state's gradients are held to float64: there the
    port's float32 gradients lie within 1e-4 of JAX's float64 ones, leaf
    by leaf no further than flax's float32 gradients (up to 3.0e-2 off,
    measured), on the same weights and batch."""
    model, _ = jax_model
    _, _, pieces, raw = carried(jax_model)
    batch = prepared(raw)
    variables = {'params': pieces['params'],
                 'batch_stats': pieces['batch_stats']}
    exact = jax_float64_grads(variables, batch, 2)
    flax32 = jax_grads(model, variables, batch, 2)[0]
    net = MultiObjDetTracker(**SMALL)
    net.load_state_dict(from_flax(variables))
    net.train()
    tloss, _ = _joint_loss(
        net, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(ANCHORS), LossConfig(), JointConfig(), 2, True)
    tloss.backward()
    for name, p in net.named_parameters():
        want = exact[name].double()
        port_err = float((p.grad.double() - want).norm() / want.norm())
        flax_err = float((flax32[name].double() - want).norm() / want.norm())
        assert port_err <= 1e-4, (name, port_err)
        assert port_err <= max(flax_err, 2e-5), (name, port_err, flax_err)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('use_batch_stats', [True, False])
def test_eval_step_matches_jax_and_writes_nothing(jax_model, fused,
                                                  use_batch_stats):
    raw = raw_batch()
    ref_state = jax_state(jax_model)
    state = port_state(jax_model)
    if fused:
        ref = jevalf(ANCHORS, use_batch_stats=use_batch_stats, **ENC)(
            ref_state, raw)
        step = make_joint_eval_step_fused(
            ANCHORS, use_batch_stats=use_batch_stats, **ENC)
        batch = raw
    else:
        ref = jeval(ANCHORS, use_batch_stats=use_batch_stats)(
            ref_state, prepared(raw))
        step = make_joint_eval_step(ANCHORS, use_batch_stats=use_batch_stats)
        batch = prepared(raw)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    close_metrics(step(state, batch), ref)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.step == 0


def test_remat_same_gradients_and_stats(jax_model):
    """remat recomputes the detector in backward: the same gradients and
    running statistics as without it (statistics written once)."""
    batch = {k: torch.from_numpy(v) for k, v in prepared(raw_batch()).items()}
    grads, stats = [], []
    for remat in (False, True):
        state = port_state(jax_model, remat=remat)
        state.model.train()
        loss, _ = _joint_loss(state.model, batch, torch.from_numpy(ANCHORS),
                              LossConfig(), JointConfig(), 0, True)
        loss.backward()
        grads.append({n: p.grad for n, p in state.model.named_parameters()})
        stats.append({n: b.clone() for n, b in state.model.named_buffers()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6,
                                   atol=1e-9)
    for n in stats[0]:
        assert torch.equal(stats[1][n], stats[0][n]), n


def test_fused_augmented_bfloat16_step(jax_model):
    """The fused step with augmentation, in bfloat16 compute: finite float32
    metrics, one step counted, the running statistics moved."""
    state = port_state(jax_model, dtype=torch.bfloat16)
    before = state.model.detector.norm_1.running_mean.clone()
    step = make_joint_train_step_fused(ANCHORS, augment=True, **ENC)
    state, metrics = step(state, raw_batch())
    assert state.step == 1
    assert all(v.dtype == torch.float32 and torch.isfinite(v)
               for v in metrics.values())
    assert not torch.equal(state.model.detector.norm_1.running_mean, before)
