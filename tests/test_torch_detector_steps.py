"""Port parity of the single-object tracker steps and the standalone
detector steps against the JAX steps on the CPU, two steps each from the
same weights (carried by `convert.from_flax`) on the same batches.

Small sizes: TinyTracker LSTM-16 over (B=2, T=3, 4x4x8) features;
Darknet-19 at width_div=8, 64², B=4, 2 classes, random BatchNorm scales,
biases and statistics (so that Adam's first step does not start from
zero parameters, where an element whose gradient is near Adam's eps moves
by a rounding-dependent fraction of lr); VGG16 at width_div=8, 64², fc
128, its dense head over 2 classes; the two-[yolo]-head cfg of
tests/test_darknet_cfg.py at 32².

Tolerances (those of tests/test_torch_steps.py):
- every metric: rtol 1e-4, atol 1e-6;
- each step's gradients: per-leaf relative L2 <= 1e-3 against JAX's
  gradients of that step's loss at JAX's state;
- parameters after each Adam step: per-leaf relative L2 <= 1e-3;
- running statistics after each step: rtol 1e-4, atol 1e-7.
The BatchNorm models' second step starts from JAX's state after the
first, carried by `convert.load_flax_train_state` (see `run_pair`).
The slice as a whole: the JAX `TrackerSequenceBatches(FakeDetector)` →
`make_tiny_train_step` against the port's, the same seed and folder.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import DetectorConfig as JDetectorConfig
from object_tracking_tpu.data import TrackerSequenceBatches as JTracker
from object_tracking_tpu.data import make_sequence_windows as jwindows
from object_tracking_tpu.data import parse_annotation_dir as jparse
from object_tracking_tpu.models import FakeDetector as JFake
from object_tracking_tpu.models import TinyTracker as JTiny
from object_tracking_tpu.models import VGG16PriorSource as JVGG
from object_tracking_tpu.models import YOLOv2Detector as JYOLO
from object_tracking_tpu.models.darknet_cfg import build_from_cfg as jbuild
from object_tracking_tpu.models.losses import yolo_loss as jyolo_loss
from object_tracking_tpu.ops.targets import encode_targets as jencode
from object_tracking_tpu.ops.targets import (
    encode_targets_multiscale as jencode_ms)
from object_tracking_tpu.training import TrainState as JState
from object_tracking_tpu.training import make_detector_train_step as jdet
from object_tracking_tpu.training import make_multihead_detector_train_step \
    as jmulti
from object_tracking_tpu.training import make_optimizer as jopt
from object_tracking_tpu.training import make_tiny_eval_step as jtiny_eval
from object_tracking_tpu.training import make_tiny_train_step as jtiny
from object_tracking_tpu.training.steps import _tiny_loss as jtiny_loss
from object_tracking_tpu_torch.config import LossConfig
from object_tracking_tpu_torch.convert import (from_flax,
                                               load_flax_train_state,
                                               params_from_flax)
from object_tracking_tpu_torch.data import (TrackerSequenceBatches,
                                            make_sequence_windows,
                                            parse_annotation_dir)
from object_tracking_tpu_torch.data.generators import _default_loader
from object_tracking_tpu_torch.data.synthetic import make_synthetic_dataset
from object_tracking_tpu_torch.models import (Darknet19, FakeDetector,
                                              TinyTracker, VGG16PriorSource)
from object_tracking_tpu_torch.models.darknet_cfg import (build_from_cfg,
                                                          head_grids)
from object_tracking_tpu_torch.models.vgg16 import VGG_DET_ANCHOR
from object_tracking_tpu_torch.training import (
    TrainState, make_detector_train_step, make_multihead_detector_train_step,
    make_optimizer, make_tiny_eval_step, make_tiny_train_step)
from object_tracking_tpu_torch.training.steps import head_anchor_cells
from tests.test_darknet_cfg import V3_CFG
from torch_parity import numpy_tree, randomize_bn

METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_TOL = dict(rtol=1e-4, atol=1e-7)
LEAF_TOL = 1e-3
LR = 1e-4
NET = 64
ANCHORS = np.array([1.0, 1.0, 2.5, 2.0], np.float32)


def close_metrics(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].dtype == torch.float32 and port[k].dim() == 0
        np.testing.assert_allclose(float(port[k]), float(ref[k]),
                                   err_msg=k, **METRIC_TOL)


def rel_l2(got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm() / max(float(want.norm()),
                                                    1e-30))


def leaves_close(port: dict, ref: dict, prefix: str = ''):
    """Per-leaf relative L2 of the port's leaves (names with `prefix`)
    against JAX's; a port leaf without a gradient must be zero in JAX."""
    assert {prefix + n for n in ref} == set(port)
    for name, want in ref.items():
        got = port[prefix + name]
        if got is None:
            assert not want.any(), name
            continue
        err = rel_l2(got, want)
        assert err <= LEAF_TOL, (name, err)


def grads_of(model):
    return {n: p.grad for n, p in model.named_parameters()}


def params_of(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def close_stats(model, ref_stats):
    for name, buf in model.named_buffers():
        module, leaf = name.rsplit('.', 1)
        node = ref_stats
        for part in module.split('.'):
            node = node[part]
        want = np.asarray(node['mean' if leaf == 'running_mean' else 'var'])
        np.testing.assert_allclose(buf.numpy(), want, err_msg=name,
                                   **STATS_TOL)


def carried(ref_state) -> dict:
    """The numpy pieces of a JAX TrainState that load_flax_train_state
    takes."""
    adam = ref_state.opt_state.inner_state[0]
    return jax.tree_util.tree_map(np.asarray, {
        'step': ref_state.step, 'params': ref_state.params,
        'batch_stats': ref_state.batch_stats or {}, 'count': adam.count,
        'mu': adam.mu, 'nu': adam.nu,
        'learning_rate': ref_state.opt_state.hyperparams['learning_rate']})


def run_pair(ref_state, ref_step, ref_grad, state, step, batches,
             prefix='', stats=False, carry=False):
    """Two steps on each side: metrics, the step's gradients against JAX's
    at JAX's state, the parameters after Adam, the statistics. With
    `carry`, the second step starts from JAX's state after the first
    (weights, statistics and Adam's moments, by load_flax_train_state),
    so that each step is held to JAX's from the same state: through 22
    batch-statistics BatchNorm layers two float32 trajectories part by
    more than the statistics' tolerance within two steps."""
    for i, batch in enumerate(batches):
        if carry and i:
            state = load_flax_train_state(state, **carried(ref_state))
        want_grads = params_from_flax(numpy_tree(ref_grad(ref_state, batch)))
        ref_state, ref_metrics = ref_step(ref_state, batch)
        state, metrics = step(state, batch)
        close_metrics(metrics, ref_metrics)
        assert state.step == int(ref_state.step) == i + 1
        leaves_close(grads_of(state.model), want_grads, prefix)
        leaves_close(params_of(state.model),
                     params_from_flax(numpy_tree(ref_state.params)), prefix)
        if stats:
            close_stats(state.model, numpy_tree(ref_state.batch_stats))
    return state, ref_state


# ------------------------------------------------------------ tiny tracker
def tiny_batch(seed, out, continuous):
    rng = np.random.RandomState(seed)
    det = rng.rand(2, 3, out).astype(np.float32)
    det[1, 2] = 0.0                                   # one missed frame
    target = (rng.rand(2, 3, out) * 0.6 + 0.2 if continuous
              else rng.rand(2, 3, out) > 0.5).astype(np.float32)
    return {'feats': rng.rand(2, 3, 4, 4, 8).astype(np.float32),
            'det': det, 'target': target}


TINY = [('bbox', 'bce', False), ('bbox', 'huber', False),
        ('bbox', 'huber', True), ('heatmap', 'bce', False),
        ('heatmap', 'huber', False)]


def tiny_pair(out, residual, seed=0):
    model = JTiny(lstm_units=16, out_dim=out, residual_det=residual)
    b = tiny_batch(0, out, False)
    variables = flax.core.unfreeze(numpy_tree(dict(model.init(
        jax.random.PRNGKey(seed), b['feats'], b['det']))))
    net = TinyTracker((4, 4, 8), lstm_units=16, out_dim=out,
                      residual_det=residual)
    net.load_state_dict(from_flax(variables), strict=True)
    return model, variables, net


@pytest.mark.parametrize('head,loss,residual', TINY)
def test_tiny_train_step_matches_jax(head, loss, residual):
    heatmap = head == 'heatmap'
    out = 16 if heatmap else 4
    model, variables, net = tiny_pair(out, residual)
    ref_state = JState.create(model.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-2))

    def ref_grad(st, batch):
        return jax.grad(lambda p: jtiny_loss(
            {'params': p}, st.apply_fn, batch, heatmap, loss)[0])(st.params)

    batches = [tiny_batch(s, out, loss == 'huber') for s in (1, 2)]
    run_pair(ref_state, jtiny(heatmap, loss), ref_grad,
             TrainState.create(net, make_optimizer(1e-2)),
             make_tiny_train_step(heatmap, loss), batches)


@pytest.mark.parametrize('heatmap', [False, True])
def test_tiny_eval_step_matches_jax_and_writes_nothing(heatmap):
    out = 16 if heatmap else 4
    model, variables, net = tiny_pair(out, False)
    batch = tiny_batch(3, out, False)
    ref = jtiny_eval(heatmap)(JState.create(
        model.apply, jax.tree_util.tree_map(jnp.asarray, variables),
        jopt(1e-3)), batch)
    state = TrainState.create(net, make_optimizer(1e-3))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    metrics = make_tiny_eval_step(heatmap)(state, batch)
    close_metrics(metrics, ref)
    assert ('heatmap_acc' in metrics) == heatmap
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k])
    assert state.step == 0


def test_tiny_steps_refuse_unknown_loss():
    with pytest.raises(ValueError, match='unknown tracker loss'):
        make_tiny_train_step(loss_name='l2')
    with pytest.raises(ValueError, match='unknown tracker loss'):
        make_tiny_eval_step(loss_name='l2')


# ----------------------------------------------------------------- detector
def det_batch(seed, b=4, grid=2, anchors=ANCHORS, classes=2, m=5):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, m, 4), np.float32)
    cls = np.zeros((b, m), np.int32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        for k in range(3):
            x1, y1 = rng.uniform(0, 40, 2)
            w, h = rng.uniform(8, 24, 2)
            boxes[i, k] = (x1, y1, x1 + w, y1 + h)
            cls[i, k] = rng.randint(classes)
            valid[i, k] = True
    y, tb = jax.vmap(lambda bx, c, v: jencode(
        bx, c, v, anchors, image_h=NET, image_w=NET, grid_h=grid,
        grid_w=grid, num_classes=classes, true_box_buffer=m))(
        boxes, cls, valid)
    return {'images': rng.rand(b, NET, NET, 3).astype(np.float32),
            'y_true': np.asarray(y), 'true_boxes': np.asarray(tb)}


def jax_det_grad(anchors):
    cfg = LossConfig()

    def grad(st, batch):
        def loss(p):
            out, _ = st.apply_fn(
                {'params': p, 'batch_stats': st.batch_stats},
                batch['images'], train=True, mutable=['batch_stats'])
            return jyolo_loss(
                out['netout'], batch['y_true'], batch['true_boxes'],
                np.asarray(anchors, np.float32), st.step,
                warm_up_batches=cfg.warm_up_batches,
                object_scale=cfg.object_scale,
                no_object_scale=cfg.no_object_scale,
                coord_scale=cfg.coord_scale, class_scale=cfg.class_scale,
                best_iou_threshold=cfg.best_iou_threshold)[0]
        return jax.grad(loss)(st.params)
    return grad


def test_yolov2_detector_step_matches_jax():
    jdetector = JYOLO(JDetectorConfig(
        labels=('a', 'b'), image_h=NET, image_w=NET, grid_h=2, grid_w=2,
        width_div=8, num_anchors=2, anchors=tuple(ANCHORS)))
    variables = randomize_bn(jdetector.variables, np.random.RandomState(0))
    net = Darknet19(num_classes=2, num_anchors=2, width_div=8)
    net.load_state_dict(from_flax(variables), strict=True)
    ref_state = JState.create(jdetector.module.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(LR))
    run_pair(ref_state, jdet(ANCHORS), jax_det_grad(ANCHORS),
             TrainState.create(net, make_optimizer(LR)),
             make_detector_train_step(ANCHORS),
             [det_batch(1), det_batch(2)], stats=True, carry=True)


def test_vgg16_det_apply_step_matches_jax():
    """VGG16's dense head through the generic detector step (no
    BatchNorm; fc6 and fc7 do not feed the netout: no gradient in the
    port, a zero one in JAX, unchanged on both sides)."""
    kw = dict(image_h=NET, image_w=NET, det_labels=('a', 'b'), width_div=8,
              fc_features=128)
    jsrc = JVGG(**kw)
    src = VGG16PriorSource(**kw, device='cpu')
    variables = numpy_tree(dict(jsrc.variables))
    src.module.load_state_dict(from_flax(variables), strict=True)
    anchor = np.asarray(VGG_DET_ANCHOR, np.float32)
    ref_state = JState.create(jsrc.det_apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-3))

    def ref_grad(st, batch):
        def loss(p):
            out = st.apply_fn({'params': p}, batch['images'])
            return jyolo_loss(out['netout'], batch['y_true'],
                              batch['true_boxes'], anchor, st.step)[0]
        return jax.grad(loss)(st.params)

    model = src.det_apply
    state, _ = run_pair(
        ref_state, jdet(VGG_DET_ANCHOR), ref_grad,
        TrainState.create(model, make_optimizer(1e-3)),
        make_detector_train_step(VGG_DET_ANCHOR),
        [det_batch(s, anchors=anchor) for s in (3, 4)], prefix='vgg.')
    assert state.model.vgg is src.module           # the source's weights
    assert src.module.fc6.weight.grad is None


def test_multihead_detector_step_matches_jax():
    """Two [yolo] heads: each head's grid from one forward (as JAX's
    eval_shape), pixel anchors to its cells, summed losses, mean recall."""
    jmodel, _ = jbuild(V3_CFG)
    size = 32
    variables = numpy_tree(dict(jmodel.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, size, size, 3)))))
    model, _ = build_from_cfg(V3_CFG)
    model.load_state_dict(from_flax(variables), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grids = head_grids(model, size, 'cpu')
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    shapes = jax.eval_shape(
        lambda x: jmodel.apply(variables, x, train=False),
        jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    assert grids == [(int(h.shape[1]), int(h.shape[2]))
                     for h in shapes['heads']] == [(8, 8), (16, 16)]
    from object_tracking_tpu.models.darknet_cfg import head_specs
    heads = tuple((tuple(float(v) for v in np.asarray(
        s['anchors'], np.float32).reshape(-1)), gh, gw, s['num_classes'])
        for s, (gh, gw) in zip(head_specs(jmodel.plan), grids))
    cells = head_anchor_cells(heads, (size, size))
    np.testing.assert_allclose(cells[0][0], [10 * 8 / 32, 13 * 8 / 32])

    def batch(seed):
        rng = np.random.RandomState(seed)
        boxes = np.tile(np.asarray([[6.0, 4.0, 22.0, 30.0],
                                    [2.0, 2.0, 30.0, 26.0],
                                    [8.0, 8.0, 14.0, 13.0]], np.float32),
                        (2, 1, 1)) + rng.uniform(0, 1, (2, 3, 4)).astype(
                            np.float32)
        cls = np.tile(np.asarray([0, 1, 1], np.int32), (2, 1))
        valid = np.ones((2, 3), bool)
        ys, bs = jax.vmap(lambda bx, c, v: jencode_ms(
            bx, c, v, heads, image_h=size, image_w=size,
            true_box_buffer=4))(boxes, cls, valid)
        return {'images': rng.rand(2, size, size, 3).astype(np.float32),
                'y_true': tuple(np.asarray(y) for y in ys),
                'true_boxes': tuple(np.asarray(b) for b in bs)}

    cfg = LossConfig()

    def ref_grad(st, b):
        def loss(p):
            out, _ = st.apply_fn({'params': p,
                                  'batch_stats': st.batch_stats},
                                 b['images'], train=True,
                                 mutable=['batch_stats'])
            return sum(jyolo_loss(out['heads'][i], b['y_true'][i],
                                  b['true_boxes'][i], cells[i], st.step,
                                  object_scale=cfg.object_scale)[0]
                       for i in range(2))
        return jax.grad(loss)(st.params)

    ref_state = JState.create(jmodel.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(LR))
    run_pair(ref_state, jmulti(heads, (size, size)), ref_grad,
             TrainState.create(model, make_optimizer(LR)),
             make_multihead_detector_train_step(heads, (size, size)),
             [batch(1), batch(2)], stats=True, carry=True)


# -------------------------------------------------------- the whole slice
def test_slice_generator_and_tiny_step_match_jax(tmp_path):
    """JAX TrackerSequenceBatches(FakeDetector) → make_tiny_train_step
    against the port's on the same folder and seed: two steps, the same
    batches, metrics and parameters within the tolerances above."""
    img_dir, ann_dir = make_synthetic_dataset(
        str(tmp_path), num_videos=1, frames_per_video=6,
        image_size=(NET, NET), labels=('1',))
    anns, _ = parse_annotation_dir(ann_dir, img_dir, ('1',))
    ref_anns, _ = jparse(ann_dir, img_dir, ('1',))
    kw = dict(net_h=NET, net_w=NET, batch_size=2, augment=False, seed=5,
              det_dropout=0.3, loader=_default_loader(NET, NET))
    fake = dict(feat_shape=(4, 4, 8), num_labels=1, label_id=0)
    gen = TrackerSequenceBatches(make_sequence_windows(anns, 3), ('1',),
                                 FakeDetector(**fake), **kw)
    ref_gen = JTracker(jwindows(ref_anns, 3), ('1',), JFake(**fake), **kw)
    model, variables, net = tiny_pair(4, False)
    ref_state = JState.create(model.apply, jax.tree_util.tree_map(
        jnp.asarray, variables), jopt(1e-2))
    state = TrainState.create(net, make_optimizer(1e-2))
    ref_step, step = jtiny(), make_tiny_train_step()
    taken = 0
    for batch, ref_batch in zip(gen(), ref_gen()):
        ref_state, ref_metrics = ref_step(ref_state, ref_batch)
        state, metrics = step(state, batch)
        close_metrics(metrics, ref_metrics)
        leaves_close(params_of(net),
                     params_from_flax(numpy_tree(ref_state.params)))
        taken += 1
        if taken == 2:
            break
    assert taken == 2 and state.step == 2
