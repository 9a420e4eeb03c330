"""Train and eval steps of every model family.

Port of `object_tracking_tpu/training/steps.py`. Each factory closes over
its configuration and returns `step(state, batch)`. A train step returns
`(state, metrics)` with the state updated in place; an eval step returns
`metrics`.

- Joint detect+track: the loss is 0.7·track + 0.3·detect YOLOv2 losses
  (`JointConfig` weights) over the B·T frames, plus moe_aux_weight times
  the MoE head's auxiliary loss when the model has one (0 otherwise,
  reported as 'moe_aux'). The fused steps
  take the raw uint8 batches of `SequenceBatches(raw_mode=True)` and run
  /255, augmentation (one parameter set per window, from generators
  seeded by the batch's host 'aug_seeds'), target encoding, forward,
  backward and Adam on the device.
- Standalone detector: one YOLOv2 loss over `{'netout'}` of a model
  called as `model(images, train=True)` (`Darknet19`, a cfg net's
  [region] head, VGG16's `det_apply`), or, for multi-head [yolo] cfg
  nets, the sum of one loss per head at its own grid and anchors.
- Single-object tracker: binary cross-entropy ('bce') or Huber ('huber')
  of `TinyTracker(feats, det)` against the target, plus the heatmap
  accuracy for the heatmap head.

Every train and eval step takes the `mesh` the model was built with. Each
rank of its data group then holds a share of the global batch
(`parallel.shard_batch`) and the step keeps JAX's global-batch semantics:
the loss normalisers are global counts, so each rank's loss is its share
of the global loss; after backward the gradients are summed over the
group (not averaged); the metrics are the global ones. BatchNorm
statistics and the MoE routing span the group inside the model. A batch
that `shard_batch` replicated (a ragged batch axis: every rank holds all
of it, `ShardedBatch.replicated`) runs as the one-rank step on every
rank, inside `parallel.mesh.whole_batch()`: no group in the model or the
loss, JAX's result for a replicated input. Each rank's gradient is then
the whole batch's, and the step averages them over the group (on the card
two ranks' reductions can differ in the last bits), so that every rank
takes the same update. The route is chosen on the host from the batch's
flag, with no sync.

A step moves the host batch to the model's device itself (non-blocking
copies) and makes no host sync: its metrics stay 0-d device tensors, and
nothing in it calls `.item()`, `nonzero` or boolean indexing, or branches
on a device value. The fit loop pulls the metrics once per epoch.

Each train step is the span `train` (`utils/profiling.py`), with the spans
`to_device`, `augment` and `targets` (the fused joint step's batch
preparation), `forward` (the model call), `loss`, `backward` (with the
gradients' collectives) and `optimizer` (`TrainState.apply_gradients`)
inside; an eval step is the span `eval`, with the same spans inside for
the parts it runs.

Train steps put the module in `train()` mode, so batch-statistics
BatchNorm updates the running statistics (a model without BatchNorm, as
VGG16 or TinyTracker, has none to update); eval steps put it in `eval()`
mode and write nothing, whether they normalise with batch statistics (the
default, as the JAX eval steps) or with the running ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.config import JointConfig, LossConfig
from object_tracking_tpu_torch.data.augment import (
    AugmentConfig, augment_sequences_batch)
from object_tracking_tpu_torch.models.losses import (
    binary_crossentropy, global_mean, heatmap_accuracy, yolo_loss)
from object_tracking_tpu_torch.ops.targets import encode_targets_batch
from object_tracking_tpu_torch.parallel.collectives import (
    all_reduce_sum_, average_gradients_, sum_gradients_)
from object_tracking_tpu_torch.parallel.mesh import (
    is_replicated, replica_group, whole_batch)
from object_tracking_tpu_torch.utils.profiling import span

HOST_KEYS = ('aug_seeds',)      # read on the host: they seed generators


def to_device(batch: Dict, device) -> Dict:
    """Host batch (numpy or CPU tensors, or tuples of them) → tensors on
    `device` by non-blocking copies, which do not sync with the host; the
    keys of HOST_KEYS stay on the host."""
    def move(v):
        if isinstance(v, (tuple, list)):
            return tuple(move(a) for a in v)
        return torch.as_tensor(v).to(device, non_blocking=True)
    return {k: (np.asarray(v) if k in HOST_KEYS else move(v))
            for k, v in batch.items()}


class _Anchors:
    """The anchors as a float32 tensor, one copy per device."""

    def __init__(self, anchors):
        self.host = torch.as_tensor(np.asarray(anchors, np.float32))
        self._on = {}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = self.host.to(device, non_blocking=True)
        return self._on[device]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _merge_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) → (B·T, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _on_mesh(mesh, step: Callable, stage: str) -> Callable:
    """`step(state, batch, group)` → `step(state, batch)` over the data
    group of `mesh`, inside the span `stage` ('train' or 'eval'). A batch
    that `shard_batch` replicated runs with no group, inside
    `whole_batch()`, where the model's data collectives are off too: the
    one-rank step on every rank."""
    def run(state, batch):
        with span(stage):
            if mesh is None:
                return step(state, batch, None)
            if is_replicated(batch):
                with whole_batch(mesh.data_group):
                    return step(state, batch, None)
            return step(state, batch, mesh.data_group)
    return run


def _moved(batch: Dict, device) -> Dict:
    """`to_device` inside the span `to_device`."""
    with span('to_device'):
        return to_device(batch, device)


def _share_metrics(metrics: Dict, keys: Sequence[str], group) -> Dict:
    """The metrics of `keys`, each a rank's share of a global value,
    summed over a data `group` (in place, one collective)."""
    if group is not None:
        shared = all_reduce_sum_(torch.stack(
            [metrics[k].detach().float() for k in keys]), group)
        metrics.update(zip(keys, shared))
    return metrics


def _yolo(netout, y_true, true_boxes, anchors, loss_cfg: LossConfig,
          step: int, group=None):
    return yolo_loss(
        netout, y_true, true_boxes, anchors, step, group=group,
        warm_up_batches=loss_cfg.warm_up_batches,
        object_scale=loss_cfg.object_scale,
        no_object_scale=loss_cfg.no_object_scale,
        coord_scale=loss_cfg.coord_scale,
        class_scale=loss_cfg.class_scale,
        best_iou_threshold=loss_cfg.best_iou_threshold)


def _yolo_loss_bt(netout, batch, anchors, loss_cfg: LossConfig, step: int,
                  group=None):
    return _yolo(_merge_time(netout), _merge_time(batch['y_true']),
                 _merge_time(batch['true_boxes']), anchors, loss_cfg, step,
                 group)


# metrics that are sums of the ranks' shares (the recalls are global)
_SHARED_METRICS = ('loss', 'track_loss', 'detect_loss', 'moe_aux',
                   'loss_xy', 'loss_wh', 'loss_conf', 'loss_class')


def _joint_loss(model, batch, anchors, loss_cfg: LossConfig,
                joint_cfg: JointConfig, step: int, train: bool, group=None):
    """(loss, metrics): the weighted joint loss (with a data `group`, this
    rank's share of the global loss) and the JAX step's metrics dict (the
    global values), every value a 0-d float32 device tensor."""
    with span('forward'):
        out = model(batch['images'], train=train)
    with span('loss'):
        t_loss, t_aux = _yolo_loss_bt(out['track'], batch, anchors,
                                      loss_cfg, step, group)
        d_loss, d_aux = _yolo_loss_bt(out['detect'], batch, anchors,
                                      loss_cfg, step, group)
        wt, wd = joint_cfg.loss_weight_track, joint_cfg.loss_weight_detect
        moe_aux = out.get('moe_aux')
        if moe_aux is None:
            moe_aux = torch.zeros((), device=t_loss.device)
        loss = wt * t_loss + wd * d_loss + joint_cfg.moe_aux_weight * moe_aux
        metrics = {'loss': loss, 'track_loss': t_loss,
                   'detect_loss': d_loss, 'track_recall': t_aux['recall'],
                   'detect_recall': d_aux['recall'], 'moe_aux': moe_aux}
        for comp in ('loss_xy', 'loss_wh', 'loss_conf', 'loss_class'):
            metrics[comp] = wt * t_aux[comp] + wd * d_aux[comp]
        return loss, _share_metrics(metrics, _SHARED_METRICS, group)


def _optimize(state, loss_fn, group=None):
    """Forward (`loss_fn(model) -> (loss, metrics)`) in train() mode,
    backward, the gradients summed over a data `group` (or, on a
    replicated batch, averaged over its replicas), and one optimizer
    step."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.model)
    with span('backward'):
        loss.backward()
        params = list(state.model.parameters())
        sum_gradients_(params, group)
        average_gradients_(params, replica_group())
    with span('optimizer'):
        state.apply_gradients()
    return state, {k: v.detach() for k, v in metrics.items()}


def _train_on(state, batch, anchors, loss_cfg, joint_cfg, group=None):
    """Forward, backward and one optimizer step on a device batch."""
    return _optimize(state, lambda model: _joint_loss(
        model, batch, anchors, loss_cfg, joint_cfg, state.step, train=True,
        group=group), group)


@torch.no_grad()
def _eval_on(state, batch, anchors, loss_cfg, joint_cfg, use_batch_stats,
             group=None):
    state.model.eval()
    _, metrics = _joint_loss(state.model, batch, anchors, loss_cfg,
                             joint_cfg, state.step, train=use_batch_stats,
                             group=group)
    return metrics


def make_joint_train_step(anchors, loss_cfg: Optional[LossConfig] = None,
                          joint_cfg: Optional[JointConfig] = None,
                          mesh=None) -> Callable:
    """Train step over prepared batches: {'images' (B,T,H,W,3) in [0, 1],
    'y_true' (B,T,GH,GW,A,5+C), 'true_boxes' (B,T,1,1,1,TB,4)}; with a
    `mesh`, this rank's share of the global batch."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    anchors = _Anchors(anchors)

    def step(state, batch, group):
        device = _device(state.model)
        return _train_on(state, _moved(batch, device),
                         anchors.on(device), loss_cfg, joint_cfg, group)

    return _on_mesh(mesh, step, 'train')


def make_joint_eval_step(anchors, loss_cfg: Optional[LossConfig] = None,
                         joint_cfg: Optional[JointConfig] = None,
                         use_batch_stats: bool = True, mesh=None
                         ) -> Callable:
    """Eval step over prepared batches. `use_batch_stats=True` (default)
    normalises with batch statistics, as the JAX eval step; False uses the
    running statistics. No running statistic is written."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    anchors = _Anchors(anchors)

    def step(state, batch, group):
        device = _device(state.model)
        return _eval_on(state, _moved(batch, device),
                        anchors.on(device), loss_cfg, joint_cfg,
                        use_batch_stats, group)

    return _on_mesh(mesh, step, 'eval')


def _prepare_raw_joint_batch(batch, aug_cfg, encode_fn, augment: bool):
    """Raw device batch {'images_u8' (B,T,H,W,3) uint8, 'boxes' (B,T,M,4)
    pixels, 'cls', 'valid', 'aug_seeds' (B,) host ints} → {'images',
    'y_true', 'true_boxes'}, all on the device; /255 and augmentation in
    the span `augment`, the targets in `targets`."""
    with span('augment'):
        images = batch['images_u8'].to(torch.float32) / 255.0
        boxes = batch['boxes'].to(torch.float32)
        if augment:
            images, boxes = augment_sequences_batch(
                batch['aug_seeds'], images, boxes, aug_cfg)
    with span('targets'):
        y, b = encode_fn(boxes, batch['cls'], batch['valid'])
    return {'images': images, 'y_true': y, 'true_boxes': b}


def _encoder(anchors: _Anchors, net_h, net_w, grid_h, grid_w, num_classes,
             true_box_buffer):
    def encode(boxes, cls, valid):
        return encode_targets_batch(
            boxes, cls, valid, anchors.on(boxes.device), image_h=net_h,
            image_w=net_w, grid_h=grid_h, grid_w=grid_w,
            num_classes=num_classes, true_box_buffer=true_box_buffer)
    return encode


def make_joint_train_step_fused(anchors, loss_cfg=None, joint_cfg=None, *,
                                net_h: int = 416, net_w: int = 416,
                                grid_h: int = 13, grid_w: int = 13,
                                num_classes: int = 12,
                                true_box_buffer: int = 50,
                                aug_cfg: Optional[AugmentConfig] = None,
                                augment: bool = True, mesh=None) -> Callable:
    """Joint train step over raw uint8 batches: normalise, augment,
    encode targets, forward, backward and Adam, all on the device."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    aug_cfg = aug_cfg or AugmentConfig()
    anchors = _Anchors(anchors)
    encode = _encoder(anchors, net_h, net_w, grid_h, grid_w, num_classes,
                      true_box_buffer)

    def step(state, raw, group):
        device = _device(state.model)
        batch = _prepare_raw_joint_batch(_moved(raw, device),
                                         aug_cfg, encode, augment)
        return _train_on(state, batch, anchors.on(device), loss_cfg,
                         joint_cfg, group)

    return _on_mesh(mesh, step, 'train')


def make_joint_eval_step_fused(anchors, loss_cfg=None, joint_cfg=None, *,
                               net_h: int = 416, net_w: int = 416,
                               grid_h: int = 13, grid_w: int = 13,
                               num_classes: int = 12,
                               true_box_buffer: int = 50,
                               use_batch_stats: bool = True,
                               mesh=None) -> Callable:
    """Eval twin of make_joint_train_step_fused: raw uint8 batches,
    normalise and encode on the device, no augmentation."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    anchors = _Anchors(anchors)
    encode = _encoder(anchors, net_h, net_w, grid_h, grid_w, num_classes,
                      true_box_buffer)

    def step(state, raw, group):
        device = _device(state.model)
        batch = _prepare_raw_joint_batch(_moved(raw, device), None,
                                         encode, augment=False)
        return _eval_on(state, batch, anchors.on(device), loss_cfg,
                        joint_cfg, use_batch_stats, group)

    return _on_mesh(mesh, step, 'eval')


DETECTOR_METRICS = ('loss', 'recall', 'loss_xy', 'loss_wh', 'loss_conf',
                    'loss_class')
# the detector metrics that are sums of the ranks' shares
_SHARED_DETECTOR = ('loss', 'loss_xy', 'loss_wh', 'loss_conf', 'loss_class')


def make_detector_train_step(anchors,
                             loss_cfg: Optional[LossConfig] = None,
                             mesh=None) -> Callable:
    """Standalone detector training. Batch: images (B, H, W, 3), y_true
    (B, GH, GW, A, 5+C), true_boxes (B, 1, 1, 1, TB, 4); the model returns
    {'netout': (B, GH, GW, A, 5+C)}; with a `mesh`, this rank's share of
    the global batch (a model with BatchNorm built with the same mesh).
    Metrics: DETECTOR_METRICS."""
    loss_cfg = loss_cfg or LossConfig()
    anchors = _Anchors(anchors)

    def loss_fn(model, batch, step, group):
        with span('forward'):
            out = model(batch['images'], train=True)
        with span('loss'):
            loss, aux = _yolo(out['netout'], batch['y_true'],
                              batch['true_boxes'],
                              anchors.on(batch['images'].device), loss_cfg,
                              step, group)
            return loss, _share_metrics(
                {k: aux[k] for k in DETECTOR_METRICS}, _SHARED_DETECTOR,
                group)

    def step(state, batch, group):
        batch = _moved(batch, _device(state.model))
        return _optimize(state, lambda model: loss_fn(
            model, batch, state.step, group), group)

    return _on_mesh(mesh, step, 'train')


def head_anchor_cells(head_specs: Sequence[Tuple], net_size
                      ) -> Tuple[np.ndarray, ...]:
    """Each head's pixel anchors in its own grid-cell units: (A, 2)."""
    net_h, net_w = net_size
    return tuple(np.asarray(a, np.float32).reshape(-1, 2)
                 * np.asarray([gw / net_w, gh / net_h], np.float32)
                 for a, gh, gw, _ in head_specs)


def make_multihead_detector_train_step(head_specs, net_size,
                                       loss_cfg: Optional[LossConfig]
                                       = None, mesh=None) -> Callable:
    """Standalone training of multi-head ([yolo], v3-family) cfg nets: one
    YOLOv2 loss per head at its own grid, with its pixel anchors converted
    to that grid's cells, summed; the recall is the mean of the heads'.
    With a `mesh`, each rank holds its share of the global batch, as in
    `make_detector_train_step`.

    Args:
      head_specs: per head (anchors_px flat tuple, grid_h, grid_w,
        num_classes), as `DetectionBatches(heads=...)` encodes them.
      net_size: (net_h, net_w) input pixels.
      Batch: {'images' (B,H,W,3), 'y_true': tuple per head,
              'true_boxes': tuple per head}; the model returns
              {'heads': [netout per head]}.
    """
    loss_cfg = loss_cfg or LossConfig()
    cells = [_Anchors(a) for a in head_anchor_cells(head_specs, net_size)]

    def loss_fn(model, batch, step, group):
        with span('forward'):
            out = model(batch['images'], train=True)
        device = batch['images'].device
        total, metrics, recalls = 0.0, {}, []
        with span('loss'):
            for i, anchors in enumerate(cells):
                loss, aux = _yolo(out['heads'][i], batch['y_true'][i],
                                  batch['true_boxes'][i], anchors.on(device),
                                  loss_cfg, step, group)
                total = total + loss
                for k in ('loss', 'loss_xy', 'loss_wh', 'loss_conf',
                          'loss_class'):
                    metrics[k] = (metrics[k] + aux[k] if k in metrics
                                  else aux[k])
                recalls.append(aux['recall'])
            metrics['recall'] = sum(recalls) / len(recalls)
            return total, _share_metrics({k: metrics[k]
                                          for k in DETECTOR_METRICS},
                                         _SHARED_DETECTOR, group)

    def step(state, batch, group):
        batch = _moved(batch, _device(state.model))
        return _optimize(state, lambda model: loss_fn(
            model, batch, state.step, group), group)

    return _on_mesh(mesh, step, 'train')


def _huber(pred: torch.Tensor, target: torch.Tensor,
           group=None) -> torch.Tensor:
    """Mean Huber loss with delta 1 (smooth L1); with a data `group`, this
    rank's share of the global mean."""
    diff = pred.float() - target
    a = diff.abs()
    return global_mean(torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5),
                        group)


# bce: the reference's loss on the sigmoid outputs, even for continuous box
# targets; huber: keeps pulling a box to a tight fit where bce's gradient
# has vanished
TINY_LOSSES = {'bce': binary_crossentropy, 'huber': _huber}


def _tiny_loss_fn(loss_name: str) -> Callable:
    if loss_name not in TINY_LOSSES:
        raise ValueError(f'unknown tracker loss {loss_name!r}')
    return TINY_LOSSES[loss_name]


def _tiny_loss(model, batch, heatmap: bool, loss_fn: Callable, group=None):
    """(loss, metrics) of the single-object tracker on a device batch,
    with the heatmap accuracy for the heatmap head; with a data `group`,
    the loss is this rank's share and the metrics are global."""
    with span('forward'):
        pred = model(batch['feats'], batch['det'])
    with span('loss'):
        target = batch['target'].float()
        loss = loss_fn(pred, target, group=group)
        metrics = _share_metrics({'loss': loss}, ('loss',), group)
        if heatmap:
            metrics['heatmap_acc'] = heatmap_accuracy(pred, target,
                                                      group=group)
        return loss, metrics


def make_tiny_train_step(heatmap: bool = False,
                         loss_name: str = 'bce', mesh=None) -> Callable:
    """TinyTracker / TinyHeatmapTracker step. Batch: feats (B, T, h, w, c),
    det (B, T, D), target (B, T, out_dim), with a `mesh` this rank's share
    of the global batch; `loss_name` a key of TINY_LOSSES."""
    loss_fn = _tiny_loss_fn(loss_name)

    def step(state, batch, group):
        batch = _moved(batch, _device(state.model))
        return _optimize(state, lambda model: _tiny_loss(
            model, batch, heatmap, loss_fn, group), group)

    return _on_mesh(mesh, step, 'train')


def make_tiny_eval_step(heatmap: bool = False,
                        loss_name: str = 'bce', mesh=None) -> Callable:
    loss_fn = _tiny_loss_fn(loss_name)

    @torch.no_grad()
    def step(state, batch, group):
        state.model.eval()
        return _tiny_loss(state.model,
                          _moved(batch, _device(state.model)),
                          heatmap, loss_fn, group)[1]

    return _on_mesh(mesh, step, 'eval')
