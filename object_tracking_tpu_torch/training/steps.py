"""Train and eval steps of the joint detect+track model.

Port of the joint steps of `object_tracking_tpu/training/steps.py`. Each
factory closes over the anchors and the loss and joint configs and returns
`step(state, batch)`. A train step returns `(state, metrics)` with the
state updated in place; an eval step returns `metrics`. The loss is
0.7·track + 0.3·detect YOLOv2 losses (`JointConfig` weights) over the B·T
frames; the MoE auxiliary term is 0 until the MoE head is ported (ROADMAP
queue 1, item 16).

A step moves the host batch to the model's device itself (non-blocking
copies) and makes no host sync: its metrics stay 0-d device tensors, and
nothing in it calls `.item()`, `nonzero` or boolean indexing, or branches
on a device value. The fit loop pulls the metrics once per epoch.

The fused steps take the raw uint8 batches of
`SequenceBatches(raw_mode=True)` and run /255, augmentation (one parameter
set per window, from generators seeded by the batch's host 'aug_seeds'),
target encoding, forward, backward and Adam on the device. Train steps put
the module in `train()` mode, so batch-statistics BatchNorm updates the
running statistics; eval steps put it in `eval()` mode and write nothing,
whether they normalise with batch statistics (the default, as the JAX
eval steps) or with the running ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from object_tracking_tpu_torch.config import JointConfig, LossConfig
from object_tracking_tpu_torch.data.augment import (
    AugmentConfig, augment_sequences_batch)
from object_tracking_tpu_torch.models.losses import yolo_loss
from object_tracking_tpu_torch.ops.targets import encode_targets_batch

HOST_KEYS = ('aug_seeds',)      # read on the host: they seed generators


def to_device(batch: Dict, device) -> Dict:
    """Host batch (numpy or CPU tensors) → tensors on `device` by
    non-blocking copies, which do not sync with the host; the keys of
    HOST_KEYS stay on the host."""
    return {k: (np.asarray(v) if k in HOST_KEYS
                else torch.as_tensor(v).to(device, non_blocking=True))
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


def _yolo_loss_bt(netout, batch, anchors, loss_cfg: LossConfig, step: int):
    return yolo_loss(
        _merge_time(netout), _merge_time(batch['y_true']),
        _merge_time(batch['true_boxes']), anchors, step,
        warm_up_batches=loss_cfg.warm_up_batches,
        object_scale=loss_cfg.object_scale,
        no_object_scale=loss_cfg.no_object_scale,
        coord_scale=loss_cfg.coord_scale,
        class_scale=loss_cfg.class_scale,
        best_iou_threshold=loss_cfg.best_iou_threshold)


def _joint_loss(model, batch, anchors, loss_cfg: LossConfig,
                joint_cfg: JointConfig, step: int, train: bool):
    """(loss, metrics): the weighted joint loss and the JAX step's metrics
    dict, every value a 0-d float32 device tensor."""
    out = model(batch['images'], train=train)
    t_loss, t_aux = _yolo_loss_bt(out['track'], batch, anchors, loss_cfg,
                                  step)
    d_loss, d_aux = _yolo_loss_bt(out['detect'], batch, anchors, loss_cfg,
                                  step)
    wt, wd = joint_cfg.loss_weight_track, joint_cfg.loss_weight_detect
    loss = wt * t_loss + wd * d_loss
    metrics = {'loss': loss, 'track_loss': t_loss, 'detect_loss': d_loss,
               'track_recall': t_aux['recall'],
               'detect_recall': d_aux['recall'],
               'moe_aux': torch.zeros((), device=loss.device)}
    for comp in ('loss_xy', 'loss_wh', 'loss_conf', 'loss_class'):
        metrics[comp] = wt * t_aux[comp] + wd * d_aux[comp]
    return loss, metrics


def _train_on(state, batch, anchors, loss_cfg, joint_cfg):
    """Forward, backward and one optimizer step on a device batch."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = _joint_loss(state.model, batch, anchors, loss_cfg,
                                joint_cfg, state.step, train=True)
    loss.backward()
    state.apply_gradients()
    return state, {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def _eval_on(state, batch, anchors, loss_cfg, joint_cfg, use_batch_stats):
    state.model.eval()
    _, metrics = _joint_loss(state.model, batch, anchors, loss_cfg,
                             joint_cfg, state.step, train=use_batch_stats)
    return metrics


def make_joint_train_step(anchors, loss_cfg: Optional[LossConfig] = None,
                          joint_cfg: Optional[JointConfig] = None
                          ) -> Callable:
    """Train step over prepared batches: {'images' (B,T,H,W,3) in [0, 1],
    'y_true' (B,T,GH,GW,A,5+C), 'true_boxes' (B,T,1,1,1,TB,4)}."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    anchors = _Anchors(anchors)

    def step(state, batch):
        device = _device(state.model)
        return _train_on(state, to_device(batch, device), anchors.on(device),
                         loss_cfg, joint_cfg)

    return step


def make_joint_eval_step(anchors, loss_cfg: Optional[LossConfig] = None,
                         joint_cfg: Optional[JointConfig] = None,
                         use_batch_stats: bool = True) -> Callable:
    """Eval step over prepared batches. `use_batch_stats=True` (default)
    normalises with batch statistics, as the JAX eval step; False uses the
    running statistics. No running statistic is written."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    anchors = _Anchors(anchors)

    def step(state, batch):
        device = _device(state.model)
        return _eval_on(state, to_device(batch, device), anchors.on(device),
                        loss_cfg, joint_cfg, use_batch_stats)

    return step


def _prepare_raw_joint_batch(batch, aug_cfg, encode_fn, augment: bool):
    """Raw device batch {'images_u8' (B,T,H,W,3) uint8, 'boxes' (B,T,M,4)
    pixels, 'cls', 'valid', 'aug_seeds' (B,) host ints} → {'images',
    'y_true', 'true_boxes'}, all on the device."""
    images = batch['images_u8'].to(torch.float32) / 255.0
    boxes = batch['boxes'].to(torch.float32)
    if augment:
        images, boxes = augment_sequences_batch(batch['aug_seeds'], images,
                                                boxes, aug_cfg)
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
                                augment: bool = True) -> Callable:
    """Joint train step over raw uint8 batches: normalise, augment,
    encode targets, forward, backward and Adam, all on the device."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    aug_cfg = aug_cfg or AugmentConfig()
    anchors = _Anchors(anchors)
    encode = _encoder(anchors, net_h, net_w, grid_h, grid_w, num_classes,
                      true_box_buffer)

    def step(state, raw):
        device = _device(state.model)
        batch = _prepare_raw_joint_batch(to_device(raw, device), aug_cfg,
                                         encode, augment)
        return _train_on(state, batch, anchors.on(device), loss_cfg,
                         joint_cfg)

    return step


def make_joint_eval_step_fused(anchors, loss_cfg=None, joint_cfg=None, *,
                               net_h: int = 416, net_w: int = 416,
                               grid_h: int = 13, grid_w: int = 13,
                               num_classes: int = 12,
                               true_box_buffer: int = 50,
                               use_batch_stats: bool = True) -> Callable:
    """Eval twin of make_joint_train_step_fused: raw uint8 batches,
    normalise and encode on the device, no augmentation."""
    loss_cfg = loss_cfg or LossConfig()
    joint_cfg = joint_cfg or JointConfig()
    anchors = _Anchors(anchors)
    encode = _encoder(anchors, net_h, net_w, grid_h, grid_w, num_classes,
                      true_box_buffer)

    def step(state, raw):
        device = _device(state.model)
        batch = _prepare_raw_joint_batch(to_device(raw, device), None,
                                         encode, augment=False)
        return _eval_on(state, batch, anchors.on(device), loss_cfg,
                        joint_cfg, use_batch_stats)

    return step
