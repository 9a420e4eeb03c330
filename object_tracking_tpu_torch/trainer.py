"""Training flows.

Port of the three flows of `object_tracking_tpu/trainer.py`:
`single_object_tracking` (TinyTracker over a frozen prior source),
`simult_multi_obj_detection_tracking` (the joint detect+track model) and
`keras_yolo_obj_detection` (predict over images, and standalone detector
training). Each wires generators → steps → fit loop with the checkpoint /
early-stop / plateau-LR / metric-logging stack, on one device ('cuda'
unless the caller passes `device='cpu'`; a missing card raises).
`synthetic=True` fabricates a small dataset first and trains on it. The
command line waits for its item (ROADMAP.md queue 1, item 15).

A model trained from scratch starts as flax starts the JAX one
(`models.darknet19.init_like_flax`): torch's default conv init has a third
of lecun_normal's variance, which would make it another experiment.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from object_tracking_tpu_torch.inference import resolve_device


def _common_setup(cfg, workdir: Optional[str] = None):
    """mkdir the log and model dirs under `workdir` (default '.')."""
    base = workdir or '.'
    logs = os.path.join(base, cfg.train.tensorboard_dir)
    models = os.path.join(base, cfg.train.saved_model_dir)
    os.makedirs(logs, exist_ok=True)
    os.makedirs(models, exist_ok=True)
    return logs, models


def _make_callback_stack(cfg, logs: str, ckpt_dir: str, joint: bool):
    from object_tracking_tpu_torch.training import (
        CheckpointManager, EarlyStopping, MetricLogger, ReduceLROnPlateau)
    from object_tracking_tpu_torch.training.metrics import numbered_run_dir
    logger = MetricLogger(numbered_run_dir(logs))
    ckpts = CheckpointManager(ckpt_dir)
    early = EarlyStopping(patience=cfg.train.early_stop_patience)
    reduce_lr = ReduceLROnPlateau(
        factor=cfg.train.reduce_lr_factor,
        patience=(cfg.train.joint_reduce_lr_patience if joint
                  else cfg.train.reduce_lr_patience),
        min_lr=cfg.train.min_lr)
    return logger, ckpts, early, reduce_lr


def _synthetic_dirs(cfg, image_size, labels, frames=12, videos=2,
                    workdir: Optional[str] = None):
    from object_tracking_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    root = tempfile.mkdtemp(prefix='ott_synth_', dir=workdir)
    img_dir, ann_dir = make_synthetic_dataset(
        root, num_videos=videos, frames_per_video=frames,
        image_size=image_size, labels=labels)
    cfg.train.train_image_folder = img_dir
    cfg.train.train_annot_folder = ann_dir
    cfg.train.val_image_folder = img_dir
    cfg.train.val_annot_folder = ann_dir
    return cfg


def _not_ported(cfg, profile_dir=None, joint: bool = True) -> list:
    """The JAX flows' options that the port does not have yet: multi-host
    runs for every flow; for the joint flow also its parallel and stacked
    variants and profiling."""
    later = []
    if getattr(getattr(cfg, 'mesh', None), 'distributed', False):
        later.append('mesh.distributed (queue 1, item 16)')
    if not joint:
        return later
    if cfg.joint.time_shards > 1:
        later.append('joint.time_shards > 1 (queue 1, item 16)')
    if cfg.joint.moe_experts:
        later.append('joint.moe_experts (queue 1, item 16)')
    if cfg.joint.convlstm_layers > 1:
        later.append('joint.convlstm_layers > 1 (queue 1, item 5)')
    if profile_dir:
        later.append('profile_dir (queue 1, item 16)')
    return later


def _refuse_later(later: list) -> None:
    if later:
        raise NotImplementedError('not ported yet, see ROADMAP.md: '
                                  + ', '.join(later))


def _resume(cfg, ckpts, state):
    """Restore the latest checkpoint when cfg.train.resume (then apply
    cfg.train.resume_lr); returns (state, restored epoch or 0)."""
    if not cfg.train.resume:
        return state, 0
    state, at = ckpts.restore(state)
    at = at or 0
    if at:
        print(f'resumed from checkpoint step {at}')
    if at and cfg.train.resume_lr is not None:
        state = state.with_learning_rate(cfg.train.resume_lr)
        print(f'resume lr override → {cfg.train.resume_lr:.2e}')
    elif not at and cfg.train.resume_lr is not None:
        raise RuntimeError(
            'resume_lr is set but no checkpoint was restored — '
            'check the workdir (a cross-resolution fine-tune would '
            'otherwise train from scratch at the base lr)')
    return state, at


def _prior_source(cfg, labels, synthetic: bool, device):
    """The frozen prior source of the single-object flow, chosen as the JAX
    flow chooses it: VGG16 (backend 'vgg16'), then a darknet cfg
    (cfg_path), then the fake (synthetic data or no weights), else
    YOLOv2."""
    from object_tracking_tpu_torch.models import (
        CfgDetector, FakeDetector, VGG16PriorSource, YOLOv2Detector)
    det = cfg.detector
    if det.backend == 'vgg16' and not synthetic:
        return VGG16PriorSource(
            image_h=det.image_h, image_w=det.image_w,
            weights_path=det.vgg_weights_path, det_labels=det.labels,
            fc_features=det.vgg_fc_features, width_div=det.vgg_width_div,
            device=device)
    if det.cfg_path and not synthetic:
        return CfgDetector(det.cfg_path, weights_path=det.weights_path,
                           labels=labels or None,
                           obj_threshold=det.obj_threshold,
                           nms_threshold=det.nms_threshold, device=device)
    if synthetic or not det.weights_path:
        return FakeDetector(feat_shape=(4, 4, 32))
    return YOLOv2Detector(det, device=device)


def _feature_layer(cfg, detector) -> str:
    """cfg.detector.feature_layer, with the JAX flow's fallbacks for its
    YOLO default 'conv_feat': 'fc7' on VGG16, 'final' on a cfg net."""
    layer = cfg.detector.feature_layer
    if cfg.detector.backend == 'vgg16' and layer == 'conv_feat':
        return 'fc7'
    if layer == 'conv_feat':
        try:
            detector.get_layer_dims(layer)
        except KeyError:
            return 'final'
    return layer


def single_object_tracking(cfg, *, synthetic: bool = False,
                           epochs: Optional[int] = None,
                           workdir: Optional[str] = None,
                           detector=None, device='cuda'):
    """Train TinyTracker (cfg.tracker.name 'TinyTracker') or the heatmap
    tracker ('TinyHeatmapTracker') on TrackerSequenceBatches over a frozen
    prior source (`detector`, else `_prior_source`); returns the final
    TrainState. `epochs` counts the epochs of this call (on resume, after
    the restored ones)."""
    from object_tracking_tpu_torch.data import (
        TrackerSequenceBatches, make_sequence_windows, parse_annotation_dir)
    from object_tracking_tpu_torch.models import TinyTracker
    from object_tracking_tpu_torch.models.darknet19 import init_like_flax
    from object_tracking_tpu_torch.training import (
        TrainState, fit, make_optimizer, make_tiny_eval_step,
        make_tiny_train_step)

    _refuse_later(_not_ported(cfg, joint=False))
    device = resolve_device(device)
    heatmap = cfg.tracker.name == 'TinyHeatmapTracker'
    if cfg.tracker.residual and not heatmap and cfg.tracker.loss == 'bce':
        # the residual head emits det + tanh(delta) in [-1, 2], which the
        # cross-entropy clips to (0, 1): no gradient, no training
        raise ValueError(
            "tracker.residual=True requires tracker.loss='huber' "
            "(bce clips the residual head's [-1, 2] output range and "
            'kills its gradients)')
    labels = cfg.train.classes
    if synthetic:
        labels = ('1',)
        cfg = _synthetic_dirs(cfg, (128, 128), labels, workdir=workdir)
    logs, models_dir = _common_setup(cfg, workdir)
    if detector is None:
        detector = _prior_source(cfg, labels, synthetic, device)
    feature_layer = _feature_layer(cfg, detector)

    def build(split_img, split_ann):
        anns, _ = parse_annotation_dir(
            split_ann, split_img, labels,
            cache_dir=cfg.train.annotation_cache_dir or None)
        wins = make_sequence_windows(anns, cfg.tracker.sequence_length)
        return TrackerSequenceBatches(
            wins, labels, detector,
            net_h=cfg.detector.image_h, net_w=cfg.detector.image_w,
            batch_size=cfg.train.batch_size,
            target_mode='heatmap' if heatmap else 'bbox',
            heatmap_size=cfg.tracker.heatmap_size,
            tracked_classes=labels, augment=cfg.train.augment,
            seed=cfg.train.seed, feature_layer=feature_layer,
            det_dropout=cfg.tracker.det_dropout)

    train_gen = build(cfg.train.train_image_folder,
                      cfg.train.train_annot_folder)
    val_gen = build(cfg.train.val_image_folder,
                    cfg.train.val_annot_folder)

    out_dim = cfg.tracker.heatmap_size ** 2 if heatmap else 4
    model = init_like_flax(TinyTracker(
        detector.get_layer_dims(feature_layer),
        lstm_units=cfg.tracker.lstm_units, out_dim=out_dim,
        pool=cfg.tracker.pool,
        residual_det=cfg.tracker.residual and not heatmap), cfg.train.seed)
    state = TrainState.create(
        model.to(device), make_optimizer(
            cfg.train.learning_rate, grad_clip_norm=cfg.train.grad_clip_norm))

    logger, ckpts, early, reduce_lr = _make_callback_stack(
        cfg, logs, os.path.join(models_dir, 'tiny_tracker'), joint=False)
    state, at = _resume(cfg, ckpts, state)
    loss_name = cfg.tracker.loss
    state = fit(state, make_tiny_train_step(heatmap, loss_name), train_gen,
                eval_step=make_tiny_eval_step(heatmap, loss_name),
                val_batches=val_gen,
                epochs=at + (epochs or cfg.train.max_epochs),
                initial_epoch=at, logger=logger, checkpoints=ckpts,
                early_stopping=early, reduce_lr=reduce_lr,
                log_every_steps=cfg.train.log_every_steps,
                checkpoint_every=cfg.train.checkpoint_every_epochs)
    logger.close()
    ckpts.close()
    return state


def _load_darknet_backbone(model, cfg, grid_h: int, grid_w: int) -> None:
    """Darknet .weights into the joint model's detector (every tensor of
    matching shape, and all BatchNorm statistics), then the head conv
    re-randomised for fine-tuning."""
    from object_tracking_tpu_torch.models import YOLOv2Detector
    from object_tracking_tpu_torch.models.yolov2 import rerandomize_head
    det = YOLOv2Detector(cfg.detector, device='cpu')
    own = model.detector.state_dict()
    carried = {k: v for k, v in det.model.state_dict().items()
               if k in own and own[k].shape == v.shape}
    model.detector.load_state_dict(carried, strict=False)
    rerandomize_head(model.detector,
                     torch.Generator().manual_seed(cfg.train.seed + 1),
                     grid_h, grid_w)


def simult_multi_obj_detection_tracking(cfg, *, synthetic: bool = False,
                                        epochs: Optional[int] = None,
                                        workdir: Optional[str] = None,
                                        image_size: Optional[int] = None,
                                        profile_dir: Optional[str] = None,
                                        device='cuda'):
    """Train the joint detect+track model; returns the final TrainState.

    `epochs` counts the epochs of this call (on resume, after the restored
    ones). The fused path (`cfg.train.device_data`, the default) feeds raw
    uint8 batches to the fused steps; `cfg.train.debug` keeps the legacy
    host pipeline, whose augmented pixels it dumps.
    """
    from object_tracking_tpu_torch.data import (
        SequenceBatches, make_sequence_windows, parse_annotation_dir)
    from object_tracking_tpu_torch.models import MultiObjDetTracker
    from object_tracking_tpu_torch.models.darknet19 import init_like_flax
    from object_tracking_tpu_torch.training import (
        TrainState, fit, make_joint_eval_step, make_joint_eval_step_fused,
        make_joint_train_step, make_joint_train_step_fused, make_optimizer)

    _refuse_later(_not_ported(cfg, profile_dir))
    device = resolve_device(device)
    labels = cfg.joint.labels
    size = image_size or cfg.detector.image_h
    gh, gw = size // 32, size // 32
    if synthetic:
        labels = ('1', '2')
        cfg = _synthetic_dirs(cfg, (size, size), labels, workdir=workdir)
    logs, models_dir = _common_setup(cfg, workdir)

    fused = cfg.train.device_data and not cfg.train.debug

    def build(split_img, split_ann, augment):
        anns, _ = parse_annotation_dir(
            split_ann, split_img, labels,
            cache_dir=cfg.train.annotation_cache_dir or None)
        wins = make_sequence_windows(anns, cfg.joint.sequence_length)
        return SequenceBatches(
            wins, labels, net_h=size, net_w=size, grid_h=gh, grid_w=gw,
            anchors=cfg.detector.anchors,
            batch_size=cfg.joint.batch_size,
            max_boxes=cfg.train.max_boxes_per_image, augment=augment,
            seed=cfg.train.seed, raw_mode=fused,
            debug_dir=('data/debug' if cfg.train.debug else None))

    train_gen = build(cfg.train.train_image_folder,
                      cfg.train.train_annot_folder, cfg.train.augment)
    val_gen = build(cfg.train.val_image_folder,
                    cfg.train.val_annot_folder, False)

    model = MultiObjDetTracker(
        num_classes=len(labels), num_anchors=cfg.detector.num_anchors,
        convlstm_features=cfg.joint.convlstm_features,
        width_div=cfg.detector.width_div,
        dtype=getattr(torch, cfg.joint.compute_dtype),
        remat=cfg.joint.remat)
    init_like_flax(model, cfg.train.seed)
    if cfg.detector.weights_path:
        _load_darknet_backbone(model, cfg, gh, gw)
    model = model.to(device)
    state = TrainState.create(
        model, make_optimizer(cfg.train.joint_learning_rate,
                              grad_clip_norm=cfg.train.grad_clip_norm))

    logger, ckpts, early, reduce_lr = _make_callback_stack(
        cfg, logs, os.path.join(models_dir, 'multi_obj'), joint=True)
    state, at = _resume(cfg, ckpts, state)
    if fused:
        enc = dict(net_h=size, net_w=size, grid_h=gh, grid_w=gw,
                   num_classes=len(labels),
                   true_box_buffer=cfg.train.max_boxes_per_image)
        train_step = make_joint_train_step_fused(
            cfg.detector.anchors, cfg.loss, cfg.joint,
            augment=cfg.train.augment, **enc)
        eval_step = make_joint_eval_step_fused(
            cfg.detector.anchors, cfg.loss, cfg.joint, **enc)
    else:
        train_step = make_joint_train_step(cfg.detector.anchors, cfg.loss,
                                           cfg.joint)
        eval_step = make_joint_eval_step(cfg.detector.anchors, cfg.loss,
                                         cfg.joint)
    state = fit(state, train_step, train_gen,
                eval_step=eval_step, val_batches=val_gen,
                # resumed runs continue the epoch sequence, so that saves
                # go on past the restored step
                epochs=at + (epochs or cfg.train.max_epochs),
                initial_epoch=at, logger=logger, checkpoints=ckpts,
                early_stopping=early, reduce_lr=reduce_lr,
                log_every_steps=cfg.train.log_every_steps,
                checkpoint_every=cfg.train.checkpoint_every_epochs)
    logger.close()
    ckpts.close()
    return state


def _cfg_detector(cfg, labels, device, weights: bool = True):
    """CfgDetector of cfg.detector.cfg_path. Unchanged default (COCO)
    labels leave the class names to the cfg's class count."""
    from object_tracking_tpu_torch.config import LABELS_COCO
    from object_tracking_tpu_torch.models import CfgDetector
    if labels == LABELS_COCO:
        labels = None
    return CfgDetector(cfg.detector.cfg_path,
                       weights_path=(cfg.detector.weights_path if weights
                                     else None),
                       labels=labels or None,
                       obj_threshold=cfg.detector.obj_threshold,
                       nms_threshold=cfg.detector.nms_threshold,
                       device=device)


def keras_yolo_obj_detection(cfg, *, images=(), out_dir: str = '.',
                             synthetic: bool = False,
                             epochs: Optional[int] = None,
                             workdir: Optional[str] = None,
                             train: bool = False, device='cuda'):
    """Detector flow: predict over image files (each drawn to
    `<out_dir>/<name>_out.jpg`; returns {path: detections}), and, with
    `train` or `synthetic`, train the detector standalone (returns the
    final TrainState).

    The detector is Darknet-19 (`YOLOv2Detector`) or, when
    cfg.detector.cfg_path is set, the cfg's graph (`CfgDetector`, with
    cfg.detector.weights_path in cfg order). A cfg with one [region] head
    trains on its netout and anchors; a multi-head [yolo] cfg trains on
    multi-scale targets with one loss per head. Every head's grid comes
    from one forward (the JAX flow encodes a [region] head's targets at
    size/32, which fails for a cfg of another stride). A detector
    without loaded weights starts from flax's init. Unlike the JAX flow,
    cfg.train.resume restores the latest checkpoint here too.
    """
    from object_tracking_tpu_torch.models import YOLOv2Detector

    _refuse_later(_not_ported(cfg, joint=False))
    device = resolve_device(device)
    if cfg.detector.cfg_path:
        detector = _cfg_detector(cfg, cfg.detector.labels, device)
    else:
        detector = YOLOv2Detector(cfg.detector, device=device)
    results = {}
    for path in images:
        out = os.path.join(
            out_dir, os.path.basename(path).rsplit('.', 1)[0] + '_out.jpg')
        results[path] = detector.predict(path, out)
    if not (train or synthetic):
        return results

    from object_tracking_tpu_torch.config import DetectorConfig
    from object_tracking_tpu_torch.data import (
        DetectionBatches, parse_annotation_dir)
    from object_tracking_tpu_torch.models.darknet19 import init_like_flax
    from object_tracking_tpu_torch.models.darknet_cfg import (
        RegionNetout, head_grids)
    from object_tracking_tpu_torch.training import (
        TrainState, fit, make_detector_train_step,
        make_multihead_detector_train_step, make_optimizer)

    labels = cfg.detector.labels
    size = (detector.net_size[0] if cfg.detector.cfg_path
            else cfg.detector.image_h)
    anchors = cfg.detector.anchors
    loaded = bool(cfg.detector.weights_path)
    if synthetic:
        labels = ('1', '2')
        cfg = _synthetic_dirs(cfg, (size, size), labels, workdir=workdir)
        loaded = False
        if cfg.detector.cfg_path:
            detector = _cfg_detector(cfg, labels, device, weights=False)
        else:
            detector = YOLOv2Detector(DetectorConfig(
                labels=labels, image_h=size, image_w=size,
                grid_h=size // 32, grid_w=size // 32,
                width_div=cfg.detector.width_div), device=device)
    heads = None
    grid = (size // 32, size // 32)
    if cfg.detector.cfg_path:
        labels = detector.labels
        specs = detector.specs
        model = detector.module
        grids = head_grids(model, size, device)
        if len(specs) == 1 and specs[0]['kind'] == 'region':
            anchors = specs[0]['anchors']
            grid = grids[0]
            model = RegionNetout(model)
        else:
            heads = tuple(
                (tuple(float(v) for v in
                       np.asarray(s['anchors'], np.float32).reshape(-1)),
                 gh, gw, s['num_classes'])
                for s, (gh, gw) in zip(specs, grids))
    else:
        model = detector.model
    if not loaded:
        init_like_flax(model, cfg.train.seed)
    logs, models_dir = _common_setup(cfg, workdir)
    anns, _ = parse_annotation_dir(
        cfg.train.train_annot_folder, cfg.train.train_image_folder,
        labels, cache_dir=cfg.train.annotation_cache_dir or None)
    gen = DetectionBatches(
        anns, labels, net_h=size, net_w=size, grid_h=grid[0],
        grid_w=grid[1], anchors=anchors if heads is None else (1.0, 1.0),
        batch_size=min(cfg.detector.batch_size, max(len(anns), 1)),
        max_boxes=cfg.train.max_boxes_per_image,
        augment=cfg.train.augment, seed=cfg.train.seed,
        drop_last=False, heads=heads)
    state = TrainState.create(model, make_optimizer(
        cfg.train.joint_learning_rate,
        grad_clip_norm=cfg.train.grad_clip_norm))
    logger, ckpts, early, reduce_lr = _make_callback_stack(
        cfg, logs, os.path.join(models_dir, 'yolov2'), joint=False)
    state, at = _resume(cfg, ckpts, state)
    if heads is not None:
        train_step = make_multihead_detector_train_step(heads, (size, size),
                                                        cfg.loss)
    else:
        train_step = make_detector_train_step(anchors, cfg.loss)
    state = fit(state, train_step, gen,
                epochs=at + (epochs or cfg.train.max_epochs),
                initial_epoch=at, logger=logger, checkpoints=ckpts,
                early_stopping=early, reduce_lr=reduce_lr)
    logger.close()
    ckpts.close()
    return state
