"""Training, evaluation, serving-export, tracking and conversion flows,
and the command line.

Port of the flows of `object_tracking_tpu/trainer.py`:
`single_object_tracking` (TinyTracker over a frozen prior source),
`simult_multi_obj_detection_tracking` (the joint detect+track model),
`keras_yolo_obj_detection` (predict over images, and standalone detector
training), `evaluate_tracking` (CLEAR-MOT over the val split),
`export_serving` (the serving artifact, `serving.py`), `track_video`
(drawn frames and an optional video) and `convert_dataset` (MOT17 /
VisualTB → VOC). The training flows wire generators → steps → fit loop
with the checkpoint / early-stop / plateau-LR / metric-logging stack.
Every flow runs on one device per process ('cuda' unless the caller
passes `device='cpu'`; a missing card raises). With
`cfg.mesh.distributed` (its address, process count and id, or
`torchrun`'s environment) the training flows join a process group (NCCL
on the card, gloo on the CPU) and lay the ranks out
as `cfg.mesh`'s (data, model) mesh. Every training flow trains
data-parallel on the global batch: each rank builds it and keeps its
slice (`parallel.shard_batch`; along time with `joint.time_shards` > 1),
BatchNorm statistics, losses and gradients stay the global batch's, and
a ragged batch is replicated and runs as the one-rank step on every
rank. The joint flow adds the MoE head, pipeline-parallel stacked layers
(`joint.pp_layers`) and sequence parallelism as configured; the
single-object flow's frozen prior runs unsharded on each rank's global
batch. Only rank 0 writes logs and checkpoints. `synthetic=True` fabricates a
small dataset first. `main` is the command line:

    python -m object_tracking_tpu_torch.trainer [--device cpu] <command>

A model trained from scratch starts as flax starts the JAX one
(`models.darknet19.init_like_flax`): torch's default conv init has a third
of lecun_normal's variance, which would make it another experiment.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from object_tracking_tpu_torch.utils.frames import resolve_device


def _common_setup(cfg, workdir: Optional[str] = None, device='cpu'):
    """mkdir the log and model dirs under `workdir` (default '.'), join
    the process group (when cfg.mesh.distributed), build the mesh and the
    shard fn (this rank's slice of a global host batch)."""
    from object_tracking_tpu_torch.parallel import (
        distributed_init, make_mesh, shard_batch)
    distributed_init(cfg.mesh, device)
    base = workdir or '.'
    logs = os.path.join(base, cfg.train.tensorboard_dir)
    models = os.path.join(base, cfg.train.saved_model_dir)
    os.makedirs(logs, exist_ok=True)
    os.makedirs(models, exist_ok=True)
    mesh = make_mesh(cfg.mesh)
    return logs, models, mesh, (lambda b: shard_batch(mesh, b))


def _make_callback_stack(cfg, logs: str, ckpt_dir: str, joint: bool):
    """(logger, checkpoints, early stopping, plateau LR); the logger is
    None on every rank but rank 0."""
    from object_tracking_tpu_torch.parallel.mesh import is_writer
    from object_tracking_tpu_torch.training import (
        CheckpointManager, EarlyStopping, MetricLogger, ReduceLROnPlateau)
    from object_tracking_tpu_torch.training.metrics import numbered_run_dir
    logger = MetricLogger(numbered_run_dir(logs)) if is_writer() else None
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
    logs, models_dir, mesh, shard_fn = _common_setup(cfg, workdir, device)
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
    state = fit(state, make_tiny_train_step(heatmap, loss_name, mesh),
                train_gen,
                eval_step=make_tiny_eval_step(heatmap, loss_name, mesh),
                val_batches=val_gen,
                epochs=at + (epochs or cfg.train.max_epochs),
                initial_epoch=at, shard_fn=shard_fn, logger=logger,
                checkpoints=ckpts,
                early_stopping=early, reduce_lr=reduce_lr,
                log_every_steps=cfg.train.log_every_steps,
                checkpoint_every=cfg.train.checkpoint_every_epochs)
    if logger:
        logger.close()
    ckpts.close()
    return state


def _joint_model(cfg, labels, mesh=None):
    """The joint model of `cfg` for `labels`, on the CPU, initialised as
    flax initialises the JAX one (seed cfg.train.seed). Without a `mesh`
    it is the dense model (eval, tracking, export): time sharding and the
    pipelined stack are layouts of training, and a checkpoint of any
    layout restores into it."""
    from object_tracking_tpu_torch.models import MultiObjDetTracker
    from object_tracking_tpu_torch.models.darknet19 import init_like_flax
    parallel = {}
    if mesh is not None:
        parallel = dict(time_shards=cfg.joint.time_shards,
                        pp_layers=cfg.joint.pp_layers, mesh=mesh)
    return init_like_flax(MultiObjDetTracker(
        num_classes=len(labels), num_anchors=cfg.detector.num_anchors,
        convlstm_features=cfg.joint.convlstm_features,
        width_div=cfg.detector.width_div,
        dtype=getattr(torch, cfg.joint.compute_dtype),
        remat=cfg.joint.remat, moe_experts=cfg.joint.moe_experts,
        moe_hidden=cfg.joint.moe_hidden,
        convlstm_layers=cfg.joint.convlstm_layers, **parallel),
        cfg.train.seed)


def _restore_variables(model, checkpoint_dir: Optional[str],
                       required: bool = False):
    """Load the parameters and BatchNorm statistics of the latest
    checkpoint under `checkpoint_dir` into `model`; returns its step, or
    None when there is none (`required` then raises)."""
    from object_tracking_tpu_torch.training import (
        CheckpointManager, TrainState, make_optimizer)
    if not checkpoint_dir:
        return None
    ckpts = CheckpointManager(checkpoint_dir)
    _, at = ckpts.restore(TrainState.create(model, make_optimizer(1e-4)),
                          variables_only=True)
    ckpts.close()
    if at:
        print(f'restored checkpoint step {at}')
    elif required:
        raise FileNotFoundError(
            f'no checkpoint under {checkpoint_dir} — refusing to export '
            'random weights silently')
    return at


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
    host pipeline, whose augmented pixels it dumps. `profile_dir` captures
    a profiler trace of the whole fit there (`utils.profiling`).
    """
    import contextlib
    from object_tracking_tpu_torch.data import (
        SequenceBatches, make_sequence_windows, parse_annotation_dir)
    from object_tracking_tpu_torch.training import (
        TrainState, fit, make_joint_eval_step, make_joint_eval_step_fused,
        make_joint_train_step, make_joint_train_step_fused, make_optimizer)

    device = resolve_device(device)
    labels = cfg.joint.labels
    size = image_size or cfg.detector.image_h
    gh, gw = size // 32, size // 32
    if synthetic:
        labels = ('1', '2')
        cfg = _synthetic_dirs(cfg, (size, size), labels, workdir=workdir)
    logs, models_dir, mesh, shard_fn = _common_setup(cfg, workdir, device)

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

    # sequence parallelism: time_shards > 1 shards the clip's time axis
    # over the mesh's data axis, and the host batches are sliced to match
    ts = cfg.joint.time_shards
    if ts > 1:
        from object_tracking_tpu_torch.parallel import shard_batch
        if cfg.joint.sequence_length % ts:
            raise ValueError(
                f'time_shards={ts} must divide sequence_length='
                f'{cfg.joint.sequence_length}')
        shard_fn = lambda b: shard_batch(mesh, b, axis=1)  # noqa: E731
    model = _joint_model(cfg, labels, mesh)
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
            augment=cfg.train.augment, mesh=mesh, **enc)
        eval_step = make_joint_eval_step_fused(
            cfg.detector.anchors, cfg.loss, cfg.joint, mesh=mesh, **enc)
    else:
        train_step = make_joint_train_step(cfg.detector.anchors, cfg.loss,
                                           cfg.joint, mesh=mesh)
        eval_step = make_joint_eval_step(cfg.detector.anchors, cfg.loss,
                                         cfg.joint, mesh=mesh)
    trace = contextlib.nullcontext()
    if profile_dir:
        from object_tracking_tpu_torch.utils.profiling import profile_trace
        trace = profile_trace(profile_dir)
    with trace:
        state = fit(state, train_step, train_gen,
                    eval_step=eval_step, val_batches=val_gen,
                    # resumed runs continue the epoch sequence, so that
                    # saves go on past the restored step
                    epochs=at + (epochs or cfg.train.max_epochs),
                    initial_epoch=at, shard_fn=shard_fn, logger=logger,
                    checkpoints=ckpts, early_stopping=early,
                    reduce_lr=reduce_lr,
                    log_every_steps=cfg.train.log_every_steps,
                    checkpoint_every=cfg.train.checkpoint_every_epochs)
    if logger:
        logger.close()
    ckpts.close()
    return state


def _cfg_detector(cfg, labels, device, weights: bool = True, mesh=None):
    """CfgDetector of cfg.detector.cfg_path (its BatchNorm over `mesh`'s
    data group). Unchanged default (COCO) labels leave the class names to
    the cfg's class count."""
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
                       device=device, mesh=mesh)


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
    cfg.train.resume restores the latest checkpoint here too. Training
    joins the process group first, so that the detector is built over the
    mesh (BatchNorm over its data group), and each rank trains on its
    slice of the global batch.
    """
    from object_tracking_tpu_torch.models import YOLOv2Detector

    device = resolve_device(device)
    mesh = shard_fn = None
    if train or synthetic:
        logs, models_dir, mesh, shard_fn = _common_setup(cfg, workdir,
                                                         device)
    if cfg.detector.cfg_path:
        detector = _cfg_detector(cfg, cfg.detector.labels, device,
                                 mesh=mesh)
    else:
        detector = YOLOv2Detector(cfg.detector, device=device, mesh=mesh)
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
            detector = _cfg_detector(cfg, labels, device, weights=False,
                                     mesh=mesh)
        else:
            detector = YOLOv2Detector(DetectorConfig(
                labels=labels, image_h=size, image_w=size,
                grid_h=size // 32, grid_w=size // 32,
                width_div=cfg.detector.width_div), device=device, mesh=mesh)
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
        train_step = make_multihead_detector_train_step(
            heads, (size, size), cfg.loss, mesh=mesh)
    else:
        train_step = make_detector_train_step(anchors, cfg.loss, mesh=mesh)
    state = fit(state, train_step, gen,
                epochs=at + (epochs or cfg.train.max_epochs),
                initial_epoch=at, shard_fn=shard_fn, logger=logger,
                checkpoints=ckpts,
                early_stopping=early, reduce_lr=reduce_lr)
    if logger:
        logger.close()
    ckpts.close()
    return state


def _joint_predictor(cfg, labels, device, checkpoint_dir, **kwargs):
    """JointPredictor over the joint model of `cfg`, with the latest
    checkpoint under `checkpoint_dir` when there is one."""
    from object_tracking_tpu_torch.inference import JointPredictor
    device = resolve_device(device)
    model = _joint_model(cfg, labels)
    _restore_variables(model, checkpoint_dir)
    size = cfg.detector.image_h
    return JointPredictor(
        model, cfg.detector.anchors, labels,
        obj_threshold=cfg.detector.obj_threshold,
        nms_threshold=cfg.detector.nms_threshold,
        net_size=(size, size), device=device, **kwargs)


def evaluate_tracking(cfg, *, synthetic: bool = False,
                      checkpoint_dir: Optional[str] = None,
                      window: Optional[int] = None,
                      workdir: Optional[str] = None,
                      device='cuda') -> dict:
    """CLEAR-MOT (and the detection mAP) over the val split with the joint
    model, restored from `checkpoint_dir` when it holds a checkpoint; the
    Hungarian matcher, as the JAX flow evaluates. Prints and returns the
    per-video and overall metrics."""
    from object_tracking_tpu_torch.data import parse_annotation_dir
    from object_tracking_tpu_torch.evaluation import (
        evaluate_tracking_dataset)

    labels = cfg.joint.labels
    if synthetic:
        labels = ('1', '2')
        size = cfg.detector.image_h
        cfg = _synthetic_dirs(cfg, (size, size), labels, workdir=workdir)
    predictor = _joint_predictor(cfg, labels, device, checkpoint_dir,
                                 matcher='hungarian')
    anns, _ = parse_annotation_dir(cfg.train.val_annot_folder,
                                   cfg.train.val_image_folder, labels)
    results = evaluate_tracking_dataset(
        predictor, anns, window=window or cfg.joint.sequence_length)
    print(json.dumps(
        {k: {m: round(float(v), 4) for m, v in r.items()}
         for k, r in results.items()}, indent=2))
    return results


def export_serving(cfg, *, out_path: str,
                   checkpoint_dir: Optional[str] = None,
                   batch: int = 1, window: Optional[int] = None,
                   device='cuda') -> str:
    """Build the joint model (restoring the latest checkpoint under
    `checkpoint_dir`; a directory that holds none raises
    FileNotFoundError), export its clip program on `device` and write the
    serving artifact to `out_path`."""
    from object_tracking_tpu_torch.serving import export_joint, save_artifact

    device = resolve_device(device)
    labels = cfg.joint.labels
    size = cfg.detector.image_h
    t = window or cfg.joint.sequence_length
    model = _joint_model(cfg, labels)
    _restore_variables(model, checkpoint_dir, required=True)
    art = export_joint(
        model.to(device), cfg.detector.anchors, labels, batch=batch,
        window=t, net_size=(size, size),
        obj_threshold=cfg.detector.obj_threshold,
        nms_threshold=cfg.detector.nms_threshold)
    save_artifact(art, out_path)
    print(f'wrote serving artifact {out_path} ({len(art) / 1e6:.1f} MB, '
          f'traced on {device}, B={batch} T={t} {size}x{size})')
    return out_path


def convert_dataset(kind: str, src: str, out_dir: str, *,
                    class_map_path: Optional[str] = None,
                    validation_split: float = 0.25) -> int:
    """MOT17 / VisualTB → per-frame PASCAL-VOC XML trees (train/val[/test]).

    `class_map_path` (VisualTB only): JSON mapping sequence dir → class
    name, either a bare map or a legacy config.json with a 'classes_map'
    block.
    """
    from object_tracking_tpu_torch.data.converters import (
        mot_to_voc, visualtb_to_voc)

    if kind == 'mot':
        subdirs = [os.path.join(src, d) for d in ('train', 'test')
                   if os.path.isdir(os.path.join(src, d))]
        n = mot_to_voc(subdirs or [src], out_dir,
                       validation_split=validation_split)
    elif kind == 'visualtb':
        if not class_map_path:
            raise ValueError('visualtb conversion needs --class-map '
                             '(sequence → class JSON)')
        with open(class_map_path) as f:
            cm = json.load(f)
        cm = cm.get('classes_map', cm)     # accept a legacy config.json
        n = visualtb_to_voc(src, os.path.join(out_dir, 'train'),
                            os.path.join(out_dir, 'val'), cm,
                            validation_split=validation_split)
    else:
        raise ValueError(f'unknown converter kind {kind!r}')
    print(f'wrote {n} annotation files under {out_dir}')
    return n


def track_video(cfg, *, frames_dir: str, out_dir: str,
                checkpoint_dir: Optional[str] = None,
                window: Optional[int] = None,
                matcher: str = 'greedy',
                out_video: Optional[str] = None,
                fps: Optional[float] = None, device='cuda') -> list:
    """Run the joint model over a directory of frames (or a video file,
    decoded with cv2), drawing per-track coloured boxes with persistent
    ids into `out_dir`; returns the per-frame detections. `out_video`
    also assembles the drawn frames into one video file (container and
    codec by extension, e.g. `.mp4` / `.avi`); `fps=None` takes a source
    video's frame rate, else 25."""
    predictor = _joint_predictor(cfg, cfg.joint.labels, device,
                                 checkpoint_dir, matcher=matcher)
    tmp = None
    try:
        if os.path.isfile(frames_dir):
            import cv2
            cap = cv2.VideoCapture(frames_dir)
            if not cap.isOpened():
                raise FileNotFoundError(frames_dir)
            if fps is None:
                src_fps = cap.get(cv2.CAP_PROP_FPS)
                if src_fps and src_fps > 0:
                    fps = float(src_fps)
            tmp = tempfile.mkdtemp(prefix='ott_video_')
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                cv2.imwrite(os.path.join(tmp, f'{i:06d}.jpg'), frame)
                i += 1
            cap.release()
            frames_dir = tmp
        exts = ('.jpg', '.jpeg', '.png')
        paths = sorted(
            os.path.join(frames_dir, f) for f in os.listdir(frames_dir)
            if f.lower().endswith(exts))
        if not paths:
            raise FileNotFoundError(f'no frames in {frames_dir}')
        results = predictor.predict_video(
            paths, window=window or cfg.joint.sequence_length,
            draw_dir=out_dir)
        n_tracks = len({d['track_id'] for dets in results for d in dets})
        print(f'{len(paths)} frames → {out_dir} ({n_tracks} tracks)')
        if out_video:
            _write_video(out_dir, paths, out_video, fps or 25.0)
            print(f'video → {out_video}')
        return results
    finally:
        if tmp is not None:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)


def _write_video(drawn_dir: str, frame_paths, out_path: str,
                 fps: float) -> None:
    """Assemble the drawn frames (named after their sources in
    `drawn_dir`) into one video file with cv2.VideoWriter."""
    import cv2
    first = cv2.imread(os.path.join(
        drawn_dir, os.path.basename(frame_paths[0])))
    if first is None:
        raise FileNotFoundError(
            f'no drawn frame for {frame_paths[0]} in {drawn_dir}')
    h, w = first.shape[:2]
    ext = os.path.splitext(out_path)[1].lower()
    fourcc = cv2.VideoWriter_fourcc(*('MJPG' if ext == '.avi' else 'mp4v'))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f'cv2.VideoWriter could not open {out_path}')
    skipped = 0
    try:
        for p in frame_paths:
            img = cv2.imread(os.path.join(drawn_dir, os.path.basename(p)))
            if img is None:
                skipped += 1
                continue
            if img.shape[:2] != (h, w):
                img = cv2.resize(img, (w, h))
            writer.write(img)
    finally:
        writer.release()
    if skipped:
        import warnings
        warnings.warn(
            f'{skipped}/{len(frame_paths)} drawn frames missing from '
            f'{drawn_dir}; the output video is shorter than the input',
            stacklevel=2)


def _load_cfg(args):
    from object_tracking_tpu_torch.config import Config, load_config
    cfg = load_config(args.config) if args.config else Config()
    if getattr(args, 'epochs', None):
        cfg.train.max_epochs = args.epochs
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog='object_tracking_tpu_torch.trainer',
        description='Detection and tracking trainer: the PyTorch port, on '
        'one CUDA card (or the CPU with --device cpu).',
        epilog='The JAX trainer keeps a persistent XLA compile cache '
        '(OTT_COMPILE_CACHE); the port has no counterpart: it compiles '
        'nothing ahead of time but its CUDA kernels, which build at first '
        'use into build/kernels/ and are reused from there.')
    p.add_argument('--config', help='config JSON (new or legacy layout)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default; without a card the flows "
                   "raise) or 'cpu'")
    sub = p.add_subparsers(dest='cmd', required=True)

    ps = sub.add_parser('single', help='single-object tracking '
                        '(TinyTracker / TinyHeatmapTracker)')
    ps.add_argument('--synthetic', action='store_true')
    ps.add_argument('--epochs', type=int)
    ps.add_argument('--heatmap', action='store_true')

    pj = sub.add_parser('joint', help='simultaneous multi-object '
                        'detection + tracking')
    pj.add_argument('--synthetic', action='store_true')
    pj.add_argument('--epochs', type=int)
    pj.add_argument('--image-size', type=int, default=None)
    pj.add_argument('--profile-dir', help='capture a torch.profiler trace '
                    '(host, and the card when there is one) of the whole '
                    'fit into this directory')

    pd = sub.add_parser('detect', help='standalone YOLOv2 detector')
    pd.add_argument('--image', action='append', default=[])
    pd.add_argument('--cfg', help='darknet .cfg to build the detector '
                    'from (any yolov2/tiny/v3-family graph)')
    pd.add_argument('--weights', help='darknet .weights to ingest')
    pd.add_argument('--out-dir', default='.')
    pd.add_argument('--train', action='store_true')
    pd.add_argument('--synthetic', action='store_true')
    pd.add_argument('--epochs', type=int)

    pt = sub.add_parser('track', help='run the joint tracker over a '
                        'frame directory, drawing per-track boxes')
    pt.add_argument('--frames', required=True,
                    help='directory of frames OR a video file (decoded '
                    'with cv2)')
    pt.add_argument('--out-dir', default='tracked')
    pt.add_argument('--checkpoint-dir')
    pt.add_argument('--window', type=int)
    pt.add_argument('--matcher', choices=['greedy', 'hungarian'],
                    default='greedy')
    pt.add_argument('--out-video',
                    help='also assemble the drawn frames into one video '
                    'file (.mp4/.avi)')
    pt.add_argument('--fps', type=float, default=None,
                    help="frame rate for --out-video (default: the "
                    "source video's rate, or 25 for frame dirs)")

    pe = sub.add_parser('eval', help='CLEAR-MOT tracking evaluation')
    pe.add_argument('--synthetic', action='store_true')
    pe.add_argument('--checkpoint-dir')
    pe.add_argument('--window', type=int)

    px = sub.add_parser('export', help='export the joint clip program '
                        '(trained weights baked in) to one self-contained '
                        'serving artifact (torch.export), traced on '
                        '--device')
    px.add_argument('--out', required=True, help='artifact output path')
    px.add_argument('--checkpoint-dir', help='checkpoint to bake in '
                    '(omitted = freshly initialised weights, for smoke '
                    'tests only)')
    px.add_argument('--batch', type=int, default=1,
                    help='clip streams per call')
    px.add_argument('--window', type=int)

    pc = sub.add_parser('convert', help='offline dataset converters '
                        '(MOT17 / VisualTB → PASCAL-VOC XML)')
    pc.add_argument('kind', choices=['mot', 'visualtb'])
    pc.add_argument('--src', required=True,
                    help='dataset root (MOT17 root with train/test, or '
                    'VisualTB root of sequence dirs)')
    pc.add_argument('--out', required=True, help='output XML root')
    pc.add_argument('--class-map',
                    help='VisualTB sequence→class JSON (bare map or '
                    'legacy config.json with classes_map)')
    pc.add_argument('--val-split', type=float, default=0.25)

    args = p.parse_args(argv)
    if args.cmd == 'convert':
        convert_dataset(args.kind, args.src, args.out,
                        class_map_path=args.class_map,
                        validation_split=args.val_split)
        return 0
    cfg = _load_cfg(args)
    device = args.device
    if args.cmd == 'single':
        if args.heatmap:
            cfg.tracker.name = 'TinyHeatmapTracker'
        single_object_tracking(cfg, synthetic=args.synthetic,
                               epochs=args.epochs, device=device)
    elif args.cmd == 'joint':
        simult_multi_obj_detection_tracking(
            cfg, synthetic=args.synthetic, epochs=args.epochs,
            image_size=args.image_size, profile_dir=args.profile_dir,
            device=device)
    elif args.cmd == 'detect':
        if args.cfg:
            cfg.detector.cfg_path = args.cfg
        if args.weights:
            cfg.detector.weights_path = args.weights
        keras_yolo_obj_detection(cfg, images=args.image,
                                 out_dir=args.out_dir, train=args.train,
                                 synthetic=args.synthetic,
                                 epochs=args.epochs, device=device)
    elif args.cmd == 'track':
        track_video(cfg, frames_dir=args.frames, out_dir=args.out_dir,
                    checkpoint_dir=args.checkpoint_dir,
                    window=args.window, matcher=args.matcher,
                    out_video=args.out_video, fps=args.fps, device=device)
    elif args.cmd == 'eval':
        evaluate_tracking(cfg, synthetic=args.synthetic,
                          checkpoint_dir=args.checkpoint_dir,
                          window=args.window, device=device)
    elif args.cmd == 'export':
        export_serving(cfg, out_path=args.out,
                       checkpoint_dir=args.checkpoint_dir,
                       batch=args.batch, window=args.window, device=device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
