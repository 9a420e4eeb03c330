"""Training flows.

Port of the joint flow of `object_tracking_tpu/trainer.py`,
`simult_multi_obj_detection_tracking`: generators → steps → fit loop with
the checkpoint / early-stop / plateau-LR / metric-logging stack, on one
device ('cuda' unless the caller passes `device='cpu'`; a missing card
raises). `synthetic=True` fabricates a small dataset first and trains on
it. The single-object and detector flows and the command line wait for
their items (ROADMAP.md queue 1, items 11, 13 and 15).

A model trained from scratch starts as flax starts the JAX one
(`models.darknet19.init_like_flax`): torch's default conv init has a third
of lecun_normal's variance, which would make it another experiment.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

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


def _not_ported(cfg, profile_dir) -> list:
    """The JAX flow's options that the port does not have yet."""
    later = []
    if getattr(getattr(cfg, 'mesh', None), 'distributed', False):
        later.append('mesh.distributed (queue 1, item 16)')
    if cfg.joint.time_shards > 1:
        later.append('joint.time_shards > 1 (queue 1, item 16)')
    if cfg.joint.moe_experts:
        later.append('joint.moe_experts (queue 1, item 16)')
    if cfg.joint.convlstm_layers > 1:
        later.append('joint.convlstm_layers > 1 (queue 1, item 5)')
    if profile_dir:
        later.append('profile_dir (queue 1, item 16)')
    return later


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

    later = _not_ported(cfg, profile_dir)
    if later:
        raise NotImplementedError('not ported yet, see ROADMAP.md: '
                                  + ', '.join(later))
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
    at = 0
    if cfg.train.resume:
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
