"""The joint detect+track model: the program's `MultiObjDetTracker`
(Darknet-19, one ConvLSTM layer, the dense 1x1 track head), served by
`JointPredictor` and trained through `make_joint_train_step_fused` on raw
uint8 windows (normalise, augment with the windows' seeds, encode
targets, forward, both YOLOv2 losses, backward, Adam, all on the
device)."""

from __future__ import annotations

import torch

from portbench import flops
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train


def weight_spec(cfg: dict) -> list:
    return (ref_model.darknet_spec(cfg, 'detector.')
            + ref_model.convlstm_spec(cfg))


def conv_table(cfg: dict) -> list:
    rows, side = flops.darknet_table(cfg)
    return rows + flops.convlstm_table(cfg, side)


def program(cfg: dict, dtype: torch.dtype):
    from object_tracking_tpu_torch.models import MultiObjDetTracker
    return MultiObjDetTracker(
        num_classes=cfg['num_classes'], num_anchors=cfg['num_anchors'],
        convlstm_features=cfg['convlstm_features'], dtype=dtype,
        width_div=cfg.get('width_div', 1),
        convlstm_layers=cfg['convlstm_layers'])


def program_step(cfg: dict, mix: dict, loss_cfg):
    from object_tracking_tpu_torch.config import JointConfig
    from object_tracking_tpu_torch.training import make_joint_train_step_fused
    grid = cfg['image'] // 32
    return make_joint_train_step_fused(
        cfg['anchors'], loss_cfg, JointConfig(
            loss_weight_track=cfg['loss']['weight_track'],
            loss_weight_detect=cfg['loss']['weight_detect']),
        net_h=cfg['image'], net_w=cfg['image'], grid_h=grid, grid_w=grid,
        num_classes=cfg['num_classes'],
        true_box_buffer=cfg['true_box_buffer'], augment=mix['augment'])


def train_batches(pool: list, cfg: dict) -> list:
    """The raw windows as they are: the step does the rest."""
    return pool


def reference_batch(batch: dict, cfg: dict, device) -> tuple:
    return ref_train.joint_batch(batch, cfg, device)


def reference_loss(w: dict, cfg: dict, batch: tuple) -> torch.Tensor:
    return ref_train.joint_loss(w, cfg, batch)
