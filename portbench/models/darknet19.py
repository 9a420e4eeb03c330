"""YOLOv2's detector alone: the program's `Darknet19`, trained through
`make_detector_train_step` on images whose targets the benchmark encodes
(the data pipeline's work, as `DetectionBatches` does on the host)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import flops
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train


def weight_spec(cfg: dict) -> list:
    return ref_model.darknet_spec(cfg, '')


def conv_table(cfg: dict) -> list:
    return flops.darknet_table(cfg)[0]


def program(cfg: dict, dtype: torch.dtype):
    from object_tracking_tpu_torch.models import Darknet19
    return Darknet19(cfg['num_classes'], cfg['num_anchors'], dtype,
                     width_div=cfg.get('width_div', 1))


def program_step(cfg: dict, mix: dict, loss_cfg):
    from object_tracking_tpu_torch.training import make_detector_train_step
    return make_detector_train_step(cfg['anchors'], loss_cfg)


def train_batches(pool: list, cfg: dict) -> list:
    """One frame a sample: images (B, H, W, 3) float32 in [0, 1] and the
    targets of their boxes."""
    out = []
    for raw in pool:
        y, tb = ref_train.encode_targets(raw['boxes'][:, 0],
                                         raw['cls'][:, 0],
                                         raw['valid'][:, 0], cfg)
        out.append({'images': raw['images_u8'][:, 0].astype(np.float32)
                    / np.float32(255.0), 'y_true': y, 'true_boxes': tb})
    return out


def reference_batch(batch: dict, cfg: dict, device) -> tuple:
    return tuple(torch.as_tensor(batch[k]).to(device)
                 for k in ('images', 'y_true', 'true_boxes'))


def reference_loss(w: dict, cfg: dict, batch: tuple) -> torch.Tensor:
    return ref_train.detector_loss(w, cfg, batch)
