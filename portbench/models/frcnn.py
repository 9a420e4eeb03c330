"""Faster R-CNN VGG16 served: the program's
`models/faster_rcnn.py::FasterRCNN` behind `FasterRCNNDetector.
detect_images`. The reference is `reference/frcnn.py`, written from
py-faster-rcnn's test net and test settings.

Weights: `weights.py`'s seeded draw with each layer's standard deviation
set through its fan_in (`reference/frcnn.py::spec`, the configuration's
`init`). The configuration's `assumed` says why the trunk and fc6/fc7
take sqrt(1 / fan_in) and not He's draw. Served only: the training
entries raise.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench import peaks
from portbench.reference import frcnn as ref

BYTES_PER_FLOAT = 4


def weight_spec(cfg: dict) -> list:
    return ref.spec(cfg)


def conv_table(cfg: dict) -> list:
    """Every convolution, and the RoI head's GEMMs over
    `post_nms_top_n` RoIs a frame, in `flops.py`'s form."""
    return [(name, fl, True) for name, fl in ref.flops(cfg)]


def settings(cfg: dict):
    from object_tracking_tpu_torch.models.faster_rcnn import RCNNSettings
    return RCNNSettings(
        scale=cfg['scale'], pre_nms_top_n=cfg['pre_nms_top_n'],
        post_nms_top_n=cfg['post_nms_top_n'],
        rpn_nms_thresh=cfg['rpn_nms_thresh'],
        rpn_min_size=cfg['rpn_min_size'], score_thresh=cfg['score_thresh'],
        nms_thresh=cfg['nms_thresh'], max_per_image=cfg['max_per_image'])


def program(cfg: dict, dtype: torch.dtype):
    """The program's module (float32: the kernel and the configuration's
    precision)."""
    from object_tracking_tpu_torch.models.faster_rcnn import FasterRCNN
    if dtype != torch.float32:
        raise ValueError(f'Faster R-CNN cells run float32, not {dtype}')
    return FasterRCNN(len(cfg['labels']), settings(cfg))


def roi_pool_bound_s(rois: int, channels: int, bins: int,
                     map_elements: int) -> float:
    """Least seconds of one RoI-pooling launch: the pooled output written
    once and the feature map read once, float32, at HBM's rate (a max is
    one comparison a read: bytes bound it)."""
    return ((rois * channels * bins + map_elements) * BYTES_PER_FLOAT
            / peaks.HBM_BYTES)


# ---------------------------------------------------------- the reference
def reference_forward(w: dict, cfg: dict, frames: torch.Tensor,
                      allow_tf32: bool = False) -> dict:
    """The trunk and RPN: {'conv5_3', 'rpn_fg', 'rpn_deltas'}."""
    return ref.forward(w, frames, cfg, allow_tf32)


def reference_proposals(fg: torch.Tensor, deltas: torch.Tensor, cfg: dict
                        ) -> List[torch.Tensor]:
    return ref.proposals(fg, deltas, cfg, tuple(cfg['image_hw']))


def reference_head(w: dict, cfg: dict, conv5: torch.Tensor,
                   rois: torch.Tensor, allow_tf32: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RoI pool and head on conv5_3 and every row of rois (N, R, 4):
    (cls_prob (N, R, classes), bbox_pred (N, R, 4·classes))."""
    return ref.pool_and_head(w, conv5, rois, 1.0 / ref.STRIDE, allow_tf32)


def reference_detections(out: dict, cfg: dict) -> list:
    return ref.detections(out['cls_prob'], out['bbox_pred'], out['rois'],
                          out['roi_valid'], cfg, tuple(cfg['image_hw']))


def _served_only(*args, **kwargs):
    raise NotImplementedError('Faster R-CNN cells serve; no training step')


program_step = train_batches = reference_batch = reference_loss = \
    _served_only
