"""YOLOv4 served: darknet's `cfg/yolov4.cfg` (the configuration's `cfg`
file beside it) compiled by the program's `models/darknet_cfg.py` and run
behind `CfgDetector.detect_images`. The reference is
`reference/yolov4.py`, written from the paper's blocks.

Weights: `weights.py`'s seeded draw (sqrt(1 / fan_in) normals, BatchNorm
scale 1 and shift 0), then each BatchNorm's running statistics set to
those of its input on the first call's frames (`calibrate`, one
reference pass at set-up), as a trained network's statistics follow its
activations. With the drawn statistics (0, 1) the activations of this
depth shrink ~1e4-fold by the heads and every score ties near 0.25;
with He's sqrt(2 / fan_in) instead they sit near 1 on a random 128x128
input and overflow exp() on the benchmark's scenes (CPU walks). Served
only: the training entries raise.
"""

from __future__ import annotations

import re
from typing import List

import torch

from portbench import peaks
from portbench.cells import HERE
from portbench.reference import yolov4 as ref

BYTES_PER_MISH_ELEMENT = 8      # float32: the input read, the output written


def cfg_text(cfg: dict) -> str:
    """The configuration's darknet `.cfg`, its [net] size set to the
    configured image (unchanged at the published 608)."""
    text = (HERE / 'configs' / cfg['cfg']).read_text()
    for key in ('width', 'height'):
        text = re.sub(rf'(?m)^{key}=\d+$', f"{key}={cfg['image']}", text,
                      count=1)
    return text


def weight_spec(cfg: dict) -> list:
    return ref.layout(cfg).spec


def calibrate(w: dict, cfg: dict, images: torch.Tensor) -> List:
    """The BatchNorm statistics of `w` set from `images`, in place;
    returns the reference's heads on them."""
    return ref.calibrate(w, images, cfg['num_classes'])


def conv_table(cfg: dict) -> list:
    return [(name, flops, True) for name, flops in ref.layout(cfg).convs]


def program(cfg: dict, dtype: torch.dtype):
    from object_tracking_tpu_torch.models.darknet_cfg import build_from_cfg
    return build_from_cfg(cfg_text(cfg), dtype)[0]


def reference_heads(w: dict, cfg: dict, images: torch.Tensor) -> List:
    return ref.forward(w, images, cfg['num_classes'])


def reference_detections(heads: List, cfg: dict, obj: float) -> List:
    return ref.detections(heads, cfg, obj)


def reference_scores(heads: List, cfg: dict):
    """Every candidate's class scores, unthresholded: (N, M, C)."""
    return ref.merged(heads, cfg, 0.0)[1]


def mish_bound_s(elements: int) -> float:
    """Least seconds of Mish over `elements` float32 values: each read
    once and written once at HBM's rate (a few operations an element
    leave it bound by bytes)."""
    return elements * BYTES_PER_MISH_ELEMENT / peaks.HBM_BYTES


def _served_only(*args, **kwargs):
    raise NotImplementedError('YOLOv4 cells serve; no training step')


program_step = train_batches = reference_batch = reference_loss = \
    _served_only
