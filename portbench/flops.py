"""Operations of the benchmark's models, counted from their shapes.

A convolution counts 2·MAC. A training step counts each convolution's
forward, its filter gradient and, where its input needs a gradient, its
input gradient: not for the first convolution (the images) and not for
the ConvLSTM's recurrent convolution at the first step of a window (its
state starts at zero). Only convolutions count (BatchNorm, activations,
pooling and the loss are a fraction of a percent of the operations).
The layer plan is the reference's frozen copy (`reference.model`); each
model kind (`models/`) says which tables make up its model.

NMS kernel 1's least work (`nms_bound`): the F·K² IoU pairs at 14
operations each and, per kept (candidate, class), one walk round of 3
operations over K candidates; its bytes are the boxes and scores read
once and the scores written once.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench import models, peaks
from portbench.reference.model import (
    darknet_convs, feat_channels, head_channels)

IOU_OPS_PER_PAIR = 14
WALK_OPS_PER_CANDIDATE = 3


def darknet_table(cfg: dict) -> Tuple[List[Tuple[str, float, bool]], int]:
    """(name, forward FLOPs a frame, input gradient taken) of Darknet-19's
    convolutions and its head at the configured image size, and the side
    of the grid they leave."""
    rows, h = [], cfg['image']
    tap = None
    for idx, c_in, c_out, k in darknet_convs(cfg):
        side = tap if idx == 21 else h
        rows.append((f'conv_{idx}', 2.0 * side * side * k * k * c_in * c_out,
                     idx != 1))
        if idx == 13:
            tap = h
        if idx in (1, 2, 5, 8, 13):
            h //= 2
    heads, feats = head_channels(cfg), feat_channels(cfg)
    rows.append(('conv_23', 2.0 * h * h * feats * heads, True))
    return rows, h


def convlstm_table(cfg: dict, h: int) -> List[Tuple[str, float, bool]]:
    """The joint model's ConvLSTM and track head on an h x h grid, in
    `darknet_table`'s form."""
    heads, feats = head_channels(cfg), feat_channels(cfg)
    f = cfg['convlstm_features']
    return [('input_proj', 2.0 * h * h * 9 * (heads + feats) * 4 * f, True),
            ('recurrent', 2.0 * h * h * 9 * f * 4 * f, True),
            ('tconv_2', 2.0 * h * h * f * heads, True)]


def conv_table(cfg: dict) -> List[Tuple[str, float, bool]]:
    """Every convolution of the configured model (its kind's table)."""
    return models.kind(cfg).conv_table(cfg)


def forward_per_frame(cfg: dict) -> float:
    return sum(fl for _, fl, _ in conv_table(cfg))


def train_per_frame(cfg: dict, window: int) -> float:
    """A training step's FLOPs per frame of a window of `window` frames."""
    total = 0.0
    for name, fl, grad in conv_table(cfg):
        share = (window - 1) / window if name == 'recurrent' else 1.0
        total += fl * (2.0 + (share if grad else 0.0))
    return total


def nms_bound_s(kept_positive: int, frames: int, k: int, c: int) -> float:
    """Least seconds of one NMS launch: the larger of its bytes over HBM's
    rate and its operations over the float32 rate."""
    nbytes = frames * k * (4 + c) * 4 + frames * k * c * 4
    ops = (frames * k * k * IOU_OPS_PER_PAIR
           + kept_positive * k * WALK_OPS_PER_CANDIDATE)
    return max(nbytes / peaks.HBM_BYTES, ops / peaks.FP32_FLOPS)
