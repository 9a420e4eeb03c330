"""Seeded weights, made on the device in one draw.

Every tensor of a configuration's spec (its model kind's `weight_spec`)
is a view of one float32 normal drawn by a torch.Generator on the device:
convolution kernels scaled by sqrt(1 / fan_in), BatchNorm scales 1 and
shifts 0 with statistics (0, 1), biases 0 but a ConvLSTM's forget gate at
1. The same seed gives the same weights, which the benchmark loads into
the program and hands to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench import models
from portbench.traffic import torch_seed


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = models.kind(cfg).weight_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 0))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init, fan_in in spec:
        n = math.prod(shape)
        view = flat[at:at + n].view(shape)
        at += n
        if init == 'normal':
            view.mul_(1.0 / math.sqrt(fan_in))
        elif init == 'ones':
            view.fill_(1.0)
        else:
            view.zero_()
            if init == 'forget':
                view[fan_in:2 * fan_in] = 1.0
        out[name] = view
    return out
