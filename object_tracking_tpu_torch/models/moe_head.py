"""Mixture-of-experts grid head: the tracking head's expert option.

Port of `object_tracking_tpu/models/moe_head.py`. Every grid cell's
ConvLSTM feature vector is a token; tokens route top-1 to one of E expert
MLPs (Switch-style, fixed capacity, overflow drops to zero) and the
chosen expert's output is scaled by its gate probability. It replaces
the dense 1x1 conv `tconv_2` of the joint model when `moe_experts` > 0.

The parameters keep JAX's names, shapes and init scales: `gate` (D, E),
`w1` (E, D, H) and `w2` (E, H, O) normal / sqrt(fan_in), `b1` and `b2`
zero; they are cast to the compute dtype at each call. Flax's `sow` has
no counterpart: the forward returns the Switch auxiliary loss beside the
output.

Which tokens overflow depends on the token order, so the tokens are taken
in JAX's order, (B, T, GH, GW) flattened channels-last.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from object_tracking_tpu_torch.parallel.expert import moe_apply
from object_tracking_tpu_torch.parallel.sharding import held


class MoEGridHead(nn.Module):
    """Per-grid-cell top-1 MoE head: (..., D) tokens → (..., out_features),
    all leading axes flattened into one token axis (`num_groups` routing
    groups of consecutive tokens)."""

    # every leaf is gathered at use when tensor parallelism shards it
    tp_leaves = ('gate', 'w1', 'b1', 'w2', 'b2')

    def __init__(self, features: int, num_experts: int, hidden: int,
                 out_features: int, capacity_factor: float = 1.25,
                 num_groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.num_groups = num_groups
        self.dtype = dtype
        e, d, h, o = num_experts, features, hidden, out_features
        self.gate = nn.Parameter(torch.empty(d, e))
        self.w1 = nn.Parameter(torch.empty(e, d, h))
        self.b1 = nn.Parameter(torch.empty(e, h))
        self.w2 = nn.Parameter(torch.empty(e, h, o))
        self.b2 = nn.Parameter(torch.empty(e, o))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """JAX's init: normal / sqrt(fan_in) weights, zero biases."""
        d, h = self.w1.shape[1], self.w1.shape[2]
        for weight, fan_in in ((self.gate, d), (self.w1, d), (self.w2, h)):
            weight.normal_().div_(math.sqrt(fan_in))
        self.b1.zero_()
        self.b2.zero_()

    # init_like_flax draws every module's own init through this hook
    reset_recurrent_parameters = reset_parameters

    def forward(self, z: torch.Tensor, group=None, segments: int = 1):
        """z (..., D) channels-last → (out (..., O), aux), both in the
        compute dtype / float32. With a data `group` the tokens are this
        rank's share of the global token order (`segments` runs, see
        `parallel.expert._route`) and aux is this rank's share of the
        global auxiliary loss. Tokens every rank holds alike (a
        replicated batch) come with no group: one routing group of
        theirs, in their own order."""
        *lead, d = z.shape
        params = {k: held(self, k).to(self.dtype) for k in self.tp_leaves}
        tokens = z.reshape(-1, d).to(self.dtype)
        out, aux = moe_apply(params, tokens, num_groups=self.num_groups,
                             capacity_factor=self.capacity_factor,
                             return_aux=True, group=group,
                             segments=segments)
        return out.reshape(*lead, -1), aux
