"""Joint multi-object detection + tracking model.

Port of `object_tracking_tpu/models/multi_obj_det_tracker.py`:

- the shared Darknet-19 detector runs over every frame with time folded
  into the batch (B·T);
- detection head = the per-frame netout reshaped to (B, T, GH, GW, A, 5+C);
- tracking head = concat(flat netout, conv_feat) along channels →
  FusedConvLSTM over time (`tconv_lstm`) → with `convlstm_layers` L > 1,
  L−1 homogeneous F→F layers (`tconv_stack`, a StackedConvLSTM) → 1x1
  conv `tconv_2` to A·(5+C), or with `moe_experts` > 0 the mixture-of-
  experts head `tconv_moe` (`models/moe_head.py`), whose Switch auxiliary
  loss the output dict carries as 'moe_aux'.

With a `mesh` (`parallel.mesh.Mesh`) each rank holds a share of the
global batch, along B, or along T when `time_shards` > 1 (sequence
parallelism: the first ConvLSTM layer's recurrence runs through the
context-parallel ring over the data axis). BatchNorm statistics and the
MoE routing then span the data group, and 'moe_aux' is this rank's share
of the global auxiliary loss; inside `parallel.mesh.whole_batch()` (a
batch that `shard_batch` replicated: every rank holds all of it) they are
this rank's own, the one-rank model's. `pp_layers` runs the stacked layers as a
pipeline over the model axis (one layer per rank).

The flat netout's channel is a·(5+C)+k in both frameworks, so the NCHW
concat of the head conv's output with conv_feat is the JAX concat.

`remat=True` runs the detector under `torch.utils.checkpoint` (non-
reentrant), as the JAX model wraps it in `nn.remat`: its activations are
recomputed in backward instead of kept. The recomputation writes no
BatchNorm running statistic, so a training step updates them once.
Images (B, T, H, W, 3), outputs and the (c, h) state keep the JAX layouts;
the state is (c, h), each (B, GH, GW, F), and for a deep head
((c, h), (cs, hs)) with cs and hs (L−1, B, GH, GW, F), as in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from object_tracking_tpu_torch.models.convlstm import (
    FusedConvLSTM, StackedConvLSTM)
from object_tracking_tpu_torch.models.darknet19 import Darknet19, conv
from object_tracking_tpu_torch.models.moe_head import MoEGridHead
from object_tracking_tpu_torch.parallel.mesh import (
    in_whole_batch, whole_batch)


@contextlib.contextmanager
def _recomputing(module: nn.Module, whole: bool):
    """`module` in eval() mode for the block, and `whole_batch(whole)` as
    the forward had it: the recomputation under `remat` (which may run on
    another thread) normalises as the forward did and writes no running
    statistic a second time."""
    was = module.training
    module.train(False)
    try:
        with whole_batch() if whole else contextlib.nullcontext():
            yield
    finally:
        module.train(was)


class MultiObjDetTracker(nn.Module):
    """Joint detect+track model: `convlstm_layers` ConvLSTM layers and the
    dense 1x1 track head, or the MoE head (`moe_experts` experts of
    `moe_hidden` hidden units)."""

    def __init__(self, num_classes: int = 12, num_anchors: int = 5,
                 convlstm_features: int = 512,
                 dtype: torch.dtype = torch.float32, width_div: int = 1,
                 remat: bool = False, moe_experts: int = 0,
                 moe_hidden: int = 256, time_shards: int = 1,
                 convlstm_layers: int = 1, pp_layers: bool = False,
                 mesh: Any = None):
        super().__init__()
        self.mesh = mesh
        self.time_shards = time_shards
        self.moe_experts = moe_experts
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.convlstm_features = convlstm_features
        self.convlstm_layers = convlstm_layers
        self.dtype = dtype
        self.remat = remat
        self.detector = Darknet19(num_classes, num_anchors, dtype, width_div,
                                  mesh=mesh)
        out_ch = num_anchors * (5 + num_classes)
        self.tconv_lstm = FusedConvLSTM(out_ch + self.detector.feat_channels,
                                        convlstm_features, 3, dtype,
                                        time_shards=time_shards, mesh=mesh)
        if convlstm_layers > 1:
            self.tconv_stack = StackedConvLSTM(
                convlstm_features, convlstm_layers - 1, 3, dtype,
                pipeline=pp_layers, mesh=mesh)
        if moe_experts:
            self.tconv_moe = MoEGridHead(convlstm_features, moe_experts,
                                         moe_hidden, out_ch, dtype=dtype)
        else:
            self.tconv_2 = nn.Conv2d(convlstm_features, out_ch, 1)

    def zero_state(self, batch: int, grid_h: int, grid_w: int):
        """Initial streaming state (c, h), each (B, GH, GW, F) float32;
        for a deep head ((c, h), (cs, hs)), cs and hs (L−1, B, GH, GW, F)."""
        shape = (batch, grid_h, grid_w, self.convlstm_features)
        device = self.tconv_lstm.recurrent_kernel.device
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        if self.convlstm_layers > 1:
            zs = torch.zeros((self.convlstm_layers - 1,) + shape,
                             dtype=torch.float32, device=device)
            return ((z, z), (zs, zs))
        return (z, z)

    def forward(self, images: torch.Tensor, train: bool = False,
                initial_state: Optional[tuple] = None,
                return_state: bool = False):
        """images (B, T, H, W, 3) in [0, 1] →
        {'detect': (B, T, GH, GW, A, 5+C), 'track': same, float32
         [, 'moe_aux': the MoE head's auxiliary loss, a float32 scalar]
         [, 'state': the final state in `zero_state`'s form, in the
         compute dtype, when return_state]}.

        `train=True` normalises with batch statistics over all B·T frames;
        in `train()` mode it also updates the running statistics, in
        `eval()` mode (serving's bn_mode='batch') it writes none.
        """
        b, t, h, w, c = images.shape
        flat = images.reshape(b * t, h, w, c)
        if self.remat and torch.is_grad_enabled():
            head, feat = checkpoint(
                self.detector.features, flat, train, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), _recomputing(
                    self.detector, in_whole_batch())))
        else:
            head, feat = self.detector.features(flat, train)
        _, out_ch, gh, gw = head.shape
        a, k = self.num_anchors, 5 + self.num_classes
        detect = head.float().permute(0, 2, 3, 1).reshape(b, t, gh, gw, a, k)

        z = torch.cat([head.to(self.dtype), feat], dim=1)
        z = z.reshape(b, t, z.shape[1], gh, gw)
        deep = self.convlstm_layers > 1
        state0 = stack0 = None
        if initial_state is not None:
            first = initial_state[0] if deep else initial_state
            state0 = tuple(s.permute(0, 3, 1, 2) for s in first)
            if deep:
                stack0 = tuple(s.permute(0, 1, 4, 2, 3)
                               for s in initial_state[1])
        if return_state:
            z, state = self.tconv_lstm(z, initial_state=state0,
                                       return_state=True)
            state = tuple(s.permute(0, 2, 3, 1) for s in state)
        else:
            z = self.tconv_lstm(z, initial_state=state0)
        if deep:
            if return_state:
                z, stacked = self.tconv_stack(z, initial_state=stack0,
                                              return_state=True)
                state = (state, tuple(s.permute(0, 1, 3, 4, 2)
                                      for s in stacked))
            else:
                z = self.tconv_stack(z, initial_state=stack0)
        aux = None
        if self.moe_experts:
            # JAX's token order: (B, T, GH, GW) flattened, channels last;
            # a time-sharded rank's tokens are B runs of the global order
            group = None if self.mesh is None else self.mesh.data_group
            track, aux = self.tconv_moe(
                z.permute(0, 1, 3, 4, 2), group=group,
                segments=b if self.time_shards > 1 else 1)
        else:
            track = conv(z.reshape(b * t, self.convlstm_features, gh, gw),
                         self.tconv_2).permute(0, 2, 3, 1)
        out = {'track': track.float().reshape(b, t, gh, gw, a, k),
               'detect': detect}
        if aux is not None:
            out['moe_aux'] = aux
        if return_state:
            out['state'] = state
        return out
