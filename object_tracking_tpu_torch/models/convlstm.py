"""ConvLSTM recurrences with the input projection batched over time.

Port of `FusedConvLSTM` and `StackedConvLSTM` (sequential mode) in
`object_tracking_tpu/models/convlstm.py`:

- the input projection `W_x * x_t` for all four gates runs once, with time
  folded into the batch (B·T), as one large conv;
- a Python loop over T then carries only the recurrent conv `W_h * h`
  (F → 4F) and the gate elementwise math.

Gate order along the 4F channels is (i, f, g, o). NCHW throughout:
x (B, T, C, H, W), state (c, h) each (B, F, H, W), or (L, B, F, H, W) for
the stacked layers.

The parallel modes of the JAX layers: `FusedConvLSTM(time_shards > 1)`
runs its recurrence through `parallel.context.context_parallel_scan` over
the mesh's data axis (each rank holds and projects T/n frames), and
`StackedConvLSTM(pipeline=True)` runs its layers through
`parallel.pipeline.pipeline_scan` over the model axis, each rank holding
only its layer's slice of the stacked parameters.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.models.darknet19 import conv
from object_tracking_tpu_torch.parallel.context import context_parallel_scan
from object_tracking_tpu_torch.parallel.pipeline import pipeline_scan
from object_tracking_tpu_torch.parallel.sharding import (
    column_conv, column_operands)


def _cell(wh: torch.Tensor, carry, xt: torch.Tensor, group=None):
    """One ConvLSTM step: xt (B, 4F, H, W) the projected input with its
    bias, carry (c, h) → ((c, h), h). With a model `group`, wh is this
    rank's block of the 4F gate channels (tensor parallelism)."""
    c_t, h_t = carry
    gates = xt + column_conv(h_t, wh, None, wh.shape[-1] // 2, group)
    gi, gf, gg, go = gates.chunk(4, dim=1)
    c_t = torch.sigmoid(gf) * c_t + torch.sigmoid(gi) * torch.tanh(gg)
    h_t = torch.sigmoid(go) * torch.tanh(c_t)
    return (c_t, h_t), h_t


def _recur(xp: torch.Tensor, wh: torch.Tensor, c_t: torch.Tensor,
           h_t: torch.Tensor, group=None):
    """The sequential half of a ConvLSTM layer: xp (B, T, 4F, H, W), the
    projected inputs with their bias; wh (4F, F, kh, kw) the recurrent
    kernel (no bias), or its block of the gate channels with a model
    `group` → (h (B, T, F, H, W), final (c, h))."""
    carry, hs = (c_t, h_t), []
    for step in range(xp.shape[1]):
        carry, h = _cell(wh, carry, xp[:, step], group)
        hs.append(h)
    return torch.stack(hs, dim=1), carry


class FusedConvLSTM(nn.Module):
    """ConvLSTM layer over (B, T, C, H, W) returning all hidden states.

    Args:
      in_channels: C.
      features: hidden state channels F.
      kernel: conv kernel size for both projections (odd, 'SAME' padding).
      dtype: compute dtype (parameters stay float32).
      time_shards: > 1 time-shards the recurrence over the mesh's data
        axis (sequence parallelism): x holds this rank's T/time_shards
        frames, which it projects, and the carry passes rank to rank in
        `context_parallel_scan`'s exact ring. Requires `mesh`, whose data
        axis has time_shards ranks.
      mesh: the `parallel.mesh.Mesh` (read only when time_shards > 1).

    Under tensor parallelism (`parallel.sharding`) the input projection
    and the recurrent conv are column-parallel over the gate channels.
    """

    tp_leaves = ('recurrent_kernel',)

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32, time_shards: int = 1,
                 mesh: Any = None):
        super().__init__()
        self.time_shards = time_shards
        self.mesh = mesh
        self.features = features
        self.dtype = dtype
        self.input_proj = nn.Conv2d(in_channels, 4 * features, kernel)
        self.recurrent_kernel = nn.Parameter(
            torch.empty(4 * features, features, kernel, kernel))
        self.reset_recurrent_parameters()

    @torch.no_grad()
    def reset_recurrent_parameters(self) -> None:
        """Forget-gate bias +1 (the other gates' biases 0) and an
        orthogonal recurrent kernel, as the JAX layer initialises them."""
        f = self.features
        self.input_proj.bias.zero_()
        self.input_proj.bias[f:2 * f] = 1.0
        nn.init.orthogonal_(self.recurrent_kernel)

    def forward(self, x: torch.Tensor,
                initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]]
                = None, return_state: bool = False):
        """x (B, T, C, H, W) → h (B, T, F, H, W) [, final (c, h)]."""
        b, t, _, h, w = x.shape
        f = self.features
        xp = conv(x.reshape((b * t,) + x.shape[2:]).to(self.dtype),
                  self.input_proj).reshape(b, t, 4 * f, h, w)
        if initial_state is None:
            zeros = torch.zeros((b, f, h, w), dtype=self.dtype,
                                device=x.device)
            initial_state = (zeros, zeros)
        c_t, h_t = (s.to(self.dtype) for s in initial_state)
        wh, _, group = column_operands(self, 'recurrent_kernel', None)
        wh = wh.to(self.dtype)
        if self.time_shards > 1:
            return self._time_sharded(xp, wh, (c_t, h_t), return_state)
        ys, state = _recur(xp, wh, c_t, h_t, group)
        if return_state:
            return ys, state
        return ys

    def _time_sharded(self, xp, wh, state0, return_state: bool):
        """The recurrence of this rank's frames through the ring scan."""
        if return_state:
            raise ValueError(
                'time_shards > 1 does not return the final state (streaming '
                'uses the dense scan); set return_state=False')
        if self.mesh is None:
            raise ValueError('time_shards > 1 requires a mesh')
        axis = self.mesh.axis_names[0]
        if self.mesh.shape[axis] != self.time_shards:
            raise ValueError(
                f'time_shards={self.time_shards} must equal the mesh '
                f'{axis!r} axis size {self.mesh.shape[axis]}')
        ys = context_parallel_scan(_cell, state0, xp.transpose(0, 1),
                                   self.mesh, axis_name=axis, consts=wh)
        return ys.transpose(0, 1)


class StackedConvLSTM(nn.Module):
    """L homogeneous F→F ConvLSTM layers, run one after another: the deep
    tracking head's layers 1..L.

    Parameters are stacked on a leading layer axis, as the JAX layer's:
    `input_kernel` and `recurrent_kernel` (L, 4F, F, kh, kw) (JAX's
    (L, kh, kw, F, 4F) in OIHW), `input_bias` (L, 4F); the recurrent conv
    has no bias. The JAX layer projects each step's input inside its
    scan; here each layer projects all T steps at once (B·T), which
    differs only by rounding.

    `pipeline=True` (JAX's `pp_layers`) runs the layers as the stages of
    `pipeline_scan` over the mesh axis `axis_name`, whose size must be
    num_layers: rank s holds only layer s, as (1, …) slices of the three
    stacks (`stage` names the group, the index and the count, which the
    checkpoints read to gather the dense stacks on save). The pipelined
    path projects each step's input inside its stage, as the JAX layer
    does. It returns no final state.

    Under tensor parallelism (`parallel.sharding`) both convs of every
    layer are column-parallel over the 4F gate channels.
    """

    tp_leaves = ('input_kernel', 'input_bias', 'recurrent_kernel')

    def __init__(self, features: int, num_layers: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32, pipeline: bool = False,
                 mesh: Any = None, axis_name: str = 'model'):
        super().__init__()
        self.features = features
        self.num_layers = num_layers
        self.dtype = dtype
        self.pipeline = pipeline
        self.mesh = mesh
        self.axis_name = axis_name
        self.stage = None
        held = num_layers
        if pipeline:
            if mesh is None:
                raise ValueError('pipeline=True requires a mesh')
            if mesh.shape[axis_name] != num_layers:
                raise ValueError(
                    f'num_layers={num_layers} must equal the mesh '
                    f'{axis_name!r} axis size {mesh.shape[axis_name]}')
            group = mesh.group(axis_name)
            if group is not None:
                self.stage = (group, mesh.index(axis_name), num_layers)
                held = 1
        shape = (held, 4 * features, features, kernel, kernel)
        self.input_kernel = nn.Parameter(torch.empty(shape))
        self.input_bias = nn.Parameter(torch.empty(held, 4 * features))
        self.recurrent_kernel = nn.Parameter(torch.empty(shape))
        self.reset_recurrent_parameters()

    @torch.no_grad()
    def reset_recurrent_parameters(self) -> None:
        """Every layer's forget-gate bias +1 (the others 0) and both of its
        kernels orthogonal (the 4F output-channel vectors orthonormal), as
        the JAX layer's `stacked_orthogonal` initialises them. A pipeline
        stage draws every layer, as the dense stack does, and keeps its
        own: the same seed gives the same weights in both layouts."""
        f = self.features
        self.input_bias.zero_()
        self.input_bias[:, f:2 * f] = 1.0
        own = None if self.stage is None else self.stage[1]
        for layer in range(self.num_layers):
            for kernel in (self.input_kernel, self.recurrent_kernel):
                drawn = nn.init.orthogonal_(torch.empty(
                    kernel.shape[1:], device=kernel.device))
                if own is None:
                    kernel[layer] = drawn
                elif layer == own:
                    kernel[0] = drawn

    def forward(self, x: torch.Tensor,
                initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]]
                = None, return_state: bool = False):
        """x (B, T, F, H, W) → (B, T, F, H, W) [, final (c, h), each
        (L, B, F, H, W)], all in the compute dtype."""
        b, t, f, h, w = x.shape
        if f != self.features:
            raise ValueError(
                f'StackedConvLSTM is homogeneous: input channels {f} must '
                f'equal features {self.features}')
        if initial_state is None:
            zeros = torch.zeros((self.num_layers, b, f, h, w),
                                dtype=self.dtype, device=x.device)
            initial_state = (zeros, zeros)
        c0, h0 = (s.to(self.dtype) for s in initial_state)
        ys = x.to(self.dtype)
        pad = self.input_kernel.shape[-1] // 2
        if self.pipeline:
            return self._pipelined(ys, (c0, h0), pad, return_state)
        wx, bx, x_group = column_operands(self, 'input_kernel', 'input_bias',
                                          bias_axis=1)
        wh, _, h_group = column_operands(self, 'recurrent_kernel', None)
        finals = []
        for layer in range(self.num_layers):
            xp = column_conv(ys.reshape(b * t, f, h, w),
                             wx[layer].to(self.dtype),
                             bx[layer].to(self.dtype), pad,
                             x_group).reshape(b, t, 4 * f, h, w)
            ys, final = _recur(xp, wh[layer].to(self.dtype), c0[layer],
                               h0[layer], h_group)
            finals.append(final)
        if return_state:
            return ys, tuple(torch.stack(s) for s in zip(*finals))
        return ys

    def _pipelined(self, x, state0, pad: int, return_state: bool):
        """The layers as pipeline stages over the timesteps of x."""
        if return_state:
            raise ValueError('pipeline=True does not return the final state '
                             '(streaming uses the sequential path)')

        def stage(params, carry, xt):
            wx, bx, wh = params
            xp = F.conv2d(xt, wx.to(self.dtype), bx.to(self.dtype),
                          padding=pad)
            return _cell(wh.to(self.dtype), carry, xp)

        if self.stage is not None:          # this rank's (1, ...) slice
            s = self.stage[1]
            state0 = tuple(c[s:s + 1] for c in state0)
        ys = pipeline_scan(
            stage, (self.input_kernel, self.input_bias,
                    self.recurrent_kernel), x.transpose(0, 1), self.mesh,
            axis_name=self.axis_name, carry_init=state0)
        return ys.transpose(0, 1)
