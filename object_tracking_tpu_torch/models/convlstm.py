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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.models.darknet19 import conv


def _recur(xp: torch.Tensor, wh: torch.Tensor, c_t: torch.Tensor,
           h_t: torch.Tensor):
    """The sequential half of a ConvLSTM layer: xp (B, T, 4F, H, W), the
    projected inputs with their bias; wh (4F, F, kh, kw) the recurrent
    kernel (no bias) → (h (B, T, F, H, W), final (c, h))."""
    pad = wh.shape[-1] // 2
    hs = []
    for step in range(xp.shape[1]):
        gates = xp[:, step] + F.conv2d(h_t, wh, padding=pad)
        gi, gf, gg, go = gates.chunk(4, dim=1)
        c_t = torch.sigmoid(gf) * c_t + torch.sigmoid(gi) * torch.tanh(gg)
        h_t = torch.sigmoid(go) * torch.tanh(c_t)
        hs.append(h_t)
    return torch.stack(hs, dim=1), (c_t, h_t)


class FusedConvLSTM(nn.Module):
    """ConvLSTM layer over (B, T, C, H, W) returning all hidden states.

    Args:
      in_channels: C.
      features: hidden state channels F.
      kernel: conv kernel size for both projections (odd, 'SAME' padding).
      dtype: compute dtype (parameters stay float32).
      time_shards: only 1; sequence parallelism is a later item of the
        roadmap (queue 1, item 16).
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32, time_shards: int = 1):
        super().__init__()
        if time_shards > 1:
            raise NotImplementedError(
                'time_shards > 1 (sequence-parallel ConvLSTM) is not ported '
                'yet: ROADMAP.md queue 1, item 16 (parallel paths)')
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
        ys, state = _recur(xp, self.recurrent_kernel.to(self.dtype), c_t,
                           h_t)
        if return_state:
            return ys, state
        return ys


class StackedConvLSTM(nn.Module):
    """L homogeneous F→F ConvLSTM layers, run one after another: the deep
    tracking head's layers 1..L.

    Parameters are stacked on a leading layer axis, as the JAX layer's:
    `input_kernel` and `recurrent_kernel` (L, 4F, F, kh, kw) (JAX's
    (L, kh, kw, F, 4F) in OIHW), `input_bias` (L, 4F); the recurrent conv
    has no bias. The JAX layer projects each step's input inside its
    scan; here each layer projects all T steps at once (B·T), which
    differs only by rounding.

    `pipeline=True` (the stacked layers pipeline-parallel over a mesh,
    JAX's `pp_layers`) is a later item of the roadmap (queue 1, item 16).
    """

    def __init__(self, features: int, num_layers: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32, pipeline: bool = False):
        super().__init__()
        if pipeline:
            raise NotImplementedError(
                'pipeline=True (pipeline-parallel StackedConvLSTM) is not '
                'ported yet: ROADMAP.md queue 1, item 16 (parallel paths)')
        self.features = features
        self.num_layers = num_layers
        self.dtype = dtype
        shape = (num_layers, 4 * features, features, kernel, kernel)
        self.input_kernel = nn.Parameter(torch.empty(shape))
        self.input_bias = nn.Parameter(torch.empty(num_layers, 4 * features))
        self.recurrent_kernel = nn.Parameter(torch.empty(shape))
        self.reset_recurrent_parameters()

    @torch.no_grad()
    def reset_recurrent_parameters(self) -> None:
        """Every layer's forget-gate bias +1 (the others 0) and both of its
        kernels orthogonal (the 4F output-channel vectors orthonormal), as
        the JAX layer's `stacked_orthogonal` initialises them."""
        f = self.features
        self.input_bias.zero_()
        self.input_bias[:, f:2 * f] = 1.0
        for layer in range(self.num_layers):
            nn.init.orthogonal_(self.input_kernel[layer])
            nn.init.orthogonal_(self.recurrent_kernel[layer])

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
        finals = []
        for layer in range(self.num_layers):
            xp = F.conv2d(ys.reshape(b * t, f, h, w),
                          self.input_kernel[layer].to(self.dtype),
                          self.input_bias[layer].to(self.dtype),
                          padding=pad).reshape(b, t, 4 * f, h, w)
            ys, final = _recur(xp, self.recurrent_kernel[layer].to(
                self.dtype), c0[layer], h0[layer])
            finals.append(final)
        if return_state:
            return ys, tuple(torch.stack(s) for s in zip(*finals))
        return ys
