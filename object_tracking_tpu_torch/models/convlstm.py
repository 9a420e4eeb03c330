"""ConvLSTM recurrence with the input projection batched over time.

Port of `FusedConvLSTM` in `object_tracking_tpu/models/convlstm.py`:

- the input projection `W_x * x_t` for all four gates runs once, with time
  folded into the batch (B·T), as one large conv;
- a Python loop over T then carries only the recurrent conv `W_h * h`
  (F → 4F) and the gate elementwise math.

Gate order along the 4F channels is (i, f, g, o). NCHW throughout:
x (B, T, C, H, W), state (c, h) each (B, F, H, W).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.models.darknet19 import conv


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
        wh = self.recurrent_kernel.to(self.dtype)
        pad = wh.shape[-1] // 2
        if initial_state is None:
            zeros = torch.zeros((b, f, h, w), dtype=self.dtype,
                                device=x.device)
            c_t, h_t = zeros, zeros
        else:
            c_t, h_t = (s.to(self.dtype) for s in initial_state)
        hs = []
        for step in range(t):
            gates = xp[:, step] + F.conv2d(h_t, wh, padding=pad)
            gi, gf, gg, go = gates.chunk(4, dim=1)
            gi = torch.sigmoid(gi)
            gf = torch.sigmoid(gf)
            go = torch.sigmoid(go)
            gg = torch.tanh(gg)
            c_t = gf * c_t + gi * gg
            h_t = go * torch.tanh(c_t)
            hs.append(h_t)
        ys = torch.stack(hs, dim=1)
        if return_state:
            return ys, (c_t, h_t)
        return ys
