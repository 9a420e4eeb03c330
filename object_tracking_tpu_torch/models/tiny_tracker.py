"""Single-object trackers: TinyTracker (bbox head) and its heatmap variant.

Port of `object_tracking_tpu/models/tiny_tracker.py`:

- per-frame pooling of the frozen detector's feature volume: 'Global'
  (max over H, W) or 'Max' (4x4/4 max-pool, flattened in NHWC order,
  (h, w, c), as the JAX module flattens its NHWC map);
- concat with the per-frame detection input (a bbox vector or a flattened
  heatmap);
- an LSTM over the T frames from a zero carry, with flax
  `OptimizedLSTMCell`'s gates (i, f, g, o) and its one bias;
- per frame a dense output with a sigmoid, or, with `residual_det`, the
  presence-gated correction of the detection input.

`out_dim=4` is TinyTracker, `out_dim=heatmap_size²` TinyHeatmapTracker.
Features and detections come in as (B, T, H, W, C) and (B, T, D); the
outputs are float32. `dtype` is the compute type; parameters stay float32
and are cast where they are used.

The LSTM is a loop over T of one matmul and the gate arithmetic, as
`FusedConvLSTM`'s, not `nn.LSTM`: that has two biases per gate, and Adam
would step both by the same amount, twice the step of flax's one bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer` in x's dtype (the float32 parameters cast)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LSTM(nn.Module):
    """flax `OptimizedLSTMCell` scanned over time (`nn.RNN`), batch first.

    weight_ih (4H, in) and weight_hh (4H, H) stack the gates (i, f, g, o)
    along their rows (flax's per-gate kernels (in, H) and (H, H),
    transposed); `bias` (4H) is the recurrent projections' bias, the only
    one flax has.
    """

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                  hidden_size))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))
        self.reset_recurrent_parameters()

    @torch.no_grad()
    def reset_recurrent_parameters(self) -> None:
        """flax's initialisers: lecun_normal input kernels, an orthogonal
        recurrent kernel per gate, zero biases."""
        from object_tracking_tpu_torch.models.darknet19 import lecun_normal_
        lecun_normal_(self.weight_ih, self.weight_ih.shape[1])
        for gate in self.weight_hh.chunk(4, dim=0):
            nn.init.orthogonal_(gate)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, in) → every hidden state (B, T, H), in x's dtype."""
        b, t, _ = x.shape
        wh = self.weight_hh.to(x.dtype).t()
        xp = F.linear(x, self.weight_ih.to(x.dtype), self.bias.to(x.dtype))
        h_t = torch.zeros((b, self.hidden_size), dtype=x.dtype,
                          device=x.device)
        c_t = h_t
        hs = []
        for step in range(t):
            gates = torch.addmm(xp[:, step], h_t, wh)
            gi, gf, gg, go = gates.chunk(4, dim=1)
            c_t = torch.sigmoid(gf) * c_t + torch.sigmoid(gi) * torch.tanh(gg)
            h_t = torch.sigmoid(go) * torch.tanh(c_t)
            hs.append(h_t)
        return torch.stack(hs, dim=1)


class TinyTracker(nn.Module):
    """feat_shape: the prior source's (H, W, C) feature volume; the input
    of the LSTM is the pooled feature and the out_dim-wide detection."""

    def __init__(self, feat_shape, lstm_units: int = 512, out_dim: int = 4,
                 pool: str = 'Global', dtype: torch.dtype = torch.float32,
                 residual_det: bool = False):
        super().__init__()
        if pool not in ('Global', 'Max'):
            raise ValueError(f'unknown pool mode {pool!r}')
        fh, fw, fc = feat_shape
        pooled = fc if pool == 'Global' else (fh // 4) * (fw // 4) * fc
        self.pool = pool
        self.out_dim = out_dim
        self.dtype = dtype
        self.residual_det = residual_det
        self.lstm = LSTM(pooled + out_dim, lstm_units)
        self.output = nn.Linear(lstm_units, out_dim)
        if residual_det:
            self.fill = nn.Linear(lstm_units, out_dim)
        self.reset_recurrent_parameters()

    @torch.no_grad()
    def reset_recurrent_parameters(self) -> None:
        """The residual head's correction starts at zero, so that the model
        is the detection echo at init (flax's zeros initialisers)."""
        if self.residual_det:
            self.output.weight.zero_()
            self.output.bias.zero_()

    def forward(self, feats: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
        """feats (B, T, H, W, C), det (B, T, D) → (B, T, out_dim) float32."""
        b, t = feats.shape[:2]
        x = feats.to(self.dtype)
        if self.pool == 'Max':
            x = x.reshape((b * t,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
            x = F.max_pool2d(x, 4, 4).permute(0, 2, 3, 1).reshape(b, t, -1)
        else:
            x = x.amax(dim=(2, 3))
        hidden = self.lstm(torch.cat([x, det.to(self.dtype)], dim=-1))
        if not self.residual_det:
            return torch.sigmoid(_linear(hidden, self.output)).float()
        # Presence gate: a missed detection is exactly all-zero float32
        # (the batch generator's contract), so the gate reads `det` as it
        # came, never the compute-type copy: present frames get det +
        # tanh(correction), missed frames the fill-in head.
        det = det.float()
        present = det.abs().sum(dim=-1, keepdim=True) > 0
        corr = det + torch.tanh(_linear(hidden, self.output)).float()
        fill = torch.sigmoid(_linear(hidden, self.fill)).float()
        return torch.where(present, corr, fill)
