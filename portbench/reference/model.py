"""Plain float32 reference of the two models the benchmark runs.

Functional forward passes over a dict of named weights, in plain torch
ops, written from the published architectures: Darknet-19 with YOLOv2's
passthrough (Redmon & Farhadi 2017; darknet's cfg/yolov2.cfg) and the
joint detect+track model of ktzsh/object-tracking (MultiObjDetTracker.py:
a ConvLSTM over concat(netout, conv_feat) and a 1x1 track head). It
imports nothing of the program under test.

- Activations NCHW inside; images come in as (N, H, W, 3) in [0, 1] and
  heads leave as (..., GH, GW, A, 5+C), the program's public layouts.
- BatchNorm normalises with the batch's mean and its biased variance,
  taken in two passes (mean((x - mean)²)), epsilon 1e-3.
- The passthrough is TensorFlow's space_to_depth: output channel
  (di·2 + dj)·C + c takes input channel c at offset (di, dj).
- ConvLSTM gates are ordered (i, f, g, o) along 4F channels; the state is
  (c, h), carried channels last, (B, GH, GW, F), as the program carries it.

The weight names are the program's state-dict keys: they are the format
of the weights file that the benchmark writes and both sides read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# (index, output channels, kernel) of Darknet-19's convolutions 1-20,
# max-pools after 1, 2, 5, 8 and 13; then conv 21 (1x1, 64) on the conv-13
# tap, the passthrough, conv 22 (3x3, 1024) on concat(passthrough, x) and
# the 1x1 head conv 23 with a bias
PLAN = ((1, 32, 3), (2, 64, 3), (3, 128, 3), (4, 64, 1), (5, 128, 3),
        (6, 256, 3), (7, 128, 1), (8, 256, 3), (9, 512, 3), (10, 256, 1),
        (11, 512, 3), (12, 256, 1), (13, 512, 3), (14, 1024, 3),
        (15, 512, 1), (16, 1024, 3), (17, 512, 1), (18, 1024, 3),
        (19, 1024, 3), (20, 1024, 3))
POOL_AFTER = frozenset((1, 2, 5, 8, 13))
BN_EPS = 1e-3
LEAKY = 0.1

Weights = Dict[str, torch.Tensor]


def _width(features: int, width_div: int) -> int:
    return max(features // width_div, 4)


def darknet_convs(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(index, input channels, output channels, kernel) of convs 1-22."""
    div = cfg.get('width_div', 1)
    out, c_in = [], 3
    for idx, features, kernel in PLAN:
        out.append((idx, c_in, _width(features, div), kernel))
        c_in = _width(features, div)
    out.append((21, _width(512, div), _width(64, div), 1))
    out.append((22, 4 * _width(64, div) + c_in, _width(1024, div), 3))
    return out


def head_channels(cfg: dict) -> int:
    return cfg['num_anchors'] * (5 + cfg['num_classes'])


def feat_channels(cfg: dict) -> int:
    return _width(1024, cfg.get('width_div', 1))


def darknet_spec(cfg: dict, prefix: str) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) of every tensor of Darknet-19 and its
    head, named under `prefix`: init is 'normal' (a seeded normal over
    sqrt(fan_in)), 'ones', 'zeros' or 'forget' (a ConvLSTM bias: 1 on the
    forget gate's F channels, 0 elsewhere)."""
    spec = []
    for idx, c_in, c_out, k in darknet_convs(cfg):
        spec.append((f'{prefix}conv_{idx}.weight', (c_out, c_in, k, k),
                     'normal', c_in * k * k))
        for leaf, init in (('weight', 'ones'), ('bias', 'zeros'),
                           ('running_mean', 'zeros'),
                           ('running_var', 'ones')):
            spec.append((f'{prefix}norm_{idx}.{leaf}', (c_out,), init, 0))
    heads, feats = head_channels(cfg), feat_channels(cfg)
    spec.append((f'{prefix}conv_23.weight', (heads, feats, 1, 1), 'normal',
                 feats))
    spec.append((f'{prefix}conv_23.bias', (heads,), 'zeros', 0))
    return spec


def convlstm_spec(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """The joint model's ConvLSTM over concat(netout, features) and its
    1x1 track head, in `darknet_spec`'s form."""
    heads, f = head_channels(cfg), cfg['convlstm_features']
    c_in = heads + feat_channels(cfg)
    return [('tconv_lstm.input_proj.weight', (4 * f, c_in, 3, 3), 'normal',
             c_in * 9),
            ('tconv_lstm.input_proj.bias', (4 * f,), 'forget', f),
            ('tconv_lstm.recurrent_kernel', (4 * f, f, 3, 3), 'normal',
             f * 9),
            ('tconv_2.weight', (heads, f, 1, 1), 'normal', f),
            ('tconv_2.bias', (heads,), 'zeros', 0)]


def parameter_names(spec: List[Tuple[str, tuple, str, int]]) -> List[str]:
    """The trained leaves of a weight spec: every tensor but the
    BatchNorm running statistics."""
    return [name for name, *_ in spec
            if not name.endswith(('running_mean', 'running_var'))]


def batch_norm(x: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(0, 2, 3), keepdim=True)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * scale[:, None, None]
            + shift[:, None, None])


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def darknet(w: Weights, images: torch.Tensor, prefix: str = ''):
    """images (N, H, W, 3) → (head (N, A·(5+C), H/32, W/32), features
    (N, 1024, H/32, W/32)), batch statistics throughout."""
    def block(x, idx):
        k = w[f'{prefix}conv_{idx}.weight']
        x = F.conv2d(x, k, padding=k.shape[-1] // 2)
        x = batch_norm(x, w[f'{prefix}norm_{idx}.weight'],
                       w[f'{prefix}norm_{idx}.bias'])
        return F.leaky_relu(x, LEAKY)

    x = images.permute(0, 3, 1, 2)
    tap = None
    for idx, _, _ in PLAN:
        x = block(x, idx)
        if idx == 13:
            tap = x
        if idx in POOL_AFTER:
            x = F.max_pool2d(x, 2)
    x = block(torch.cat([space_to_depth(block(tap, 21)), x], dim=1), 22)
    head = F.conv2d(x, w[f'{prefix}conv_23.weight'],
                    w[f'{prefix}conv_23.bias'])
    return head, x


def to_grid(head: torch.Tensor, cfg: dict, lead: tuple) -> torch.Tensor:
    """(N, A·(5+C), GH, GW) → lead + (GH, GW, A, 5+C)."""
    n, _, gh, gw = head.shape
    return head.permute(0, 2, 3, 1).reshape(
        lead + (gh, gw, cfg['num_anchors'], 5 + cfg['num_classes']))


def convlstm(w: Weights, z: torch.Tensor, state=None):
    """z (B, T, C, GH, GW), state (c, h) each (B, GH, GW, F) or None →
    (hidden states (B, T, F, GH, GW), final (c, h) channels last)."""
    b, t, c, gh, gw = z.shape
    wx = w['tconv_lstm.input_proj.weight']
    wh = w['tconv_lstm.recurrent_kernel']
    f = wh.shape[1]
    xp = F.conv2d(z.reshape(b * t, c, gh, gw), wx,
                  w['tconv_lstm.input_proj.bias'], padding=1)
    xp = xp.reshape(b, t, 4 * f, gh, gw)
    if state is None:
        cell = torch.zeros((b, f, gh, gw), dtype=z.dtype, device=z.device)
        hid = cell
    else:
        cell, hid = (s.permute(0, 3, 1, 2) for s in state)
    out = []
    for step in range(t):
        g = xp[:, step] + F.conv2d(hid, wh, padding=1)
        gi, gf, gg, go = g.split(f, dim=1)
        cell = torch.sigmoid(gf) * cell + torch.sigmoid(gi) * torch.tanh(gg)
        hid = torch.sigmoid(go) * torch.tanh(cell)
        out.append(hid)
    final = (cell.permute(0, 2, 3, 1), hid.permute(0, 2, 3, 1))
    return torch.stack(out, dim=1), final


def joint_forward(w: Weights, cfg: dict, images: torch.Tensor,
                  state: Optional[tuple] = None) -> dict:
    """images (B, T, H, W, 3) in [0, 1] → {'detect', 'track' (B, T, GH,
    GW, A, 5+C), 'state' (c, h)}: Darknet-19 over the B·T frames with
    batch statistics over all of them, the ConvLSTM from `state` (zeros
    when None) and the 1x1 track head."""
    b, t = images.shape[:2]
    head, feat = darknet(w, images.reshape((b * t,) + images.shape[2:]),
                         'detector.')
    z = torch.cat([head, feat], dim=1)
    hs, final = convlstm(w, z.reshape((b, t) + z.shape[1:]), state)
    track = F.conv2d(hs.reshape((b * t,) + hs.shape[2:]), w['tconv_2.weight'],
                     w['tconv_2.bias'])
    return {'detect': to_grid(head, cfg, (b, t)),
            'track': to_grid(track, cfg, (b, t)), 'state': final}


def detector_forward(w: Weights, cfg: dict, images: torch.Tensor) -> dict:
    """images (N, H, W, 3) in [0, 1] → {'netout' (N, GH, GW, A, 5+C)}."""
    head, _ = darknet(w, images)
    return {'netout': to_grid(head, cfg, (images.shape[0],))}
