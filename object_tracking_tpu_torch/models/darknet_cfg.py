"""Darknet `.cfg` → PyTorch model compiler.

Port of `object_tracking_tpu/models/darknet_cfg.py`: parse a darknet cfg,
build a torch module from it, ingest and export the matching `.weights`
stream in cfg order, decode its heads, and wrap it all in `CfgDetector`.

Supported sections (yolov2, yolov2-tiny, yolov3 and yolov4-style graphs):
  [net]            input geometry
  [convolutional]  conv (+optional BN) + leaky/linear/... activation
  [maxpool]        incl. the size-2/stride-1 tiny-yolo edge case
  [reorg]          space-to-depth (the YOLOv2 passthrough)
  [route]          concat of earlier layer outputs (negative or absolute)
  [shortcut]       residual add (yolov3)
  [upsample]       nearest-neighbour ×stride (yolov3)
  [region]         YOLOv2 head marker: anchors in grid-cell units
  [yolo]           YOLOv3/v4 head marker: masked anchors in input pixels

A [yolo] section's keys fall in three groups (`YOLO_KEYS`):
- honoured: `mask`, `anchors`, `classes`, `num` and `scale_x_y` (YOLOv4's
  grid sensitivity, x = (col + s·σ(tx) − (s − 1)/2) / GW, default 1);
- ignored, training only: `jitter`, `random`, `ignore_thresh`,
  `truth_thresh`, `iou_thresh`, `iou_loss`, `iou_normalizer`,
  `cls_normalizer`, `max_delta`;
- ignored, darknet's own NMS: `nms_kind`, `beta_nms`. The port keeps its
  own per-class greedy NMS over a top-K cap of the merged candidates.
Any other key (e.g. `new_coords`) may change what inference returns and
raises ValueError naming it.

Where a direct translation to torch goes wrong, this follows flax:
- 'SAME' padding of a conv or a pool pads lo = total // 2 and
  hi = total - lo, with total = max((ceil(n/s) - 1)·s + k - n, 0); a
  stride-2 conv on an even input pads (0, 1), not torch's k // 2 on both
  sides. Pools pad with -inf.
- `reorg` orders channels (di, dj, c), as tf.space_to_depth does.
- `shortcut` adds, then activates; BatchNorm eps is 1e-3.
- Heads and the final activation leave as float32, in the JAX layouts
  (B, GH, GW, A, 5+C) and (B, H, W, C).
Layer i's parameters are conv_i / norm_i, the flax names, so
`convert.from_flax` maps the loaded stream onto the module.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.config import LABELS_COCO
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.models.darknet19 import (
    BatchNorm, seeded, space_to_depth)
from object_tracking_tpu_torch.ops.cuda.mish import mish
from object_tracking_tpu_torch.ops.decode import (
    best_class, decode_netout, named_boxes)
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores
from object_tracking_tpu_torch.ops.weights import (
    DarknetWeightReader, write_darknet_header)
from object_tracking_tpu_torch.utils.frames import (
    read_frame, resolve_device, to_device)
from object_tracking_tpu_torch.utils.profiling import count, span


# --------------------------------------------------------------------------
# cfg parsing
# --------------------------------------------------------------------------
def parse_darknet_cfg(text: str) -> List[Dict[str, str]]:
    """Parse darknet's INI-like cfg into [{'type': ..., option: value}].

    Duplicate section names are positional (darknet semantics); comments
    start with '#' or ';'.
    """
    sections: List[Dict[str, str]] = []
    current: Optional[Dict[str, str]] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] in '#;':
            continue
        if line.startswith('['):
            current = {'type': line.strip('[] ').lower()}
            sections.append(current)
        elif '=' in line and current is not None:
            key, _, value = line.partition('=')
            current[key.strip()] = value.strip()
    return sections


def _ints(s: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in s.replace(' ', '').split(',') if v)


def _floats(s: str) -> Tuple[float, ...]:
    return tuple(float(v) for v in s.replace(' ', '').split(',') if v)


# A compiled layer plan, nested tuples:
#   ('conv', filters, size, stride, bn, activation)
#   ('maxpool', size, stride)
#   ('reorg', stride)
#   ('route', (idx, ...))            absolute layer indices
#   ('shortcut', idx, activation)
#   ('upsample', stride)
#   ('region', anchors, num, classes)     anchors: flat grid-cell units
#   ('yolo', anchors, classes, scale_x_y) anchors: (w, h) pixel pairs
LayerPlan = Tuple[Any, ...]

# [yolo] keys: honoured, or ignored because inference does not read them
YOLO_KEYS = {
    'honoured': ('mask', 'anchors', 'classes', 'num', 'scale_x_y'),
    'training': ('jitter', 'random', 'ignore_thresh', 'truth_thresh',
                 'iou_thresh', 'iou_loss', 'iou_normalizer',
                 'cls_normalizer', 'max_delta'),
    'nms': ('nms_kind', 'beta_nms'),
}
_YOLO_KNOWN = frozenset(k for keys in YOLO_KEYS.values() for k in keys)


def compile_cfg(sections: Sequence[Dict[str, str]]
                ) -> Tuple[Tuple[int, int, int], Tuple[LayerPlan, ...]]:
    """Resolve a parsed cfg into (input_hwc, layer plan tuple)."""
    if not sections or sections[0]['type'] not in ('net', 'network'):
        raise ValueError('cfg must start with [net]')
    net = sections[0]
    in_hwc = (int(net.get('height', 416)), int(net.get('width', 416)),
              int(net.get('channels', 3)))
    plan: List[LayerPlan] = []
    for i, sec in enumerate(sections[1:]):
        t = sec['type']
        if t == 'convolutional':
            plan.append((
                'conv', int(sec.get('filters', 1)),
                int(sec.get('size', 1)), int(sec.get('stride', 1)),
                int(sec.get('batch_normalize', 0)) == 1,
                sec.get('activation', 'linear')))
        elif t == 'maxpool':
            plan.append(('maxpool', int(sec.get('size', 2)),
                         int(sec.get('stride', 2))))
        elif t == 'reorg':
            plan.append(('reorg', int(sec.get('stride', 2))))
        elif t == 'route':
            refs = _ints(sec['layers'])
            plan.append(('route', tuple(
                r if r >= 0 else len(plan) + r for r in refs)))
        elif t == 'shortcut':
            r = int(sec['from'])
            plan.append(('shortcut',
                         r if r >= 0 else len(plan) + r,
                         sec.get('activation', 'linear')))
        elif t == 'upsample':
            plan.append(('upsample', int(sec.get('stride', 2))))
        elif t == 'region':
            plan.append(('region', _floats(sec.get('anchors', '')),
                         int(sec.get('num', 5)),
                         int(sec.get('classes', 20))))
        elif t == 'yolo':
            unknown = sorted(set(sec) - {'type'} - _YOLO_KNOWN)
            if unknown:
                raise ValueError(
                    f'[yolo] (index {i}): unsupported key(s) {unknown}; '
                    'they may change what inference returns')
            mask = _ints(sec.get('mask', ''))
            flat = _floats(sec.get('anchors', ''))
            pairs = tuple(zip(flat[::2], flat[1::2]))
            chosen = tuple(pairs[m] for m in mask) if mask else pairs
            plan.append(('yolo', chosen, int(sec.get('classes', 80)),
                         float(sec.get('scale_x_y', 1.0))))
        else:
            raise ValueError(f'unsupported cfg section [{t}] (index {i})')
    return in_hwc, tuple(plan)


def plan_shapes(plan: Sequence[LayerPlan], in_hwc: Tuple[int, int, int]
                ) -> List[Tuple[int, int, int]]:
    """(H, W, C) of every layer's output ('SAME' convs and pools give
    ceil(n / stride))."""
    h, w, c = in_hwc
    shapes: List[Tuple[int, int, int]] = []
    for layer in plan:
        kind = layer[0]
        if kind in ('conv', 'maxpool'):
            stride = layer[3] if kind == 'conv' else layer[2]
            h, w = -(-h // stride), -(-w // stride)
            if kind == 'conv':
                c = layer[1]
        elif kind == 'reorg':
            s = layer[1]
            h, w, c = h // s, w // s, c * s * s
        elif kind == 'route':
            refs = layer[1]
            h, w = shapes[refs[0]][:2]
            c = sum(shapes[r][2] for r in refs)
        elif kind == 'upsample':
            h, w = h * layer[1], w * layer[1]
        shapes.append((h, w, c))
    return shapes


def head_specs(plan: Sequence[LayerPlan]) -> Tuple[Dict[str, Any], ...]:
    """Metadata of each [region]/[yolo] head in plan order: {'kind',
    'anchors', 'num', 'num_classes'}, and for [yolo] 'scale_x_y'. Pairs
    with the same-order `heads` list returned by DarknetCfgNet.forward."""
    specs: List[Dict[str, Any]] = []
    for layer in plan:
        if layer[0] == 'region':
            _, anchors, num, classes = layer
            specs.append({'kind': 'region', 'anchors': anchors,
                          'num': num, 'num_classes': classes})
        elif layer[0] == 'yolo':
            _, anchors, classes, scale_x_y = layer
            specs.append({'kind': 'yolo', 'anchors': anchors,
                          'num': len(anchors), 'num_classes': classes,
                          'scale_x_y': scale_x_y})
    return tuple(specs)


# --------------------------------------------------------------------------
# the compiled network
# --------------------------------------------------------------------------
def _same_pads(n: int, size: int, stride: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding (lo, hi) of one spatial dim."""
    total = max((-(-n // stride) - 1) * stride + size - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, size: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x.shape[2], size, stride)
    left, right = _same_pads(x.shape[3], size, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == 'leaky':
        return F.leaky_relu(x, 0.1)
    if kind in ('linear', 'none'):
        return x
    if kind == 'relu':
        return F.relu(x)
    if kind in ('logistic', 'sigmoid'):
        return torch.sigmoid(x)
    if kind == 'mish':
        return mish(x)
    raise ValueError(f'unsupported activation {kind!r}')


class DarknetCfgNet(nn.Module):
    """A darknet cfg compiled to torch. Layer i's params are conv_i/norm_i.

    forward(images (B, H, W, C) in [0, 1]) returns {'heads': [raw
    (B, GH, GW, A, 5+C) netout per head], 'final': last activation
    (B, H', W', C')}, all float32. `dtype` is the activation type;
    parameters stay float32 and are cast at each conv. The per-head anchor
    and class metadata is `head_specs(self.plan)`. With a `mesh`
    (`parallel.mesh.Mesh`) every BatchNorm's statistics span its data
    group; the state_dict's names are the same.
    """

    def __init__(self, plan: Tuple[LayerPlan, ...],
                 in_hwc: Tuple[int, int, int],
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.plan = plan
        self.in_hwc = in_hwc
        self.dtype = dtype
        shapes = plan_shapes(plan, in_hwc)
        cin = in_hwc[2]
        for i, layer in enumerate(plan):
            if layer[0] == 'conv':
                _, filters, size, stride, bn, _ = layer
                self.add_module(f'conv_{i}', nn.Conv2d(
                    cin, filters, size, stride, bias=not bn))
                if bn:
                    self.add_module(f'norm_{i}', BatchNorm(
                        filters,
                        group=None if mesh is None else mesh.data_group))
            cin = shapes[i][2]

    def forward(self, images: torch.Tensor, train: bool = False):
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        outputs: List[torch.Tensor] = []
        heads: List[torch.Tensor] = []
        for i, layer in enumerate(self.plan):
            kind = layer[0]
            if kind == 'conv':
                _, _, size, stride, bn, act = layer
                conv = getattr(self, f'conv_{i}')
                bias = None if conv.bias is None else conv.bias.to(x.dtype)
                x = F.conv2d(_pad_same(x, size, stride),
                             conv.weight.to(x.dtype), bias, stride)
                if bn:
                    x = getattr(self, f'norm_{i}')(x, train)
                x = _activate(x, act)
            elif kind == 'maxpool':
                _, size, stride = layer
                x = F.max_pool2d(_pad_same(x, size, stride, -float('inf')),
                                 size, stride)
            elif kind == 'reorg':
                x = space_to_depth(x, layer[1])
            elif kind == 'route':
                refs = layer[1]
                x = outputs[refs[0]] if len(refs) == 1 else \
                    torch.cat([outputs[r] for r in refs], dim=1)
            elif kind == 'shortcut':
                _, ref, act = layer
                x = _activate(x + outputs[ref], act)
            elif kind == 'upsample':
                s = layer[1]
                x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            else:                                    # 'region' / 'yolo'
                num, classes = ((layer[2], layer[3]) if kind == 'region'
                                else (len(layer[1]), layer[2]))
                b, _, gh, gw = x.shape
                heads.append(x.float().permute(0, 2, 3, 1).reshape(
                    b, gh, gw, num, 5 + classes))
            outputs.append(x)
        return {'heads': heads, 'final': x.float().permute(0, 2, 3, 1)}


@torch.no_grad()
def head_grids(net: DarknetCfgNet, size: int, device) -> list:
    """Each head's (grid_h, grid_w) of a cfg net at input size², from one
    forward on a zero image (running statistics read, none written)."""
    was_training = net.training
    out = net.eval()(torch.zeros((1, size, size, 3), device=device))
    net.train(was_training)
    return [(int(h.shape[1]), int(h.shape[2])) for h in out['heads']]


class RegionNetout(nn.Module):
    """A one-[region]-head cfg net as a detector-step model:
    forward(images, train=False) → {'netout': its head's netout}."""

    def __init__(self, net: DarknetCfgNet):
        super().__init__()
        self.net = net

    def forward(self, images: torch.Tensor, train: bool = False):
        return {'netout': self.net(images, train=train)['heads'][0]}


def build_from_cfg(cfg_text: str, dtype: torch.dtype = torch.float32,
                   mesh=None
                   ) -> Tuple[DarknetCfgNet, Tuple[int, int, int]]:
    """cfg text → (torch module, (H, W, C) input geometry); `mesh` as
    DarknetCfgNet's."""
    in_hwc, plan = compile_cfg(parse_darknet_cfg(cfg_text))
    return DarknetCfgNet(plan, in_hwc, dtype, mesh), in_hwc


# --------------------------------------------------------------------------
# weight ingestion and export in cfg order
# --------------------------------------------------------------------------
def load_weights_for_cfg(path: str, cfg_text: str) -> Dict[str, Any]:
    """Read a darknet `.weights` stream following the cfg's conv order.

    Darknet serializes, per conv layer: [bias | bn(beta, gamma, mean,
    var)] then the OIHW kernel. Returns the flax layout {'params',
    'batch_stats'} keyed conv_i/norm_i (numpy, HWIO kernels); a stream
    longer than the plan raises.
    """
    in_hwc, plan = compile_cfg(parse_darknet_cfg(cfg_text))
    shapes = plan_shapes(plan, in_hwc)
    reader = DarknetWeightReader(path)
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for i, layer in enumerate(plan):
        if layer[0] != 'conv':
            continue
        _, filters, size, _, bn, _ = layer
        cin = shapes[i - 1][2] if i else in_hwc[2]
        if bn:
            beta = reader.read(filters)
            gamma = reader.read(filters)
            mean = reader.read(filters)
            var = reader.read(filters)
            params[f'norm_{i}'] = {'scale': gamma, 'bias': beta}
            batch_stats[f'norm_{i}'] = {'mean': mean, 'var': var}
        else:
            bias = reader.read(filters)
        kernel = reader.read(filters * cin * size * size).reshape(
            filters, cin, size, size).transpose(2, 3, 1, 0)
        entry: Dict[str, Any] = {'kernel': np.ascontiguousarray(kernel)}
        if not bn:
            entry['bias'] = bias
        params[f'conv_{i}'] = entry
    if reader.remaining:
        raise ValueError(
            f'{reader.remaining} floats left over after cfg plan — '
            'cfg/weights mismatch (or a header-version mismatch: darknet '
            'writes a 4- or 5-float header depending on its version; the '
            'reader sizes the skip from the (major, minor) header ints)')
    return {'params': params, 'batch_stats': batch_stats}


def export_weights_for_cfg(variables, cfg_text: str, path: str,
                           seen: int = 0) -> None:
    """Serialize cfg-net variables (flax layout, e.g. `convert.to_flax`
    of the module's state_dict) to a darknet `.weights` binary in cfg
    order — the exact inverse of `load_weights_for_cfg`, with the modern
    5-slot header."""
    _, plan = compile_cfg(parse_darknet_cfg(cfg_text))
    params = variables['params']
    stats = variables.get('batch_stats', {})
    with open(path, 'wb') as f:
        write_darknet_header(f, seen)
        for i, layer in enumerate(plan):
            if layer[0] != 'conv':
                continue
            if layer[4]:
                for arr in (params[f'norm_{i}']['bias'],
                            params[f'norm_{i}']['scale'],
                            stats[f'norm_{i}']['mean'],
                            stats[f'norm_{i}']['var']):
                    np.asarray(arr, np.float32).tofile(f)
            else:
                np.asarray(params[f'conv_{i}']['bias'],
                           np.float32).tofile(f)
            np.asarray(params[f'conv_{i}']['kernel'],
                       np.float32).transpose(3, 2, 0, 1).tofile(f)


# --------------------------------------------------------------------------
# head decoding
# --------------------------------------------------------------------------
def decode_yolo3_netout(netout: torch.Tensor, anchors,
                        net_size: Tuple[int, int],
                        obj_threshold: float = 0.5,
                        scale_x_y: float = 1.0):
    """YOLOv3 head decode: sigmoid xy + cell offset, pixel anchors scaled
    by the net input size, sigmoid (not softmax) class scores. YOLOv4's
    `scale_x_y` s stretches the offset about the cell's centre:
    x = (col + s·σ(tx) − (s − 1)/2) / GW, and likewise y (at s = 1,
    1·σ and a subtracted 0 are exact, so the boxes are v3's bit for bit).

    netout (..., GH, GW, A, 5+C) → (boxes (..., GH·GW·A, 4) center-format
    relative, scores (..., GH·GW·A, C) thresholded).
    """
    gh, gw, na = netout.shape[-4:-1]
    lead = netout.shape[:-4]
    dev = netout.device
    anchors = torch.as_tensor(np.asarray(anchors, np.float32),
                              device=dev).reshape(na, 2)
    conf = torch.sigmoid(netout[..., 4:5])
    probs = conf * torch.sigmoid(netout[..., 5:])
    probs = probs * (probs > obj_threshold)

    col = torch.arange(gw, dtype=torch.float32, device=dev)[None, :, None]
    row = torch.arange(gh, dtype=torch.float32, device=dev)[:, None, None]
    half = (scale_x_y - 1.0) / 2.0
    x = (col + scale_x_y * torch.sigmoid(netout[..., 0]) - half) / gw
    y = (row + scale_x_y * torch.sigmoid(netout[..., 1]) - half) / gh
    w = anchors[:, 0] * torch.exp(netout[..., 2]) / net_size[1]
    h = anchors[:, 1] * torch.exp(netout[..., 3]) / net_size[0]
    boxes = torch.stack([x, y, w, h], dim=-1).reshape(*lead, -1, 4)
    return boxes, probs.reshape(*lead, -1, probs.shape[-1])


def decode_cfg_outputs(heads: Sequence[torch.Tensor],
                       specs: Sequence[Dict[str, Any]],
                       net_size: Tuple[int, int],
                       obj_threshold: float = 0.5,
                       nms_threshold: float = 0.45,
                       top_k: int = 128):
    """Decode every head of a DarknetCfgNet forward, merge the
    multi-scale candidates, and run one NMS over the union.

    `heads` is the forward's list of raw (B, GH, GW, A, 5+C) netouts and
    `specs` the matching `head_specs(plan)`. Unlike the JAX function,
    which decodes batch element 0, every batch element is decoded, all in
    one NMS call. With a `Recorder` attached it counts the candidates
    whose best class score passes `obj_threshold` before the top-K cap
    (`detect.candidates`) and the frames in which the cap cut some
    (`detect.capped`).

    Returns (boxes (B, K, 4), labels (B, K), scores (B, K), valid (B, K)).
    """
    all_boxes, all_scores = [], []
    for netout, spec in zip(heads, specs):
        if spec['kind'] == 'region':
            b, s = decode_netout(netout, spec['anchors'], obj_threshold)
        else:
            b, s = decode_yolo3_netout(netout, spec['anchors'], net_size,
                                       obj_threshold, spec['scale_x_y'])
        all_boxes.append(b)
        all_scores.append(s)
    merged = torch.cat(all_scores, dim=-2)

    def passing():                  # per frame, candidates before the cap
        return (merged.amax(dim=-1) > obj_threshold).sum(dim=-1)
    count('detect.candidates', lambda: passing().sum())
    count('detect.capped', (lambda: (passing() > top_k).sum())
          if 0 < top_k < merged.shape[-2] else 0)
    boxes, scores = greedy_nms_scores(torch.cat(all_boxes, dim=-2), merged,
                                      nms_threshold, top_k)
    return (boxes, *best_class(scores, obj_threshold))


# --------------------------------------------------------------------------
# user-facing detector wrapper
# --------------------------------------------------------------------------
class CfgDetector:
    """YOLOv2Detector-parity wrapper around an arbitrary darknet cfg:
    compile the cfg to a torch module, optionally ingest the matching
    `.weights`, and expose `predict` / `detect` / `forward_batch` with
    decode and NMS on the detector's device ('cuda' unless the caller
    passes `device='cpu'`; a missing card raises). Works for yolov2,
    yolov2-tiny and yolov3-family cfgs. `detect_images` is the body of
    `detect` on arrays; only image paths and drawing need `cv2`. `mesh`
    spans the module's batch statistics over its data group, for
    data-parallel training.
    """

    def __init__(self, cfg: str, weights_path: Optional[str] = None,
                 labels: Optional[Sequence[str]] = None,
                 obj_threshold: float = 0.5, nms_threshold: float = 0.45,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 device='cuda', mesh=None):
        text = open(cfg).read() if os.path.exists(cfg) else cfg
        self.device = resolve_device(device)
        self.module, (h, w, _) = seeded(
            seed, lambda: build_from_cfg(text, dtype, mesh))
        self.specs = head_specs(self.module.plan)
        if not self.specs:
            raise ValueError('cfg has no [region]/[yolo] head')
        self.net_size = (h, w)
        self.obj_threshold = obj_threshold
        self.nms_threshold = nms_threshold
        n_cls = self.specs[0]['num_classes']
        if labels and len(labels) != n_cls:
            # the cfg's class count is authoritative (darknet reads it
            # from [region]/[yolo] too): fall back to positional names
            warnings.warn(
                f'{len(labels)} labels given but cfg declares {n_cls} '
                'classes; using positional class names', stacklevel=2)
            labels = None
        if labels:
            self.labels = tuple(labels)
        elif n_cls == 80:
            # an unnamed 80-class head is COCO in every darknet release
            self.labels = LABELS_COCO
        else:
            self.labels = tuple(f'class_{i}' for i in range(n_cls))
        if weights_path:
            self.module.load_state_dict(
                from_flax(load_weights_for_cfg(weights_path, text)),
                strict=True)
        self.module = self.module.to(self.device).eval()

    @torch.no_grad()
    def forward(self, images) -> Dict[str, Any]:
        """images (B, H, W, 3) in [0, 1] → {'heads': [...], 'final': ...}."""
        return self.module(to_device(images, self.device), train=False)

    def get_layer_dims(self, layer: str = 'final'
                       ) -> Tuple[int, int, int]:
        """Feature-volume dims (h, w, c) of the forward's `final`
        activation."""
        if layer != 'final':
            raise KeyError(layer)
        return plan_shapes(self.module.plan, self.module.in_hwc)[-1]

    def _decode(self, heads, top_k: int = 128):
        return decode_cfg_outputs(heads, self.specs, self.net_size,
                                  self.obj_threshold, self.nms_threshold,
                                  top_k)

    def forward_batch(self, images, layer: str = 'final',
                      top_k: int = 16):
        """Batched prior-source surface: images (N, H, W, 3) in [0, 1] →
        (feats (N, fh, fw, fc), boxes (N, K, 4) center-format normalized,
        labels (N, K), scores (N, K), valid (N, K)), tensors on the
        detector's device."""
        if layer != 'final':
            raise KeyError(layer)
        out = self.forward(images)
        return (out['final'],) + self._decode(out['heads'], top_k)

    @torch.no_grad()
    def detect_images(self, images) -> List[List[Tuple]]:
        """images (B, H, W, 3) in [0, 1] at the net size → per image
        [(label, score, (cx, cy, w, h))], image-relative, by score.

        The call is the span `detect` (`utils/profiling.py`), with
        `detect.h2d` (the images' copy in), `detect.forward`,
        `detect.decode_nms`, `detect.fetch` (the copies out, which wait
        for the device's queued work) and `detect.results` inside."""
        with span('detect'):
            with span('detect.h2d'):
                x = to_device(images, self.device)
            with span('detect.forward'):
                heads = self.module(x, train=False)['heads']
            with span('detect.decode_nms'):
                dets = self._decode(heads)
            with span('detect.fetch'):
                dets = [a.cpu().numpy() for a in dets]
            with span('detect.results'):
                return named_boxes(dets, self.labels)

    def detect(self, input_path: str):
        """Image path → [(label, score, (cx, cy, w, h))], image-relative."""
        _, x = read_frame(input_path, self.net_size)
        return self.detect_images(x[None])[0]

    def predict(self, input_path: str, output_path: Optional[str] = None):
        """detect + optional box overlay."""
        dets = self.detect(input_path)
        if output_path:
            import cv2
            img = cv2.imread(input_path)
            ih, iw = img.shape[:2]
            for label, score, (cx, cy, bw, bh) in dets:
                if not all(np.isfinite(v) for v in (cx, cy, bw, bh)):
                    continue    # garbage box (e.g. exp-decode overflow)
                # clamp to the frame: int() of a huge float overflows
                x0 = int(np.clip((cx - bw / 2) * iw, 0, iw - 1))
                y0 = int(np.clip((cy - bh / 2) * ih, 0, ih - 1))
                x1 = int(np.clip((cx + bw / 2) * iw, 0, iw - 1))
                y1 = int(np.clip((cy + bh / 2) * ih, 0, ih - 1))
                cv2.rectangle(img, (x0, y0), (x1, y1), (0, 255, 0), 2)
                cv2.putText(img, f'{label} {score:.2f}',
                            (x0, max(y0 - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
            cv2.imwrite(output_path, img)
        return dets
