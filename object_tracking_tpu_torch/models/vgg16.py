"""VGG16 prior source: visual features and per-class NMS'd detections.

Port of `object_tracking_tpu/models/vgg16.py`: a VGG16 backbone whose
outputs are 'conv5_3', 'pool5' and a global 'fc7' vector, plus, when
`det_classes > 0`, a dense detection head — one 1x1 conv over pool5
emitting a single-anchor region netout (B, GH, GW, 1, 5+C), decoded and
per-class NMS'd by `ops/decode.decode_and_nms` (on the card: one launch
of the NMS kernel per call).

- fc6 is a 7x7 'SAME' conv over pool5 and fc7 a 1x1 conv, then a global
  average over the map, so any input size works;
- images come in as (B, H, W, 3) and features leave in the JAX layouts
  (NHWC, float32);
- weights load from {'layer/leaf': array} with HWIO kernels (an `.npz`,
  or `ops/caffemodel.py`'s mapping of a `.caffemodel`);
- `VGG16PriorSource.det_apply` is the dense head as a model of the
  standalone detector step (`training/steps.py::make_detector_train_step`
  with anchors `VGG_DET_ANCHOR`): `det_apply(images, train)` →
  {'netout': det_netout}, sharing the source's parameters. VGG16 has no
  BatchNorm, so `train` changes nothing, and the data-parallel step needs
  nothing of it beyond the step's own group (the loss and the gradients).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.models.darknet19 import conv, seeded
from object_tracking_tpu_torch.ops.decode import decode_and_nms, named_boxes
from object_tracking_tpu_torch.utils.frames import (
    read_frame, resolve_device, to_device)

# (name, features) per conv layer; pools after each block.
_VGG_PLAN: Tuple[Tuple[str, int], ...] = (
    ('conv1_1', 64), ('conv1_2', 64),
    ('conv2_1', 128), ('conv2_2', 128),
    ('conv3_1', 256), ('conv3_2', 256), ('conv3_3', 256),
    ('conv4_1', 512), ('conv4_2', 512), ('conv4_3', 512),
    ('conv5_1', 512), ('conv5_2', 512), ('conv5_3', 512),
)
_BLOCK_ENDS = frozenset(('conv1_2', 'conv2_2', 'conv3_3', 'conv4_3'))

# Single implicit anchor (grid-cell units) for the dense detection head.
VGG_DET_ANCHOR = (2.0, 2.0)


def add_vgg_convs(module: nn.Module, width_div: int = 1) -> int:
    """Add the 13 3x3 conv layers of `_VGG_PLAN` to `module` under their
    names, each width divided by `width_div` (floor 4 channels); returns
    conv5_3's width."""
    cin = 3
    for name, feats in _VGG_PLAN:
        width = max(feats // width_div, 4)
        module.add_module(name, nn.Conv2d(cin, width, 3))
        cin = width
    return cin


def vgg_trunk(module: nn.Module, x: torch.Tensor,
              ceil_mode: bool = False) -> torch.Tensor:
    """`module`'s 13 VGG convs with ReLU over x (B, 3, H, W), a 2x2
    stride-2 max pool after each of the first four blocks → conv5_3. With
    `ceil_mode` the pools keep a last odd row and column (Caffe's pooling:
    562 → 281 → 141 → 71 → 36)."""
    for name, _ in _VGG_PLAN:
        x = F.relu(conv(x, getattr(module, name)))
        if name in _BLOCK_ENDS:
            x = F.max_pool2d(x, 2, 2, ceil_mode=ceil_mode)
    return x


class VGG16(nn.Module):
    """VGG16 backbone: conv5_3, pool5 and a global fc7 vector, and the
    dense detection head when `det_classes > 0`. `width_div` divides
    every conv width (floor 4 channels); `dtype` is the activation type
    (parameters stay float32)."""

    def __init__(self, fc_features: int = 4096, det_classes: int = 0,
                 dtype: torch.dtype = torch.float32, width_div: int = 1):
        super().__init__()
        self.fc_features = fc_features
        self.det_classes = det_classes
        self.dtype = dtype
        self.width_div = width_div
        cin = add_vgg_convs(self, width_div)
        self.fc6 = nn.Conv2d(cin, fc_features, 7)
        self.fc7 = nn.Conv2d(fc_features, fc_features, 1)
        if det_classes:
            self.det_head = nn.Conv2d(cin, 5 + det_classes, 1)

    def _convs(self, images: torch.Tensor):
        """images (B, H, W, 3) → (conv5_3, pool5), NCHW in the compute
        type."""
        x = vgg_trunk(self, images.permute(0, 3, 1, 2).to(self.dtype))
        return x, F.max_pool2d(x, 2, 2)

    def _det_netout(self, pool5: torch.Tensor) -> torch.Tensor:
        det = conv(pool5, self.det_head).float()
        b, _, gh, gw = det.shape
        return det.permute(0, 2, 3, 1).reshape(b, gh, gw, 1,
                                               5 + self.det_classes)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) in [0, 1] →
        {'conv5_3': (B,H/16,W/16,512), 'pool5': (B,H/32,W/32,512),
         'fc7': (B, fc_features)[, 'det_netout': (B,GH,GW,1,5+C)]}."""
        x, pool5 = self._convs(images)
        y = F.relu(conv(pool5, self.fc6))
        y = F.relu(conv(y, self.fc7))
        out = {'conv5_3': x.float().permute(0, 2, 3, 1),
               'pool5': pool5.float().permute(0, 2, 3, 1),
               'fc7': y.mean(dim=(2, 3)).float()}
        if self.det_classes:
            out['det_netout'] = self._det_netout(pool5)
        return out

    def detection_netout(self, images: torch.Tensor) -> torch.Tensor:
        """Only the dense head's netout (B, GH, GW, 1, 5+C): the layers
        that feed it, without fc6 and fc7."""
        return self._det_netout(self._convs(images)[1])


class DetApply(nn.Module):
    """The dense detection head of a `VGG16` as a detector-step model:
    forward(images, train=False) → {'netout': det_netout}."""

    def __init__(self, vgg: VGG16):
        super().__init__()
        if not vgg.det_classes:
            raise ValueError('the VGG16 has no detection head '
                             '(det_classes=0)')
        self.vgg = vgg

    def forward(self, images: torch.Tensor, train: bool = False):
        return {'netout': self.vgg.detection_netout(images)}


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class VGG16PriorSource:
    """Frozen VGG16 features + detections, implementing the prior-source
    protocol (`get_layer_dims`, `forward_batch`, `extract_spatio_info`).

    Detections come from the model's OWN dense head when `det_labels` is
    given (thresholds default to CONF 0.8 / NMS 0.3), or from
    `detection_delegate` (any other prior source) otherwise. Runs on
    `device` ('cuda' unless the caller passes 'cpu'; a missing card
    raises); results come back as numpy arrays.
    """

    def __init__(self, image_h: int = 416, image_w: int = 416,
                 detection_delegate=None, weights_path: Optional[str] = None,
                 det_labels: Optional[Sequence[str]] = None,
                 conf_threshold: float = 0.8, nms_threshold: float = 0.3,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 fc_features: int = 4096, width_div: int = 1,
                 device='cuda'):
        self.image_h, self.image_w = image_h, image_w
        self.det_labels = tuple(det_labels) if det_labels else ()
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.device = resolve_device(device)
        self.module = seeded(seed, lambda: VGG16(
            fc_features, len(self.det_labels), dtype, width_div))
        self.module = self.module.to(self.device).eval()
        self.anchor = torch.tensor(VGG_DET_ANCHOR, device=self.device)
        if weights_path:
            self.load_npz_weights(weights_path)
        self.delegate = detection_delegate

    @property
    def det_apply(self) -> DetApply:
        """The dense head as a trainable model (see the module
        docstring); its parameters are this source's."""
        return DetApply(self.module)

    def load_params(self, named: Dict[str, np.ndarray]) -> None:
        """Load {'layer/leaf': array} ('conv1_1/kernel' HWIO, 'fc6/bias',
        ...). Every named layer must exist, with the same shape."""
        tree: Dict[str, Dict[str, np.ndarray]] = {}
        for key, arr in named.items():
            name, leaf = key.split('/')
            tree.setdefault(name, {})[leaf] = np.asarray(arr)
        state = from_flax({'params': tree})
        own = self.module.state_dict()
        for key, value in state.items():
            if key not in own:
                raise KeyError(f'model has no parameter {key!r}')
            if value.shape != own[key].shape:
                raise ValueError(f'{key}: shape {tuple(value.shape)} != '
                                 f'model {tuple(own[key].shape)} '
                                 '(width_div mismatch?)')
        self.module.load_state_dict(state, strict=False)

    def load_npz_weights(self, path: str) -> None:
        """Load named arrays (e.g. 'conv1_1/kernel' HWIO, 'fc6/bias')."""
        data = np.load(path)
        self.load_params({key: data[key] for key in data.files})

    def get_layer_dims(self, layer: str = 'fc7') -> Tuple[int, int, int]:
        c5 = max(512 // self.module.width_div, 4)
        if layer == 'conv5_3':
            return self.image_h // 16, self.image_w // 16, c5
        if layer == 'pool5':
            return self.image_h // 32, self.image_w // 32, c5
        if layer == 'fc7':
            # the fc feature is a 1x1 spatial volume
            return 1, 1, self.module.fc_features
        raise KeyError(layer)

    @torch.no_grad()
    def forward(self, images) -> Dict[str, torch.Tensor]:
        return self.module(to_device(images, self.device))

    @staticmethod
    def _layer(out: Dict[str, torch.Tensor], layer: str) -> np.ndarray:
        feats = out[layer]
        if layer == 'fc7':
            feats = feats[:, None, None, :]
        return feats.cpu().numpy()

    def _own_detections(self, out: Dict[str, torch.Tensor], top_k: int):
        """Dense-head decode + per-class NMS of a forward's batch."""
        dec = decode_and_nms(out['det_netout'], self.anchor,
                             obj_threshold=self.conf_threshold,
                             nms_threshold=self.nms_threshold, top_k=top_k)
        return tuple(_numpy(a) for a in dec)

    def forward_batch(self, images, layer: str = 'fc7', top_k: int = 16):
        """(feats, boxes, labels, scores, valid) — features from VGG16,
        boxes from the model's own head (when det_labels set), else the
        delegate, else zero/invalid boxes. One forward."""
        if layer not in ('conv5_3', 'pool5', 'fc7'):
            raise KeyError(layer)
        out = self.forward(images)
        feats = self._layer(out, layer)
        n = feats.shape[0]
        if self.det_labels:
            boxes, labels, scores, valid = self._own_detections(out, top_k)
        elif self.delegate is not None:
            _, boxes, labels, scores, valid = (
                _numpy(a) for a in self.delegate.forward_batch(
                    images, top_k=top_k))
        else:
            boxes = np.zeros((n, top_k, 4), np.float32)
            labels = np.zeros((n, top_k), np.int32)
            scores = np.zeros((n, top_k), np.float32)
            valid = np.zeros((n, top_k), bool)
        return feats, boxes, labels, scores, valid

    def detect_images(self, images) -> List[List[Tuple]]:
        """The own head's detections of images (B, H, W, 3) in [0, 1] at
        the source's input size: per image [(label, score, (cx, cy, w,
        h))], by score — the body of `detect` on arrays."""
        return named_boxes(self._own_detections(self.forward(images), 16),
                           [l.lower() for l in self.det_labels])

    def detect(self, file_path: str,
               class_filter: Optional[Sequence[str]] = None):
        """Image path → [(label, score, (cx, cy, w, h))] sorted by score,
        from the model's own per-class NMS'd head."""
        named, _ = self.extract_spatio_info(file_path,
                                            class_filter=class_filter)
        return named

    def extract_spatio_info(self, file_path: str, layer: str = 'fc7',
                            class_filter: Optional[Sequence[str]] = None):
        """Detections + feature volume for one image file, both from one
        forward when the detection head is enabled."""
        _, x = read_frame(file_path, (self.image_h, self.image_w))
        out = self.forward(x[None])
        feats = self._layer(out, layer)[0]
        named = []
        if self.det_labels:
            named = named_boxes(self._own_detections(out, 16),
                                [l.lower() for l in self.det_labels])[0]
        elif self.delegate is not None and hasattr(self.delegate,
                                                   'extract_spatio_info'):
            named, _ = self.delegate.extract_spatio_info(
                file_path, class_filter=class_filter)
            class_filter = None
        if class_filter is not None:
            allowed = {c.lower() for c in class_filter}
            named = [d for d in named if d[0] in allowed]
        return named, feats
