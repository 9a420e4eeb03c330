"""Faster R-CNN with VGG16 (Ren, He, Girshick and Sun, arXiv 1506.01497),
as py-faster-rcnn serves it: the detector that the system this package
ports ran itself (`models_detection/FasterRCNN.py`, 21 PASCAL VOC classes).

The JAX package has no two-stage detector; this module is the port's own,
built from py-faster-rcnn's VGG16 test net (`test.prototxt`) and its test
settings (`lib/fast_rcnn/config.py`, `tools/test_net.py`):

- input: frames (B, H, W, 3) RGB in [0, 1], as the other detectors take
  them; on the device ×255, BGR, minus `PIXEL_MEANS_BGR`;
- trunk: VGG16's conv1_1 … conv5_3 (`models/vgg16.py::vgg_trunk`) with
  Caffe's ceil-mode pools (562×1000 → 36×63);
- RPN: rpn_conv/3x3 (here `rpn_conv`) with ReLU, `rpn_cls_score` (2A)
  and `rpn_bbox_pred` (4A); channel a pairs with a + A in the softmax
  (Caffe's reshape to (2, A·H, W)); scores and deltas in (h, w, a) order;
- proposals (`ops/proposals.py::propose`): every image's own, in one
  pass for the batch, the NMS on kernel 1;
- RoI pooling: `ops/cuda/roi_pool.py` (the custom op
  `ott_torch::roi_pool`) over conv5_3 at 1/16 into 7x7;
- head: fc6 (25,088 → 4,096), fc7 (4,096 → 4,096), each with ReLU
  (dropout is the identity at test), `cls_score` → softmax, `bbox_pred`;
- detections (`ops/proposals.py::class_detections`): class-specific
  boxes, the score threshold, per-class NMS on kernel 1, the image's best
  `max_per_image`.

`FasterRCNN.forward(images)` returns the stages' outputs; its spans
(`utils/profiling.py`) are `detect.proposals`, `detect.roi_pool` and
`detect.box_head`, inside the detector's `detect.forward`.
`FasterRCNNDetector.detect_images(frames)` is the serving entry: the
frames' way in and the detections' way out are the other detectors'
(`utils/frames.py::to_device`, `ops/decode.py::named_boxes`), and the call
is the span `detect` ⊃ `detect.h2d`, `.forward`, `.decode_nms`, `.fetch`,
`.results`. Nothing synchronises with the host before `detect.fetch`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.models.darknet19 import conv, seeded
from object_tracking_tpu_torch.models.vgg16 import add_vgg_convs, vgg_trunk
from object_tracking_tpu_torch.ops.cuda.roi_pool import roi_pool
from object_tracking_tpu_torch.ops.decode import named_boxes
from object_tracking_tpu_torch.ops.proposals import (
    class_detections, generate_anchors, propose, shifted_anchors)
from object_tracking_tpu_torch.utils.frames import resolve_device, to_device
from object_tracking_tpu_torch.utils.profiling import span

VOC_CLASSES = ('__background__', 'aeroplane', 'bicycle', 'bird', 'boat',
               'bottle', 'bus', 'car', 'cat', 'chair', 'cow', 'diningtable',
               'dog', 'horse', 'motorbike', 'person', 'pottedplant', 'sheep',
               'sofa', 'train', 'tvmonitor')
PIXEL_MEANS_BGR = (102.9801, 115.9465, 122.7717)
FEAT_STRIDE = 16        # conv5_3's cell in image pixels
POOLED = 7              # RoI pooling's bins a side
HIDDEN = 4096           # fc6 and fc7


@dataclasses.dataclass(frozen=True)
class RCNNSettings:
    """py-faster-rcnn's test settings. `scale` is the image's resize from
    its camera frame (`im_info[2]`: 1000/1920 for a 1920x1080 frame served
    at 562x1000), which multiplies `rpn_min_size`."""
    scale: float = 1000.0 / 1920.0
    pre_nms_top_n: int = 6000
    post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 16.0
    score_thresh: float = 0.05
    nms_thresh: float = 0.3
    max_per_image: int = 100


class FasterRCNN(nn.Module):
    """VGG16 Faster R-CNN at test time (module docstring), float32.
    Parameters are named as py-faster-rcnn's layers (`rpn_conv` for
    `rpn_conv/3x3`)."""

    def __init__(self, num_classes: int = len(VOC_CLASSES),
                 settings: RCNNSettings = RCNNSettings()):
        super().__init__()
        self.settings = settings
        self.num_classes = num_classes
        self.base_anchors = generate_anchors(FEAT_STRIDE)
        a = len(self.base_anchors)
        c5 = add_vgg_convs(self)
        self.rpn_conv = nn.Conv2d(c5, 512, 3)
        self.rpn_cls_score = nn.Conv2d(512, 2 * a, 1)
        self.rpn_bbox_pred = nn.Conv2d(512, 4 * a, 1)
        self.fc6 = nn.Linear(c5 * POOLED ** 2, HIDDEN)
        self.fc7 = nn.Linear(HIDDEN, HIDDEN)
        self.cls_score = nn.Linear(HIDDEN, num_classes)
        self.bbox_pred = nn.Linear(HIDDEN, 4 * num_classes)
        self._constants: Dict[tuple, torch.Tensor] = {}

    def _constant(self, key: tuple, make) -> torch.Tensor:
        """A tensor made once per key (its device in it) and kept: the
        anchors of a map size, the pixel means."""
        held = self._constants.get(key)
        if held is None:
            held = self._constants[key] = make()
        return held

    def trunk(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) RGB in [0, 1] → conv5_3 (B, 512, H', W')."""
        means = self._constant(
            ('means', images.device, images.dtype), lambda: torch.tensor(
                PIXEL_MEANS_BGR, dtype=images.dtype, device=images.device))
        # NCHW: the B=8 trunk takes 74.1 ms on an H100 against 79.9 ms in
        # channels_last, whose convolutions on the CPU also round ~4x
        # further from float64
        x = (images.flip(-1) * 255.0 - means).permute(0, 3, 1, 2)
        return vgg_trunk(self, x.contiguous(), ceil_mode=True)

    def rpn(self, conv5: torch.Tensor):
        """conv5_3 → (foreground probabilities (B, H'·W'·A), deltas
        (B, H'·W'·A, 4)), in (h, w, a) order."""
        h = F.relu(conv(conv5, self.rpn_conv))
        score = conv(h, self.rpn_cls_score)
        b, two_a, gh, gw = score.shape
        a = two_a // 2
        prob = torch.softmax(score.reshape(b, 2, a * gh, gw), dim=1)
        fg = prob[:, 1].reshape(b, a, gh, gw).permute(0, 2, 3, 1)
        deltas = conv(h, self.rpn_bbox_pred).permute(0, 2, 3, 1)
        return fg.reshape(b, -1), deltas.reshape(b, -1, 4)

    def propose(self, fg: torch.Tensor, deltas: torch.Tensor,
                image_hw: Tuple[int, int], map_hw: Tuple[int, int]):
        """The proposal layer (`ops/proposals.py::propose`) → (rois
        (B, post_nms_top_n, 4), valid (B, post_nms_top_n))."""
        s = self.settings
        anchors = self._constant(
            ('anchors', fg.device) + tuple(map_hw),
            lambda: shifted_anchors(self.base_anchors, *map_hw, FEAT_STRIDE,
                                    fg.device))
        return propose(fg, deltas, anchors, image_hw,
                       s.rpn_min_size * s.scale, s.pre_nms_top_n,
                       s.post_nms_top_n, s.rpn_nms_thresh)

    def pool(self, conv5: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """RoI max pooling: (B, R, 512, 7, 7)."""
        return roi_pool(conv5, rois, 1.0 / FEAT_STRIDE, (POOLED, POOLED))

    def box_head(self, pooled: torch.Tensor):
        """(B, R, C, 7, 7) → (cls_prob (B, R, classes), bbox_pred
        (B, R, 4·classes))."""
        b, r = pooled.shape[:2]
        x = pooled.reshape(b * r, -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        cls_prob = torch.softmax(self.cls_score(x), dim=-1)
        return (cls_prob.reshape(b, r, -1),
                self.bbox_pred(x).reshape(b, r, -1))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) RGB in [0, 1] → {'conv5_3', 'rpn_fg',
        'rpn_deltas', 'rois', 'roi_valid', 'cls_prob', 'bbox_pred'}."""
        image_hw = tuple(images.shape[1:3])
        conv5 = self.trunk(images)
        fg, deltas = self.rpn(conv5)
        with span('detect.proposals'):
            rois, valid = self.propose(fg, deltas, image_hw,
                                       tuple(conv5.shape[2:]))
        with span('detect.roi_pool'):
            pooled = self.pool(conv5, rois)
        with span('detect.box_head'):
            cls_prob, bbox_pred = self.box_head(pooled)
        return {'conv5_3': conv5, 'rpn_fg': fg, 'rpn_deltas': deltas,
                'rois': rois, 'roi_valid': valid, 'cls_prob': cls_prob,
                'bbox_pred': bbox_pred}


class FasterRCNNDetector:
    """Faster R-CNN VGG16 behind the detectors' serving surface:
    `detect_images(frames)` → per image [(label, score, (cx, cy, w, h))],
    image-relative, best first. Runs on `device` ('cuda' unless the
    caller passes 'cpu'; a missing card raises). `module` serves an
    existing `FasterRCNN` (its weights loaded by the caller); otherwise
    one is built with torch's default init under `seed`."""

    def __init__(self, labels: Sequence[str] = VOC_CLASSES,
                 settings: RCNNSettings = RCNNSettings(), seed: int = 0,
                 device='cuda', module: Optional[FasterRCNN] = None):
        self.device = resolve_device(device)
        self.labels = tuple(labels)
        if module is None:
            module = seeded(seed, lambda: FasterRCNN(len(self.labels),
                                                     settings))
        if module.num_classes != len(self.labels):
            raise ValueError(f'{len(self.labels)} labels for a module of '
                             f'{module.num_classes} classes')
        self.settings = module.settings
        self.module = module.to(self.device).eval()

    def decode(self, out: Dict[str, torch.Tensor],
               image_hw: Tuple[int, int]):
        """The forward's outputs → padded detections (boxes (B, M, 4)
        image-relative centre form, labels, scores, valid (B, M))."""
        s = self.settings
        return class_detections(out['cls_prob'], out['bbox_pred'],
                                out['rois'], out['roi_valid'], image_hw,
                                s.score_thresh, s.nms_thresh,
                                s.max_per_image)

    @torch.no_grad()
    def detect_images(self, images) -> List[List[Tuple]]:
        """images (B, H, W, 3) RGB in [0, 1] → per image [(label, score,
        (cx, cy, w, h))], image-relative, by score (module docstring for
        the spans)."""
        with span('detect'):
            with span('detect.h2d'):
                x = to_device(images, self.device)
            with span('detect.forward'):
                out = self.module(x)
            with span('detect.decode_nms'):
                dets = self.decode(out, tuple(x.shape[1:3]))
            with span('detect.fetch'):
                dets = [a.cpu().numpy() for a in dets]
            with span('detect.results'):
                return named_boxes(dets, self.labels)
