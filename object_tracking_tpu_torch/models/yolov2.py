"""User-facing YOLOv2 detector: build, load darknet weights, predict, extract.

Port of `object_tracking_tpu/models/yolov2.py`: the `Darknet19` module
behind the KerasYOLO surface (labels and geometry from a `DetectorConfig`,
darknet `.weights` ingestion, `predict` with an optional drawing,
`extract` of a feature volume) and the frozen-detector surface of the
darknet wrapper (`get_layer_dims`, `detect`, `extract_spatio_info`,
`forward_batch`).

Everything runs on the detector's device ('cuda' unless the caller passes
`device='cpu'`; a missing card raises). Decode and NMS of a whole batch
are one `decode_and_nms` call, so on the card the NMS kernel launches
once per call however many images there are (the JAX code vmaps one
decode per image). `nms_impl` chooses the NMS route of every decode
(`ops/nms.py::greedy_nms_scores`; 'auto' is the kernel on the card). `detect_images` is the body of `predict` on arrays;
only image paths and drawing need `cv2`, which is imported there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.config import DetectorConfig
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.models.darknet19 import Darknet19, seeded
from object_tracking_tpu_torch.ops.decode import decode_and_nms, named_boxes
from object_tracking_tpu_torch.ops.weights import load_yolov2_weights
from object_tracking_tpu_torch.utils.frames import (
    read_frame, resolve_device, to_device)

Detection = Tuple[str, float, Tuple[float, ...]]


@torch.no_grad()
def rerandomize_head(module: torch.nn.Module, generator: torch.Generator,
                     grid_h: int, grid_w: int, layer: str = 'conv_23'):
    """Re-randomize the last conv before fine-tuning, in place: weight and
    bias drawn N(0,1) / (GH·GW) from `generator` (a CPU generator; JAX's
    PRNG stream cannot be reproduced). Returns `module`."""
    target = next((m for name, m in module.named_modules()
                   if name.rsplit('.', 1)[-1] == layer), None)
    if target is None:
        raise KeyError(f'{layer} not found in the module')
    for p in (target.weight, target.bias):
        if p is not None:
            p.copy_(torch.randn(p.shape, generator=generator)
                    / (grid_h * grid_w))
    return module


class YOLOv2Detector:
    """Stateful convenience wrapper around the Darknet19 module (in
    `self.model`, with running BatchNorm statistics). With a `mesh`
    (`parallel.mesh.Mesh`) the module's batch statistics span its data
    group, for data-parallel training."""

    def __init__(self, config: Optional[DetectorConfig] = None,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 device='cuda', nms_impl: str = 'auto', mesh=None):
        self.config = config or DetectorConfig()
        cfg = self.config
        self.device = resolve_device(device)
        self.nms_impl = nms_impl
        self.model = seeded(seed, lambda: Darknet19(
            cfg.num_classes, cfg.num_anchors, dtype, cfg.width_div,
            mesh=mesh))
        self.model = self.model.to(self.device).eval()
        self.anchors = torch.tensor(cfg.anchors, dtype=torch.float32,
                                    device=self.device)
        if cfg.weights_path:
            self.load_darknet_weights(cfg.weights_path)

    # -- weights ---------------------------------------------------------
    def load_darknet_weights(self, path: str) -> None:
        """Load a darknet yolov2.weights file. The head conv_23 keeps its
        random init when the file's class count differs."""
        loaded = load_yolov2_weights(path, self.config.num_classes,
                                     self.config.num_anchors)
        missing, unexpected = self.model.load_state_dict(
            from_flax(loaded), strict=False)
        if unexpected or set(missing) - {'conv_23.weight', 'conv_23.bias'}:
            raise KeyError(f'{path}: unexpected {unexpected}, '
                           f'missing {missing}')

    # -- pure forward ----------------------------------------------------
    @torch.no_grad()
    def forward(self, images) -> dict:
        """images (B, H, W, 3) in [0, 1] → {'netout', 'conv_feat'}."""
        return self.model(to_device(images, self.device), train=False)

    def _prep(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        image, x = read_frame(path, (self.config.image_h,
                                     self.config.image_w))
        return image, x[None]

    def _decode(self, netout: torch.Tensor, top_k: int = 128):
        cfg = self.config
        return decode_and_nms(netout, self.anchors,
                              obj_threshold=cfg.obj_threshold,
                              nms_threshold=cfg.nms_threshold, top_k=top_k,
                              nms_impl=self.nms_impl)

    # -- reference-parity API -------------------------------------------
    def detect_images(self, images) -> List[List[Detection]]:
        """The body of `predict` on arrays: images (B, H, W, 3) in [0, 1]
        at the detector's input size → per image [(label, score,
        (cx, cy, w, h))], sorted by score. One forward, one decode+NMS."""
        return named_boxes(self._decode(self.forward(images)['netout']),
                           self.config.labels)

    def predict(self, input_path: str, output_path: Optional[str] = None
                ) -> List[Detection]:
        """Detect objects in an image; optionally draw + save. Returns
        [(label, score, (cx, cy, w, h))] with image-relative coordinates."""
        image, x = self._prep(input_path)
        named = self.detect_images(x)[0]
        if output_path:
            self._draw(image, named, output_path)
        return named

    def _draw(self, image_rgb: np.ndarray, dets, output_path: str) -> None:
        import cv2
        img = np.ascontiguousarray(image_rgb[:, :, ::-1])
        ih, iw = img.shape[:2]
        for label, score, (cx, cy, w, h) in dets:
            x1, x2 = int((cx - w / 2) * iw), int((cx + w / 2) * iw)
            y1, y2 = int((cy - h / 2) * ih), int((cy + h / 2) * ih)
            cv2.rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 3)
            cv2.putText(img, f'{label} {score:.2f}', (x1, y1 - 13),
                        cv2.FONT_HERSHEY_SIMPLEX, 1e-3 * ih, (0, 255, 0), 2)
        cv2.imwrite(output_path, img)

    def detect(self, input_path: str) -> List[Detection]:
        """Detections for one image, sorted by score."""
        return self.predict(input_path)

    def extract(self, input_path: str, layer: str = 'conv_feat'
                ) -> np.ndarray:
        """Intermediate feature volume for one image.
        `layer` ∈ {'conv_feat', 'netout'}."""
        _, x = self._prep(input_path)
        return self.forward(x)[layer][0].cpu().numpy()

    def get_layer_dims(self, layer: str = 'conv_feat'
                       ) -> Tuple[int, int, int]:
        """Feature-volume dims (h, w, c)."""
        cfg = self.config
        gh, gw = cfg.image_h // 32, cfg.image_w // 32
        if layer == 'conv_feat':
            return gh, gw, max(1024 // cfg.width_div, 4)
        if layer == 'netout':
            return gh, gw, cfg.num_anchors * (5 + cfg.num_classes)
        raise KeyError(layer)

    def forward_batch(self, images, layer: str = 'conv_feat',
                      top_k: int = 16):
        """Batched prior-source surface: images (N, H, W, 3) in [0, 1] →
        (feats (N, fh, fw, fc), boxes (N, K, 4) center-format normalized,
        labels (N, K), scores (N, K), valid (N, K)), tensors on the
        detector's device."""
        out = self.forward(images)
        boxes, labels, scores, valid = self._decode(out['netout'], top_k)
        return out[layer], boxes, labels, scores, valid

    def extract_spatio_info(self, file_path: str, layer: str = 'conv_feat',
                            class_filter: Optional[Sequence[str]] = None):
        """Detections (lower-case labels) + the feature volume of one
        image, from one forward."""
        _, x = self._prep(file_path)
        out = self.forward(x)
        named = named_boxes(self._decode(out['netout']),
                            [l.lower() for l in self.config.labels])[0]
        if class_filter is not None:
            allowed = {c.lower() for c in class_filter}
            named = [d for d in named if d[0] in allowed]
        return named, out[layer][0].cpu().numpy()
