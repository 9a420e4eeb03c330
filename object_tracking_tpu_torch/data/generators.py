"""Batch generators of the joint pipeline: host IO, per-epoch shuffle,
fixed shapes.

Port of `SequenceBatches` (with `_pad_boxes` and `_GeneratorBase`) of
`object_tracking_tpu/data/generators.py`: (B, T) video windows for the
joint detect+track pipeline. A generator is callable → a fresh shuffled
iterator of plain numpy batches (the fit loop's contract).

- `raw_mode=True` (the fused train steps): {'images_u8' (B,T,H,W,3)
  uint8, 'boxes' (B,T,M,4) network pixels, 'cls', 'valid', 'aug_seeds'
  (B,) uint32}. Host work only; augmentation and target encoding run in
  the step on the device.
- Legacy mode: {'images' (B,T,H,W,3) float32 in [0, 1], 'y_true', 'true_
  boxes'}, augmented and encoded here on the host CPU.

The numpy `RandomState(seed)` calls are the JAX generator's, in its order
(one permutation per epoch, then `randint` for a raw batch's 'aug_seeds'),
so both packages give the same windows, boxes and seeds. Legacy
augmentation draws its per-window seeds from a separate torch generator,
so it leaves that stream alone (JAX draws them from its own PRNG key).

Images are decoded with `cv2`, imported at use (the JAX package prefers
its native C++ decoder and falls back to cv2). `DetectionBatches` and
`TrackerSequenceBatches` come with their flows (ROADMAP.md queue 1,
items 11 and 13), as does the native decoder's binding.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.data.augment import (
    AugmentConfig, augment_sequences_batch)
from object_tracking_tpu_torch.data.voc import Annotation
from object_tracking_tpu_torch.ops.targets import encode_targets_batch


def _read_resized(path: str, net_h: int, net_w: int) -> np.ndarray:
    """(net_h, net_w, 3) uint8 RGB."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.resize(img, (net_w, net_h))[:, :, ::-1]       # BGR → RGB


def _default_loader(net_h: int, net_w: int) -> Callable[[str], np.ndarray]:
    def load(path: str) -> np.ndarray:
        return np.asarray(_read_resized(path, net_h, net_w),
                          np.float32) / 255.0
    return load


def _pad_boxes(ann: Annotation, labels: Sequence[str], max_boxes: int,
               net_h: int, net_w: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Boxes scaled to network pixels + class ids + validity, fixed M."""
    label_idx = {l: i for i, l in enumerate(labels)}
    boxes = np.zeros((max_boxes, 4), np.float32)
    cls = np.zeros((max_boxes,), np.int32)
    valid = np.zeros((max_boxes,), bool)
    sx = net_w / max(ann.width, 1)
    sy = net_h / max(ann.height, 1)
    for i, obj in enumerate(ann.objects[:max_boxes]):
        boxes[i] = (obj.xmin * sx, obj.ymin * sy,
                    obj.xmax * sx, obj.ymax * sy)
        cls[i] = label_idx.get(obj.label, -1)
        valid[i] = obj.label in label_idx
    return boxes, cls, valid


class _GeneratorBase:
    def __init__(self, labels: Sequence[str], net_h: int, net_w: int,
                 anchors, batch_size: int, max_boxes: int,
                 grid_h: int, grid_w: int,
                 augment: bool, aug_config: Optional[AugmentConfig],
                 seed: int,
                 loader: Optional[Callable[[str], np.ndarray]],
                 debug_dir: Optional[str] = None):
        self.labels = tuple(labels)
        self.net_h, self.net_w = net_h, net_w
        self.anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.grid_h, self.grid_w = grid_h, grid_w
        self.augment = augment
        self.aug_config = aug_config or AugmentConfig()
        self.loader = loader or _default_loader(net_h, net_w)
        self.debug_dir = debug_dir
        self._rng = np.random.RandomState(seed)
        self._aug_rng = torch.Generator().manual_seed(seed)
        self._epoch = 0

    def _aug_seeds(self, n: int) -> np.ndarray:
        """Per-window seeds of the legacy augmentation."""
        return torch.randint(0, 2**31 - 1, (n,),
                             generator=self._aug_rng).numpy()

    def _encode(self, boxes, cls, valid):
        return encode_targets_batch(
            torch.as_tensor(boxes), torch.as_tensor(cls),
            torch.as_tensor(valid), self.anchors, image_h=self.net_h,
            image_w=self.net_w, grid_h=self.grid_h, grid_w=self.grid_w,
            num_classes=len(self.labels), true_box_buffer=self.max_boxes)

    def _load_paths(self, paths: Sequence[str]) -> np.ndarray:
        """(N, net_h, net_w, 3) float32 batch."""
        return np.stack([self.loader(p) for p in paths])

    def _load_paths_u8(self, paths: Sequence[str]) -> np.ndarray:
        """(N, net_h, net_w, 3) uint8 RGB, resized but not normalised (the
        fused step divides by 255 on the device)."""
        out = np.empty((len(paths), self.net_h, self.net_w, 3), np.uint8)
        for i, p in enumerate(paths):
            out[i] = _read_resized(p, self.net_h, self.net_w)
        return out

    def _dump_debug(self, images: np.ndarray, boxes: np.ndarray,
                    batch_idx: int) -> None:
        """Write the augmented images with their GT boxes drawn to
        <debug_dir>/<batch>/."""
        if not self.debug_dir:
            return
        import cv2
        out = os.path.join(self.debug_dir, str(batch_idx))
        os.makedirs(out, exist_ok=True)
        flat_i = images.reshape((-1,) + images.shape[-3:])
        flat_b = boxes.reshape((-1,) + boxes.shape[-2:])
        for i, (img, bxs) in enumerate(zip(flat_i, flat_b)):
            bgr = np.ascontiguousarray(img[:, :, ::-1] * 255).astype(
                np.uint8)
            for x1, y1, x2, y2 in bxs:
                if x2 > x1 and y2 > y1:
                    cv2.rectangle(bgr, (int(x1), int(y1)),
                                  (int(x2), int(y2)), (0, 255, 0), 2)
            cv2.imwrite(os.path.join(out, f'{i}.jpg'), bgr)


class SequenceBatches(_GeneratorBase):
    """Joint-pipeline batches over video windows (see the module
    docstring for the two modes)."""

    def __init__(self, windows: Sequence[Sequence[Annotation]],
                 labels: Sequence[str], *, net_h: int = 416,
                 net_w: int = 416, grid_h: int = 13, grid_w: int = 13,
                 anchors, batch_size: int = 1, max_boxes: int = 50,
                 augment: bool = True,
                 aug_config: Optional[AugmentConfig] = None,
                 seed: int = 0, loader=None, drop_last: bool = True,
                 debug_dir: Optional[str] = None,
                 raw_mode: bool = False):
        super().__init__(labels, net_h, net_w, anchors, batch_size,
                         max_boxes, grid_h, grid_w, augment, aug_config,
                         seed, loader, debug_dir)
        self.windows = [list(w) for w in windows]
        self.drop_last = drop_last
        self.raw_mode = raw_mode

    def __len__(self):
        n = len(self.windows) // self.batch_size
        if not self.drop_last and len(self.windows) % self.batch_size:
            n += 1
        return n

    def __call__(self):
        order = self._rng.permutation(len(self.windows))
        self._epoch += 1
        for bi in range(len(self)):
            idx = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            yield self._make_batch([self.windows[i] for i in idx], bi)

    def _make_batch(self, wins: List[List[Annotation]], batch_idx: int
                    ) -> Dict:
        flat_paths = [a.filename for win in wins for a in win]
        t = len(wins[0])
        boxes, cls, valid = [], [], []
        for win in wins:
            p = [_pad_boxes(a, self.labels, self.max_boxes,
                            self.net_h, self.net_w) for a in win]
            boxes.append(np.stack([q[0] for q in p]))
            cls.append(np.stack([q[1] for q in p]))
            valid.append(np.stack([q[2] for q in p]))
        boxes = np.stack(boxes)
        cls, valid = np.stack(cls), np.stack(valid)
        if self.raw_mode:
            shape = (len(wins), t, self.net_h, self.net_w, 3)
            return {
                'images_u8': self._load_paths_u8(flat_paths).reshape(shape),
                'boxes': boxes, 'cls': cls, 'valid': valid,
                'aug_seeds': self._rng.randint(
                    0, 2**31 - 1, size=len(wins)).astype(np.uint32)}
        images = self._load_paths(flat_paths).reshape(
            (len(wins), t, self.net_h, self.net_w, 3))
        if self.augment:
            images, boxes = augment_sequences_batch(
                self._aug_seeds(len(wins)), torch.from_numpy(images),
                torch.from_numpy(boxes), self.aug_config)
            images, boxes = images.numpy(), boxes.numpy()
        y, b = self._encode(boxes, cls, valid)
        self._dump_debug(images, boxes, batch_idx)
        return {'images': images, 'y_true': y.numpy(),
                'true_boxes': b.numpy()}
