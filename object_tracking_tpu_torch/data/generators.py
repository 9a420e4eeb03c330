"""Batch generators: host IO, per-epoch shuffle, fixed shapes.

Port of `object_tracking_tpu/data/generators.py` (with `_pad_boxes` and
`_GeneratorBase`). A generator is callable → a fresh shuffled iterator of
plain numpy batches (the fit loop's contract).

- `DetectionBatches`: detector-training batches {'images' (B,H,W,3),
  'y_true' (B,GH,GW,A,5+C), 'true_boxes' (B,1,1,1,M,4)}, or with `heads`
  (multi-scale [yolo] heads) a tuple of each, one per head.
- `SequenceBatches`: (B, T) video windows of the joint pipeline.
  `raw_mode=True` (the fused train steps) gives {'images_u8' (B,T,H,W,3)
  uint8, 'boxes' (B,T,M,4) network pixels, 'cls', 'valid', 'aug_seeds'
  (B,) uint32}, host work only; the legacy mode {'images' (B,T,H,W,3)
  float32 in [0, 1], 'y_true', 'true_boxes'}, augmented and encoded here
  on the host CPU.
- `TrackerSequenceBatches`: the single-object pipeline {'feats'
  (B,T,fh,fw,fc), 'det' (B,T,D), 'target' (B,T,D)} over a frozen prior
  source (see its docstring).

The numpy `RandomState(seed)` calls are the JAX generators', in their
order (one permutation per epoch; then `randint` for a raw batch's
'aug_seeds', or `rand` for the tracker's `det_dropout`), so both packages
give the same batches for the same seed. Host augmentation draws its
per-window or per-frame seeds from a separate torch generator, so it
leaves that stream alone (JAX draws them from its own PRNG key).

Images are decoded where the JAX generators decode them: with the native
C++ runtime (`data/native_loader.py`) when its library builds, else with
`cv2`, imported at use. Without `loader=` a batch is one native call
(`load_batch`, two threads), else one `loader(path)` (path → (H, W, 3)
float32 in [0, 1]) per frame; the raw mode's uint8 frames come from
`load_batch_u8` whenever the library is available, `loader=` or not.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.data import native_loader
from object_tracking_tpu_torch.data.augment import (
    AugmentConfig, augment_frames_batch, augment_sequences_batch)
from object_tracking_tpu_torch.data.voc import Annotation
from object_tracking_tpu_torch.ops.heatmap import heatmap_encode
from object_tracking_tpu_torch.ops.targets import (
    encode_targets_batch, encode_targets_multiscale)


def _read_resized(path: str, net_h: int, net_w: int) -> np.ndarray:
    """(net_h, net_w, 3) uint8 RGB."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.resize(img, (net_w, net_h))[:, :, ::-1]       # BGR → RGB


def _default_loader(net_h: int, net_w: int) -> Callable[[str], np.ndarray]:
    native = native_loader.make_loader(net_h, net_w)
    if native is not None:
        return native

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
        self._batch_loader = None
        if loader is None and native_loader.available():
            self._batch_loader = lambda paths: native_loader.load_batch(
                paths, net_h, net_w, n_threads=2)
        self.debug_dir = debug_dir
        self._rng = np.random.RandomState(seed)
        self._aug_rng = torch.Generator().manual_seed(seed)
        self._epoch = 0

    def _aug_seeds(self, n: int) -> np.ndarray:
        """Per-window (or per-frame) seeds of the host augmentation."""
        return torch.randint(0, 2**31 - 1, (n,),
                             generator=self._aug_rng).numpy()

    def _encode(self, boxes, cls, valid):
        return encode_targets_batch(
            torch.as_tensor(boxes), torch.as_tensor(cls),
            torch.as_tensor(valid), self.anchors, image_h=self.net_h,
            image_w=self.net_w, grid_h=self.grid_h, grid_w=self.grid_w,
            num_classes=len(self.labels), true_box_buffer=self.max_boxes)

    def _load_paths(self, paths: Sequence[str]) -> np.ndarray:
        """(N, net_h, net_w, 3) float32 batch: one native call without
        `loader=`, else the loader per path."""
        if self._batch_loader is not None:
            return self._batch_loader(list(paths))
        return np.stack([self.loader(p) for p in paths])

    def _load_paths_u8(self, paths: Sequence[str]) -> np.ndarray:
        """(N, net_h, net_w, 3) uint8 RGB, resized but not normalised (the
        fused step divides by 255 on the device)."""
        if native_loader.available():
            return native_loader.load_batch_u8(list(paths), self.net_h,
                                               self.net_w, n_threads=2)
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


class DetectionBatches(_GeneratorBase):
    """Detector-training batches over single frames (see the module
    docstring). `heads` is the static per-head tuple of
    `ops/targets.encode_targets_multiscale` (anchors in pixels, grid,
    classes); then `anchors` and the grid are not used for encoding."""

    def __init__(self, annotations: Sequence[Annotation],
                 labels: Sequence[str], *, net_h: int = 416,
                 net_w: int = 416, grid_h: int = 13, grid_w: int = 13,
                 anchors, batch_size: int = 32, max_boxes: int = 50,
                 augment: bool = True,
                 aug_config: Optional[AugmentConfig] = None,
                 seed: int = 0, loader=None, drop_last: bool = True,
                 debug_dir: Optional[str] = None,
                 heads: Optional[tuple] = None):
        super().__init__(labels, net_h, net_w, anchors, batch_size,
                         max_boxes, grid_h, grid_w, augment, aug_config,
                         seed, loader, debug_dir)
        self.annotations = list(annotations)
        self.drop_last = drop_last
        self.heads = heads

    def __len__(self):
        n = len(self.annotations) // self.batch_size
        if not self.drop_last and len(self.annotations) % self.batch_size:
            n += 1
        return n

    def __call__(self):
        order = self._rng.permutation(len(self.annotations))
        self._epoch += 1
        for bi in range(len(self)):
            idx = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            yield self._make_batch([self.annotations[i] for i in idx], bi)

    def _make_batch(self, anns: List[Annotation], batch_idx: int) -> Dict:
        images = self._load_paths([a.filename for a in anns])
        padded = [_pad_boxes(a, self.labels, self.max_boxes,
                             self.net_h, self.net_w) for a in anns]
        boxes = np.stack([p[0] for p in padded])
        cls = np.stack([p[1] for p in padded])
        valid = np.stack([p[2] for p in padded])
        if self.augment:
            images, boxes = augment_frames_batch(
                self._aug_seeds(len(anns)), torch.from_numpy(images),
                torch.from_numpy(boxes), self.aug_config)
            images, boxes = images.numpy(), boxes.numpy()
        self._dump_debug(images, boxes, batch_idx)
        if self.heads is not None:
            y, b = encode_targets_multiscale(
                torch.from_numpy(boxes), torch.from_numpy(cls),
                torch.from_numpy(valid), self.heads, image_h=self.net_h,
                image_w=self.net_w, true_box_buffer=self.max_boxes)
            return {'images': images,
                    'y_true': tuple(a.numpy() for a in y),
                    'true_boxes': tuple(a.numpy() for a in b)}
        y, b = self._encode(boxes, cls, valid)
        return {'images': images, 'y_true': y.numpy(),
                'true_boxes': b.numpy()}


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


def _host(arrays) -> tuple:
    """A prior source's outputs (tensors on its device, or numpy) as numpy
    arrays: one copy to the host per output."""
    return tuple(a.cpu().numpy() if isinstance(a, torch.Tensor)
                 else np.asarray(a) for a in arrays)


class TrackerSequenceBatches(_GeneratorBase):
    """Single-object pipeline batches: {'feats' (B,T,fh,fw,fc), 'det'
    (B,T,D), 'target' (B,T,D)}, D = 4 (bbox) or heatmap_size².

    `detector` is a prior source with `get_layer_dims(layer)` and
    `forward_batch(images, layer) -> (feats, boxes, labels, scores,
    valid)`: `YOLOv2Detector`, `CfgDetector`, `VGG16PriorSource` (tensors
    on their device) or `FakeDetector` (numpy). Its outputs come to the
    host once per forward.

    With `augment=False` every unique frame goes through the detector once
    (`precompute`, in chunks of 16 frames) and is served from the cache
    thereafter. With `augment=True` each batch's windows are augmented
    (one parameter set per window, on the detector's device) and the
    detector runs on the augmented frames there, one forward per batch;
    the seeds come from the generator's torch stream, so augment mode is
    deterministic for a seed but not JAX's draws.

    A missed detection is exactly float32 zeros: `_select_detection`'s
    default and `det_dropout`'s zeroing both give np.zeros, the presence
    gate of TinyTracker's residual head reads it as a miss.
    """

    def __init__(self, windows: Sequence[Sequence[Annotation]],
                 labels: Sequence[str], detector, *,
                 net_h: int = 416, net_w: int = 416,
                 anchors=((1.0, 1.0),), batch_size: int = 4,
                 target_mode: str = 'bbox',       # 'bbox' | 'heatmap'
                 heatmap_size: int = 32,
                 tracked_classes: Optional[Sequence[str]] = None,
                 augment: bool = True,
                 aug_config: Optional[AugmentConfig] = None,
                 seed: int = 0, loader=None, drop_last: bool = True,
                 feature_layer: str = 'conv_feat',
                 det_dropout: float = 0.0):
        super().__init__(labels, net_h, net_w, anchors, batch_size, 1,
                         1, 1, augment, aug_config, seed, loader)
        self.det_dropout = float(det_dropout)
        self.windows = [list(w) for w in windows]
        self.detector = detector
        self.target_mode = target_mode
        self.heatmap_size = heatmap_size
        self.tracked_classes = (
            {c.lower() for c in tracked_classes}
            if tracked_classes else None)
        self.drop_last = drop_last
        self.feature_layer = feature_layer
        self._cache: Dict[str, Tuple] = {}

    def __len__(self):
        n = len(self.windows) // self.batch_size
        if not self.drop_last and len(self.windows) % self.batch_size:
            n += 1
        return n

    def precompute(self, chunk: int = 16) -> None:
        """Every unique frame through the detector once, `chunk` frames per
        forward, into the cache."""
        paths = list(dict.fromkeys(a.filename for win in self.windows
                                   for a in win))
        for i in range(0, len(paths), chunk):
            batch_paths = paths[i:i + chunk]
            prior = _host(self.detector.forward_batch(
                self._load_paths(batch_paths), layer=self.feature_layer))
            for j, p in enumerate(batch_paths):
                self._cache[p] = tuple(a[j] for a in prior)

    def _frame_prior(self, ann: Annotation):
        if ann.filename not in self._cache:
            self.precompute()
        return self._cache[ann.filename]

    def _select_detection(self, want: str, boxes, labels, scores, valid
                          ) -> np.ndarray:
        """The best-scoring valid detection of class `want` (the first of
        equal scores) → (4,) center-format normalised box, zeros when
        none."""
        det = np.zeros((4,), np.float32)
        best = -1.0
        for b, l, s, v in zip(boxes, labels, scores, valid):
            if not v or s <= best:
                continue
            name = self.labels[int(l)].lower() if int(l) < len(
                self.labels) else ''
            if self.tracked_classes is not None and \
                    name not in self.tracked_classes:
                continue
            if name != want:
                continue
            best = s
            det = np.asarray(b, np.float32)
        return det

    def _single_object_io(self, ann: Annotation):
        """The first GT object and the best detection of its class →
        (feats, det_in (4,) center, gt (4,) corner), both normalised."""
        obj = ann.objects[0]
        sx, sy = 1.0 / max(ann.width, 1), 1.0 / max(ann.height, 1)
        gt = np.array([obj.xmin * sx, obj.ymin * sy,
                       obj.xmax * sx, obj.ymax * sy], np.float32)
        feats, boxes, labels, scores, valid = self._frame_prior(ann)
        det = self._select_detection(obj.label.lower(), boxes, labels,
                                     scores, valid)
        return feats, det, gt

    def _augmented_io(self, wins: List[List[Annotation]]):
        """Augment each window on the detector's device, run the detector
        on the augmented frames there (one forward), pull its outputs and
        the augmented GT boxes to the host."""
        b, t = len(wins), len(wins[0])
        flat = [a.filename for w in wins for a in w]
        images = self._load_paths(flat).reshape(
            (b, t, self.net_h, self.net_w, 3))
        gt_px = np.zeros((b, t, 1, 4), np.float32)
        want: List[List[str]] = []
        for i, win in enumerate(wins):
            row = []
            for j, a in enumerate(win):
                bx, _, _ = _pad_boxes(a, self.labels, 1,
                                      self.net_h, self.net_w)
                gt_px[i, j] = bx
                row.append(a.objects[0].label.lower())
            want.append(row)
        device = getattr(self.detector, 'device', torch.device('cpu'))
        frames, gt_dev = augment_sequences_batch(
            self._aug_seeds(b),
            torch.from_numpy(images).to(device, non_blocking=True),
            torch.from_numpy(gt_px).to(device, non_blocking=True),
            self.aug_config)
        feats, dbox, dlab, dsc, dval = _host(self.detector.forward_batch(
            frames.reshape((b * t,) + tuple(frames.shape[2:])),
            layer=self.feature_layer))
        feats = feats.reshape((b, t) + feats.shape[1:])
        scale = np.array([self.net_w, self.net_h,
                          self.net_w, self.net_h], np.float32)
        gt = gt_dev.cpu().numpy()[:, :, 0, :] / scale    # corner, normalised
        det = np.zeros((b, t, 4), np.float32)
        for i in range(b):
            for j in range(t):
                k = i * t + j
                det[i, j] = self._select_detection(
                    want[i][j], dbox[k], dlab[k], dsc[k], dval[k])
        return feats, det, gt

    def __call__(self):
        if not self.augment and not self._cache:
            self.precompute()
        order = self._rng.permutation(len(self.windows))
        self._epoch += 1
        for bi in range(len(self)):
            idx = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            yield self._make_batch([self.windows[i] for i in idx])

    def _heatmap(self, x, y, w, h) -> np.ndarray:
        return heatmap_encode(*(torch.from_numpy(np.asarray(v, np.float32))
                                for v in (x, y, w, h)),
                              hmap_size=self.heatmap_size).numpy()

    def _make_batch(self, wins: List[List[Annotation]]) -> Dict:
        if self.augment:
            feats, det, gt = self._augmented_io(wins)
        else:
            feats_b, det_b, gt_b = [], [], []
            for win in wins:
                f_t, d_t, g_t = zip(*[self._single_object_io(a)
                                      for a in win])
                feats_b.append(np.stack(f_t))
                det_b.append(np.stack(d_t))
                gt_b.append(np.stack(g_t))
            feats = np.stack(feats_b)             # (B, T, fh, fw, fc)
            det = np.stack(det_b)                 # (B, T, 4) center
            gt = np.stack(gt_b)                   # (B, T, 4) corner

        if self.det_dropout > 0.0:
            # a dropped frame is exactly float32 zeros (np.where against
            # zeros, never an epsilon): the residual head's presence gate
            # routes on sum(|det|) > 0
            keep = self._rng.rand(*det.shape[:2]) >= self.det_dropout
            det = np.where(keep[..., None], det,
                           np.zeros_like(det)).astype(np.float32)

        # GT → center-format normalised target
        cx = 0.5 * (gt[..., 0] + gt[..., 2])
        cy = 0.5 * (gt[..., 1] + gt[..., 3])
        w = gt[..., 2] - gt[..., 0]
        h = gt[..., 3] - gt[..., 1]
        target = np.stack([cx, cy, w, h], axis=-1).astype(np.float32)

        if self.target_mode == 'heatmap':
            # top-left-format heatmaps for both the detection input and
            # the target
            det = self._heatmap(det[..., 0] - det[..., 2] / 2,
                                det[..., 1] - det[..., 3] / 2,
                                det[..., 2], det[..., 3])
            target = self._heatmap(gt[..., 0], gt[..., 1], w, h)
        return {'feats': feats, 'det': det.astype(np.float32),
                'target': target}
