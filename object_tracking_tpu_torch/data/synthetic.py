"""Synthetic moving-box dataset for hermetic end-to-end training.

A copy of `object_tracking_tpu/data/synthetic.py`: videos of shapes moving
on a textured background, written as JPEGs and PASCAL-VOC XML (trackid
included), with the same seeded layout, so that both packages fabricate
the same dataset. Multi-object scenes: `objects_per_video`, `crossing`
trajectories, `occlusion_frames`, unannotated `clutter`, per-object
`object_scale_jitter` and `camera_pan`. `cv2` is imported where the images
are drawn and written.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

from object_tracking_tpu_torch.data.voc import Annotation, ObjectAnnotation


# Per-class-index appearance (BGR fill, shape) — classes must be visually
# separable for any detector to learn them; the reference's synthetic
# story is "download MOT17", which has no offline equivalent.
_CLASS_STYLES = (
    ((0, 200, 255), 'square'), ((255, 120, 0), 'circle'),
    ((60, 220, 60), 'square'), ((200, 60, 200), 'circle'),
)

# Distractor fills deliberately far from every class color (dim grays /
# browns) so clutter is learnable-as-background, not label noise.
_CLUTTER_STYLES = (
    ((110, 110, 110), 'square'), ((70, 90, 120), 'circle'),
    ((120, 100, 80), 'square'),
)


def _draw_shape(img, x, y, bw, bh, color, shape) -> None:
    import cv2
    if shape == 'circle':
        cv2.ellipse(img, (x + bw // 2, y + bh // 2), (bw // 2, bh // 2),
                    0, 0, 360, color, -1)
    else:
        img[y:y + bh, x:x + bw] = color


def _draw_object(img, x, y, bw, bh, class_idx: int) -> None:
    color, shape = _CLASS_STYLES[class_idx % len(_CLASS_STYLES)]
    _draw_shape(img, x, y, bw, bh, color, shape)


def _draw_clipped(img, x, y, bw, bh, color, shape) -> None:
    """Draw a shape whose box may extend past the frame (camera pan):
    cv2's ellipse clips itself; the square path needs explicit
    clamping (negative numpy slices would wrap)."""
    import cv2
    h, w = img.shape[:2]
    if x + bw <= 0 or y + bh <= 0 or x >= w or y >= h:
        return
    if shape == 'circle':
        cv2.ellipse(img, (x + bw // 2, y + bh // 2),
                    (bw // 2, bh // 2), 0, 0, 360, color, -1)
    else:
        x1, y1 = max(x, 0), max(y, 0)
        x2, y2 = min(x + bw, w), min(y + bh, h)
        img[y1:y2, x1:x2] = color


class _Track:
    """One object's trajectory: position integrated per frame, velocity
    reflected at the borders, optionally hidden for an occlusion span."""

    def __init__(self, trackid: int, class_idx: int, x: float, y: float,
                 vx: float, vy: float, bw: int, bh: int,
                 hide: Tuple[int, int] = (0, 0)):
        self.trackid = trackid
        self.class_idx = class_idx
        self.x, self.y, self.vx, self.vy = x, y, vx, vy
        self.bw, self.bh = bw, bh
        self.hide = hide                       # [start, end) frames

    def step(self, w: int, h: int) -> None:
        self.x += self.vx
        self.y += self.vy
        if self.x < 0 or self.x > w - self.bw:
            self.vx = -self.vx
            self.x = float(np.clip(self.x, 0, w - self.bw))
        if self.y < 0 or self.y > h - self.bh:
            self.vy = -self.vy
            self.y = float(np.clip(self.y, 0, h - self.bh))

    def visible(self, frame: int) -> bool:
        lo, hi = self.hide
        return not (lo <= frame < hi)

    def box(self) -> Tuple[int, int, int, int]:
        x, y = int(self.x), int(self.y)
        return (x, y, x + self.bw, y + self.bh)


def _occ_span(rng, occlusion_frames) -> int:
    """occlusion_frames: int span, or (lo, hi) inclusive range drawn
    per object (MOT17-like occlusions vary in length)."""
    if isinstance(occlusion_frames, (tuple, list)):
        lo, hi = occlusion_frames
        return int(rng.randint(lo, hi + 1)) if hi > 0 else 0
    return int(occlusion_frames)


def _spawn_tracks(rng, num: int, w: int, h: int, bw: int, bh: int,
                  num_classes: int, frames: int, crossing: bool,
                  occlusion_frames, base_trackid: int,
                  object_scale_jitter: float = 0.0) -> List[_Track]:
    base_bw, base_bh = bw, bh
    tracks = []
    for i in range(num):
        class_idx = i % num_classes
        if object_scale_jitter:
            # per-OBJECT scale diversity (MOT17 crowds mix near/far
            # pedestrians at very different apparent sizes)
            s = 1.0 + rng.uniform(-object_scale_jitter,
                                  object_scale_jitter)
            bw = max(int(base_bw * s), 4)
            bh = max(int(base_bh * s), 4)
        if crossing and num >= 2:
            # Opposite-edge starts with velocities aimed through the
            # frame center: every pair's paths intersect mid-video, the
            # id-switch stressor single-object data never exercises.
            side = i % 4
            margin = 2
            if side == 0:
                x, y = margin, rng.uniform(0, h - bh)
            elif side == 1:
                x, y = w - bw - margin, rng.uniform(0, h - bh)
            elif side == 2:
                x, y = rng.uniform(0, w - bw), margin
            else:
                x, y = rng.uniform(0, w - bw), h - bh - margin
            # velocity carries the object to the mirrored position over
            # ~the whole clip, passing center near frames/2
            tx = (w - bw) - x if side in (0, 1) else x
            ty = y if side in (0, 1) else (h - bh) - y
            steps = max(frames - 1, 1)
            vx = (tx - x) / steps + rng.uniform(-1, 1)
            vy = (ty - y) / steps + rng.uniform(-1, 1)
        else:
            x = rng.uniform(0, w - bw)
            y = rng.uniform(0, h - bh)
            vx, vy = rng.randint(-8, 9, size=2).astype(float)
        hide = (0, 0)
        span = _occ_span(rng, occlusion_frames)
        if span > 0 and frames > span + 2:
            # hide once mid-trajectory; never the first/last frame, so
            # the track both pre-exists and outlives its occlusion
            lo = int(rng.randint(1, frames - span))
            hide = (lo, lo + span)
        tracks.append(_Track(base_trackid + i, class_idx, float(x),
                             float(y), vx, vy, bw, bh, hide))
    return tracks


def make_synthetic_dataset(root: str, *, num_videos: int = 2,
                           frames_per_video: int = 8,
                           image_size: Tuple[int, int] = (416, 416),
                           labels: Sequence[str] = ('1',),
                           box_frac: float = 0.3, seed: int = 0,
                           size_jitter: float = 0.0,
                           objects_per_video: int = 1,
                           crossing: bool = False,
                           occlusion_frames=0,
                           clutter: int = 0,
                           object_scale_jitter: float = 0.0,
                           camera_pan: float = 0.0) -> Tuple[str, str]:
    """Write JPEG frames + VOC XMLs; returns (image_dir, annot_dir).

    Each class index renders with a distinct fill color/shape so
    multi-class detectors can actually be trained on this data;
    `size_jitter` varies the per-video box scale by up to ±that fraction
    of `box_frac` (0 keeps the legacy fixed size). With
    `objects_per_video > 1` every frame contains that many tracked
    objects (distinct trackids, classes cycling); see the module
    docstring for `crossing` / `occlusion_frames` / `clutter`.

    Knobs moving the scenes toward MOT17 statistics (crowds, variable
    occlusion, moving camera):
    - `occlusion_frames` may be an (lo, hi) range drawn per object;
    - `object_scale_jitter` varies the PER-OBJECT box scale ±fraction
      (near/far crowd members at different apparent sizes);
    - `camera_pan` > 0 pans the whole scene (background and objects
      shift together) by a smooth random walk of up to that fraction of
      the frame per video — objects can leave the view, dropping GT
      like MOT visibility 0, and re-enter under the same trackid.
    """
    import cv2
    rng = np.random.RandomState(seed)
    w, h = image_size
    image_dir = os.path.join(root, 'images')
    annot_dir = os.path.join(root, 'annotations')
    for v in range(num_videos):
        folder = f'video_{v:02d}'
        os.makedirs(os.path.join(image_dir, folder), exist_ok=True)
        os.makedirs(os.path.join(annot_dir, folder), exist_ok=True)
        frac = box_frac
        if size_jitter:
            frac *= 1.0 + rng.uniform(-size_jitter, size_jitter)
        bw, bh = max(int(w * frac), 4), max(int(h * frac), 4)
        if objects_per_video == 1 and not crossing:
            # legacy single-object path: keep the exact historic layout
            # (integer positions/velocities, class = video index)
            x = rng.randint(0, w - bw)
            y = rng.randint(0, h - bh)
            vx, vy = rng.randint(-8, 9, size=2).astype(float)
            tracks = [_Track(v, v % len(labels), float(x), float(y),
                             vx, vy, bw, bh)]
            span = _occ_span(rng, occlusion_frames)
            if span > 0 and frames_per_video > span + 2:
                lo = int(rng.randint(1, frames_per_video - span))
                tracks[0].hide = (lo, lo + span)
        else:
            tracks = _spawn_tracks(
                rng, objects_per_video, w, h, bw, bh, len(labels),
                frames_per_video, crossing, occlusion_frames,
                base_trackid=v * objects_per_video,
                object_scale_jitter=object_scale_jitter)
        # camera pan: smooth random-walk offset per frame, shared by
        # background and every object (a moving camera over a static
        # world), bounded to ±camera_pan of the frame
        pan = np.zeros((frames_per_video, 2), int)
        if camera_pan > 0:
            step_px = camera_pan * min(w, h) / max(
                np.sqrt(frames_per_video), 1.0)
            walk = np.cumsum(rng.randn(frames_per_video, 2) * step_px,
                             axis=0)
            lim = camera_pan * np.array([w, h])
            pan = np.clip(walk, -lim, lim).astype(int)
        bg = rng.randint(0, 80, size=(h, w, 3), dtype=np.uint8)
        # static unannotated distractors, drawn under the objects
        lutter = []
        for c in range(clutter):
            cw = max(int(w * frac * rng.uniform(0.5, 1.2)), 4)
            ch = max(int(h * frac * rng.uniform(0.5, 1.2)), 4)
            lutter.append((int(rng.randint(0, max(w - cw, 1))),
                           int(rng.randint(0, max(h - ch, 1))),
                           cw, ch, _CLUTTER_STYLES[c % 3]))
        for f in range(frames_per_video):
            if f > 0:
                for tr in tracks:
                    tr.step(w, h)
            dx, dy = int(pan[f, 0]), int(pan[f, 1])
            # the camera shows world coords [dx, dx+w) x [dy, dy+h);
            # np.roll wraps the texture (cheap, seam is just texture)
            img = np.roll(bg, (-dy, -dx), axis=(0, 1)).copy()
            for (cx, cy, cw, ch, (color, shape)) in lutter:
                _draw_clipped(img, cx - dx, cy - dy, cw, ch, color,
                              shape)
            objs = []
            for tr in tracks:
                if not tr.visible(f):
                    continue
                x1, y1, x2, y2 = tr.box()
                x1, x2 = x1 - dx, x2 - dx
                y1, y2 = y1 - dy, y2 - dy
                _draw_clipped(img, x1, y1, tr.bw, tr.bh,
                              _CLASS_STYLES[tr.class_idx
                                            % len(_CLASS_STYLES)][0],
                              _CLASS_STYLES[tr.class_idx
                                            % len(_CLASS_STYLES)][1])
                # GT clipped to the view; dropped when (nearly) out of
                # frame — the panning camera's analogue of MOT
                # visibility 0 (the trackid survives to re-entry)
                cx1, cy1 = max(x1, 0), max(y1, 0)
                cx2, cy2 = min(x2, w), min(y2, h)
                if cx2 - cx1 >= 4 and cy2 - cy1 >= 4:
                    objs.append((labels[tr.class_idx], tr.trackid,
                                 (cx1, cy1, cx2, cy2)))
            fname = f'{f:04d}.jpg'
            cv2.imwrite(os.path.join(image_dir, folder, fname), img)
            _write_xml(os.path.join(annot_dir, folder, f'{f:04d}.xml'),
                       folder, fname, w, h, objs)
    return image_dir, annot_dir


def _write_xml(path, folder, filename, width, height, objs) -> None:
    """objs: list of (label, trackid, (xmin, ymin, xmax, ymax))."""
    ann = ET.Element('annotation')
    ET.SubElement(ann, 'folder').text = folder
    ET.SubElement(ann, 'filename').text = filename
    size = ET.SubElement(ann, 'size')
    ET.SubElement(size, 'width').text = str(width)
    ET.SubElement(size, 'height').text = str(height)
    for label, trackid, box in objs:
        obj = ET.SubElement(ann, 'object')
        ET.SubElement(obj, 'name').text = str(label)
        ET.SubElement(obj, 'trackid').text = str(trackid)
        bb = ET.SubElement(obj, 'bndbox')
        for k, v in zip(('xmin', 'ymin', 'xmax', 'ymax'), box):
            ET.SubElement(bb, k).text = str(v)
    ET.ElementTree(ann).write(path)


def make_synthetic_annotations(num_videos: int = 2,
                               frames_per_video: int = 8,
                               image_size: Tuple[int, int] = (64, 64),
                               labels: Sequence[str] = ('1',),
                               seed: int = 0) -> List[Annotation]:
    """In-memory annotations (no files) for pure-logic tests."""
    rng = np.random.RandomState(seed)
    w, h = image_size
    anns = []
    for v in range(num_videos):
        folder = f'video_{v:02d}'
        bw, bh = w // 4, h // 4
        x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
        for f in range(frames_per_video):
            anns.append(Annotation(
                filename=f'{folder}/{f:04d}.jpg', folder=folder,
                width=w, height=h,
                objects=[ObjectAnnotation(
                    labels[v % len(labels)], x, y, x + bw, y + bh,
                    trackid=v)]))
    return anns
