"""Inference wrapper: joint detect+track over video windows, with IDs.

Port of `object_tracking_tpu/inference.py::JointPredictor`. One predict call
runs, on the predictor's device:

- the model forward over all B·T frames (ConvLSTM state carried across
  calls — streaming);
- decode of every frame and per-class greedy NMS for all B·T frames in ONE
  call (on CUDA: one launch of the NMS kernel, `ops/cuda/nms.py`);
- with matcher='greedy', identity assignment (`ops/matching.assign_tracks`)
  of all T frames in order, batched over the B clips, in ONE call (on
  CUDA: one launch of the assignment kernel, `ops/cuda/assign.py`), with
  no host sync;

and one copy of the results to the host at the end.

Each `predict_batch` and `predict_window` call is the span `predict`
(`utils/profiling.py`), with the spans `predict.h2d` (the frames' copy in),
`predict.forward`, `predict.decode_nms`, `predict.assign` (the window's
identity assignment), `predict.fetch` (every copy out, which waits for the
device's queued work) and `predict.results` (the detection dicts) inside.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from object_tracking_tpu_torch.config import TRACK_GATE_IOU
from object_tracking_tpu_torch.ops.decode import boxes_to_list, decode_and_nms
from object_tracking_tpu_torch.ops.matching import (
    TrackManager, assign_tracks, init_track_state)
from object_tracking_tpu_torch.utils.frames import (
    read_frame, resolve_device, to_device)
from object_tracking_tpu_torch.utils.profiling import span


def float_state(state):
    """The ConvLSTM state tree ((c, h), or a deep head's ((c, h),
    (cs, hs))) with every leaf in float32: the carry between calls,
    whatever the model's compute dtype."""
    if isinstance(state, torch.Tensor):
        return state.float()
    return tuple(float_state(s) for s in state)


def track_dicts(rows, names: Sequence[str]) -> List[dict]:
    """`boxes_to_list` rows with ids → the joint surfaces' detection
    dicts; a label past `names` is named by its index."""
    return [{'label': names[l] if l < len(names) else str(l),
             'score': s, 'box': b, 'track_id': int(i)}
            for l, s, b, i in rows]


class JointPredictor:
    """Runs a MultiObjDetTracker (with its weights loaded) over frame
    windows.

    Args beyond the JAX predictor's: the model carries its own weights (no
    `variables` argument) and is moved to `device`, where everything runs
    ('cuda' by default; a missing card raises); `nms_impl` forwards to
    `greedy_nms_scores` ('auto' = the CUDA kernel on a card).
    """

    def __init__(self, model, anchors, labels: Sequence[str],
                 obj_threshold: float = 0.5,
                 nms_threshold: float = 0.45,
                 head: str = 'track',
                 iou_threshold: float = TRACK_GATE_IOU,
                 net_size: Tuple[int, int] = (416, 416),
                 bn_mode: str = 'batch',
                 matcher: str = 'greedy',
                 max_tracks: int = 64,
                 max_age: int = 3,
                 device='cuda',
                 nms_impl: str = 'auto'):
        if matcher not in ('greedy', 'hungarian'):
            raise ValueError(matcher)
        if bn_mode not in ('batch', 'running'):
            raise ValueError(bn_mode)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32),
                                       device=self.device)
        self.labels = tuple(labels)
        self.obj_threshold = obj_threshold
        self.nms_threshold = nms_threshold
        self.head = head
        self.iou_threshold = iou_threshold
        self.net_h, self.net_w = net_size
        self.batch_bn = bn_mode == 'batch'
        self.matcher = matcher
        self.max_tracks = max_tracks
        self.max_age = max_age
        self.nms_impl = nms_impl
        self.tracks = TrackManager(iou_threshold=iou_threshold,
                                   max_age=max_age)
        self._state = None                  # carried ConvLSTM state
        self._track_state = None            # carried TrackState
        self._bstate = None
        self._btrack_state = None

    @torch.no_grad()
    def _run(self, images: torch.Tensor, state, track_state):
        """images (B, T, H, W, 3) on the device → numpy (boxes, labels,
        scores, valid) each (B, T, K, ...), ids (B, T, K) or None, and the
        new device states."""
        with span('predict.forward'):
            out = self.model(images, train=self.batch_bn,
                             initial_state=state, return_state=True)
            state = float_state(out['state'])
        with span('predict.decode_nms'):
            boxes, labels, scores, valid = decode_and_nms(
                out[self.head], self.anchors,
                obj_threshold=self.obj_threshold,
                nms_threshold=self.nms_threshold, nms_impl=self.nms_impl)
        ids = None
        if self.matcher == 'greedy':
            with span('predict.assign'):
                track_state, ids = assign_tracks(
                    track_state, boxes, labels, valid,
                    iou_threshold=self.iou_threshold, max_age=self.max_age)
        with span('predict.fetch'):
            if ids is not None:
                ids = ids.cpu().numpy()
            dets = tuple(a.cpu().numpy()
                         for a in (boxes, labels, scores, valid))
        return dets, ids, state, track_state

    def reset_state(self) -> None:
        """Drop the carried ConvLSTM state (and track identities) so the
        next window starts a fresh, independent clip."""
        self._state = None
        self._track_state = None
        self.tracks.reset()

    def _frames(self, boxes, labels, scores, valid,
                dev_ids) -> List[List[dict]]:
        """Per-frame detection dicts for one clip's (T, ...) outputs."""
        out = []
        for t in range(boxes.shape[0]):
            rows = boxes_to_list(boxes[t], labels[t], scores[t], valid[t],
                                 None if dev_ids is None else dev_ids[t])
            if dev_ids is None:             # the host Hungarian matcher
                ids = self.tracks.update(
                    np.asarray([r[2] for r in rows],
                               np.float32).reshape(-1, 4),
                    labels=np.asarray([r[0] for r in rows], np.int32))
                rows = [r + (i,) for r, i in zip(rows, ids)]
            out.append(track_dicts(rows, self.labels))
        return out

    def _zero_state(self, b: int):
        return self.model.zero_state(b, self.net_h // 32, self.net_w // 32)

    def predict_window(self, frames) -> List[List[dict]]:
        """frames: list of image paths OR array (T, H, W, 3) in [0,1].

        Returns per frame: [{'label', 'score', 'box' (cx,cy,w,h) rel,
        'track_id'}, ...].

        Consecutive calls are a streaming continuation — the ConvLSTM
        state carries across windows. Call `reset_state()` between
        unrelated clips.
        """
        with span('predict'):
            if isinstance(frames[0], str):
                x = np.stack([read_frame(p, (self.net_h, self.net_w))[1]
                              for p in frames])[None]
            else:
                x = np.asarray(frames, np.float32)[None]
            if self._state is None:
                self._state = self._zero_state(x.shape[0])
            if self._track_state is None:
                self._track_state = init_track_state(self.max_tracks, 1,
                                                     self.device)
            with span('predict.h2d'):
                images = to_device(x, self.device)
            dets, ids, self._state, self._track_state = self._run(
                images, self._state, self._track_state)
            with span('predict.results'):
                return self._frames(*(a[0] for a in dets),
                                    None if ids is None else ids[0])

    def reset_batch_state(self) -> None:
        """Drop all batched streams' carried state."""
        self._bstate = None
        self._btrack_state = None

    def predict_batch(self, clips) -> List[List[List[dict]]]:
        """B INDEPENDENT clip streams in one call.

        clips: (B, T, H, W, 3) float32 in [0, 1]. Returns per clip the same
        per-frame structure as `predict_window`. Consecutive calls stream:
        clip i's ConvLSTM + track state carries to the next call's clip i
        (a batch-size change resets all streams). Requires
        matcher='greedy'. bn_mode='batch' computes BatchNorm statistics
        over the WHOLE batch, as the JAX predictor does.
        """
        if self.matcher != 'greedy':
            raise ValueError(
                'predict_batch requires matcher="greedy" (the host '
                'Hungarian path is per-stream)')
        with span('predict'):
            x = np.asarray(clips, np.float32)
            b = x.shape[0]
            if (self._btrack_state is not None
                    and self._btrack_state.next_id.shape[0] != b):
                self.reset_batch_state()
            if self._bstate is None:
                self._bstate = self._zero_state(b)
                self._btrack_state = init_track_state(self.max_tracks, b,
                                                      self.device)
            with span('predict.h2d'):
                images = to_device(x, self.device)
            dets, ids, self._bstate, self._btrack_state = self._run(
                images, self._bstate, self._btrack_state)
            with span('predict.results'):
                return [self._frames(*(a[i] for a in dets), ids[i])
                        for i in range(b)]

    def predict_video(self, paths: Sequence, window: int = 4,
                      draw_dir: Optional[str] = None
                      ) -> List[List[dict]]:
        """Stride through a full clip (image paths or frames) in windows.
        Track IDs persist and the ConvLSTM state streams across window
        boundaries. A partial last window is padded by repeating its last
        frame and the padded predictions are dropped."""
        self.reset_state()
        results: List[List[dict]] = []
        for start in range(0, len(paths), window):
            chunk = list(paths[start:start + window])
            tail = len(chunk)
            if tail < window:
                chunk = chunk + [chunk[-1]] * (window - tail)
            results.extend(self.predict_window(chunk)[:tail])
        if draw_dir:
            self._draw(paths[:len(results)], results, draw_dir)
        return results

    def _draw(self, paths, results, out_dir: str) -> None:
        import os

        import cv2
        os.makedirs(out_dir, exist_ok=True)
        colors: dict = {}

        def track_color(tid: int):
            if tid not in colors:
                colors[tid] = tuple(int(c) for c in np.random.RandomState(
                    tid).randint(0, 255, 3))
            return colors[tid]

        for p, dets in zip(paths, results):
            img = cv2.imread(p)
            ih, iw = img.shape[:2]
            for d in dets:
                cx, cy, w, h = d['box']
                x1, y1 = int((cx - w / 2) * iw), int((cy - h / 2) * ih)
                x2, y2 = int((cx + w / 2) * iw), int((cy + h / 2) * ih)
                color = track_color(d['track_id'])
                cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
                cv2.putText(img, f"#{d['track_id']} {d['label']}",
                            (x1, y1 - 5), cv2.FONT_HERSHEY_SIMPLEX,
                            0.5, color, 1)
            cv2.imwrite(os.path.join(
                out_dir, os.path.basename(p)), img)
