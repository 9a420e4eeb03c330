"""Serving: the joint clip program as one self-contained artifact.

Port of `object_tracking_tpu/serving.py`. The program

    uint8 frames -> /255 on the device -> Darknet-19 + ConvLSTM head ->
    per-frame decode, top-128 cap and greedy NMS -> greedy identity
    assignment of the window's frames in order -> (padded detections,
    track ids, carried ConvLSTM and track state)

is captured with `torch.export` with the trained weights baked in, and
written as one file: a magic, a version, a JSON header and the bytes of
`torch.export.save`. Reloading it needs `ServedJointPredictor` only: no
model class, no config tree, no checkpoint.

- NMS runs through the custom op `torch.ops.ott_torch.nms_scores`
  (`ops/cuda/nms.py`, `greedy_nms_scores(impl='op')`), so the exported
  graph holds one call of it: on the card that call launches the
  hand-written kernel, on the CPU it runs the kernel's plain twin. JAX
  exports `nms_impl='sort'` instead, since its Pallas kernel lowers for
  the TPU only; the results differ only by the kernels' IoU formula.
- Identity assignment is likewise one call of the custom op
  `torch.ops.ott_torch.assign_tracks` for the whole window
  (`ops/matching.py`, kernel `ops/cuda/csrc/assign_tracks.cu`).
- BatchNorm normalises with batch statistics (bn_mode 'batch') in
  `eval()` mode, so the graph writes no buffer, as JAX writes no batch
  statistics at serve time; `export_joint` refuses a graph that would.
  Traced on a card, each BatchNorm is one call of the custom op
  `torch.ops.ott_torch.batch_norm_stats` (`ops/cuda/batch_norm.py`),
  which this module registers, so a reload needs no model class either.
  The artifact holds the traced graph (torch.export's training IR), whose
  ops are those the eager model calls.
- JAX's artifact lowers for several platforms (`platforms=('tpu',
  'cpu')`); a torch graph has no such list. The header records the
  device the program was traced on, the artifact stores its weights on
  the CPU, and a reload moves the program to the device it serves on
  (`torch.export.passes.move_to_device_pass`): 'cuda' unless the caller
  asks for the CPU.
- The state in and out is explicit: the ConvLSTM state (a deep head's
  4-leaf ((c, h), (cs, hs)) tree too), float32, and the track table as a
  plain 7-tuple in `TrackState`'s field order, batched over B streams.
"""

from __future__ import annotations

import io
import json
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from object_tracking_tpu_torch.config import TRACK_GATE_IOU
from object_tracking_tpu_torch.inference import float_state, track_dicts
# registers ott_torch::batch_norm_*, which a graph traced on a card holds
from object_tracking_tpu_torch.ops.cuda import batch_norm  # noqa: F401
from object_tracking_tpu_torch.ops.decode import boxes_to_list, decode_and_nms
from object_tracking_tpu_torch.ops.matching import (
    TrackState, assign_tracks, init_track_state)
from object_tracking_tpu_torch.utils.frames import resolve_device

_MAGIC = b'OTTSERVE'
_VERSION = 1


class ClipProgram(nn.Module):
    """The clip function that `export_joint` captures; see
    `make_clip_program`."""

    def __init__(self, model: nn.Module, anchors, obj_threshold: float,
                 nms_threshold: float, head: str, bn_mode: str,
                 iou_threshold: float, max_age: int):
        super().__init__()
        if bn_mode not in ('batch', 'running'):
            raise ValueError(bn_mode)
        self.model = model.eval()
        device = next(model.parameters()).device
        self.register_buffer('anchors', torch.as_tensor(
            np.asarray(anchors, np.float32), device=device))
        self.obj_threshold = obj_threshold
        self.nms_threshold = nms_threshold
        self.head = head
        self.batch_bn = bn_mode == 'batch'
        self.iou_threshold = iou_threshold
        self.max_age = max_age

    def forward(self, frames_u8: torch.Tensor, state, track_state):
        images = frames_u8.float() / 255.0
        out = self.model(images, train=self.batch_bn, initial_state=state,
                         return_state=True)
        boxes, labels, scores, valid = decode_and_nms(
            out[self.head], self.anchors, obj_threshold=self.obj_threshold,
            nms_threshold=self.nms_threshold, nms_impl='op')
        tracks, ids = assign_tracks(
            TrackState(*track_state), boxes, labels, valid,
            iou_threshold=self.iou_threshold, max_age=self.max_age)
        return ((boxes, labels, scores, valid), ids,
                float_state(out['state']), tuple(tracks))


def make_clip_program(model: nn.Module, anchors,
                      obj_threshold: float = 0.5,
                      nms_threshold: float = 0.45,
                      head: str = 'track',
                      bn_mode: str = 'batch',
                      iou_threshold: float = TRACK_GATE_IOU,
                      max_age: int = 3) -> ClipProgram:
    """The clip program over `model` (a MultiObjDetTracker with its
    weights, which it puts in eval() mode):

    (frames_u8 (B, T, H, W, 3) uint8, state, track_state) ->
    ((boxes, labels, scores, valid), ids, state', track_state')

    It runs `inference.JointPredictor._run`'s steps (the same decode, the
    same greedy identity assignment), on raw uint8 frames, with the
    kernel's custom op for NMS.
    """
    return ClipProgram(model, anchors, obj_threshold, nms_threshold, head,
                       bn_mode, iou_threshold, max_age)


def _distinct(tree):
    """`tree` with every leaf a tensor of its own: torch.export traces one
    tensor passed as two inputs as one input, and `zero_state` gives c and
    h as the same zeros."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tuple(_distinct(node) for node in tree)


def _batched_zero_state(model: nn.Module, batch: int, gh: int, gw: int):
    """Zero ConvLSTM carry for `batch` independent streams (float32, the
    carry JointPredictor keeps), each leaf its own tensor."""
    return _distinct(model.zero_state(batch, gh, gw))


def _batched_track_state(batch: int, max_tracks: int,
                         device) -> Tuple[torch.Tensor, ...]:
    """One track table per stream, stacked on the leading batch axis, as
    the program's plain 7-tuple."""
    return tuple(init_track_state(max_tracks, batch, device))


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for node in tree for leaf in _leaves(node)]


def export_joint(model: nn.Module, anchors, labels: Sequence[str],
                 batch: int = 1, window: int = 4,
                 net_size: Tuple[int, int] = (416, 416),
                 obj_threshold: float = 0.5,
                 nms_threshold: float = 0.45,
                 head: str = 'track',
                 bn_mode: str = 'batch',
                 iou_threshold: float = TRACK_GATE_IOU,
                 max_tracks: int = 64, max_age: int = 3) -> bytes:
    """Export the clip program over `model`, traced on the model's device,
    to one self-contained artifact (bytes). Write it with `save_artifact`,
    serve it with `ServedJointPredictor`. The model's train/eval mode is
    restored afterwards."""
    h, w = net_size
    gh, gw = h // 32, w // 32
    device = next(model.parameters()).device
    was_training = model.training
    try:
        program = make_clip_program(
            model, anchors, obj_threshold=obj_threshold,
            nms_threshold=nms_threshold, head=head, bn_mode=bn_mode,
            iou_threshold=iou_threshold, max_age=max_age)
        frames = torch.zeros((batch, window, h, w, 3), dtype=torch.uint8,
                             device=device)
        state = _batched_zero_state(model, batch, gh, gw)
        tracks = _batched_track_state(batch, max_tracks, device)
        with torch.no_grad():
            exported = torch.export.export(program, (frames, state, tracks))
    finally:
        model.train(was_training)
    # Only the functional form lists every write to a buffer in its
    # signature (the traced form keeps in-place ops), and none may be
    # there. The artifact keeps the traced form: its ops are the eager
    # model's (aten.batch_norm, which the functional form decomposes into
    # another kernel), so that the program computes what JointPredictor
    # computes, bit for bit.
    mutated = exported.run_decompositions({}).graph_signature \
        .buffers_to_mutate
    if mutated:
        raise RuntimeError(f'the served program would write buffers '
                           f'{sorted(mutated.values())}')
    exported.example_inputs = None      # the zero inputs: no need to ship
    if device.type != 'cpu':
        exported = move_to_device_pass(exported, 'cpu')
    blob = io.BytesIO()
    torch.export.save(exported, blob)
    meta = {
        'version': _VERSION,
        'labels': list(labels),
        'batch': batch, 'window': window, 'net_size': [h, w],
        'grid': [gh, gw], 'max_tracks': max_tracks,
        'device': str(device),
        'dtype': str(getattr(model, 'dtype', torch.float32)).replace(
            'torch.', ''),
        'state_leaves': [
            {'shape': list(z.shape), 'dtype': str(z.dtype).replace(
                'torch.', '')} for z in _leaves(state)],
    }
    header = json.dumps(meta).encode()
    return (_MAGIC + struct.pack('<II', _VERSION, len(header)) + header
            + blob.getvalue())


def save_artifact(artifact: bytes, path: str) -> str:
    with open(path, 'wb') as f:
        f.write(artifact)
    return path


class ServedJointPredictor:
    """Thin serving host for an exported artifact: load and call.

    Needs no model class and no checkpoint: the weights are inside the
    artifact. Runs on `device` ('cuda' unless the caller passes 'cpu'; a
    missing card raises) and carries the streaming state between calls as
    `inference.JointPredictor` does; `reset_state()` between unrelated
    clips.
    """

    def __init__(self, artifact: bytes, device='cuda'):
        if artifact[:len(_MAGIC)] != _MAGIC:
            raise ValueError('not an OTTSERVE artifact')
        off = len(_MAGIC)
        version, hlen = struct.unpack_from('<II', artifact, off)
        if version != _VERSION:
            raise ValueError(f'artifact version {version}, '
                             f'expected {_VERSION}')
        off += 8
        self.meta = json.loads(artifact[off:off + hlen].decode())
        self.device = resolve_device(device)
        exported = torch.export.load(io.BytesIO(artifact[off + hlen:]))
        if self.device.type != 'cpu':
            exported = move_to_device_pass(exported, self.device)
        self.exported = exported              # the ExportedProgram
        self.program = exported.module()      # its callable graph
        self.labels = tuple(self.meta['labels'])
        self.batch = int(self.meta['batch'])
        self.window = int(self.meta['window'])
        self.net_h, self.net_w = self.meta['net_size']
        self.max_tracks = int(self.meta['max_tracks'])
        self._state = None
        self._track_state = None

    @classmethod
    def load(cls, path: str, device='cuda') -> 'ServedJointPredictor':
        with open(path, 'rb') as f:
            return cls(f.read(), device=device)

    def _zero_state(self):
        """The streaming carry from the recorded leaf specs: the (c, h)
        pair of a single-layer head, or a deep head's ((c, h), (cs, hs))."""
        leaves = [torch.zeros(tuple(leaf['shape']),
                              dtype=getattr(torch, leaf['dtype']),
                              device=self.device)
                  for leaf in self.meta['state_leaves']]
        if len(leaves) == 2:
            return (leaves[0], leaves[1])
        if len(leaves) == 4:
            return ((leaves[0], leaves[1]), (leaves[2], leaves[3]))
        raise ValueError(f'unsupported state tree ({len(leaves)} leaves)')

    def reset_state(self) -> None:
        self._state = None
        self._track_state = None

    @torch.no_grad()
    def predict_window(self, frames) -> List[List[List[dict]]]:
        """frames: (B, T, H, W, 3) uint8 (or float in [0, 1], converted)
        -> per clip, per frame: [{'label', 'score', 'box', 'track_id'}].

        Consecutive calls continue the streams (state carried);
        `reset_state()` starts fresh clips.
        """
        x = np.asarray(frames)
        if x.dtype != np.uint8:
            x = (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)
        want = (self.batch, self.window, self.net_h, self.net_w, 3)
        if x.shape != want:
            raise ValueError(f'expected {want}, got {x.shape}')
        if self._state is None:
            self._state = self._zero_state()
        if self._track_state is None:
            self._track_state = _batched_track_state(
                self.batch, self.max_tracks, self.device)
        dets, ids, self._state, self._track_state = self.program(
            torch.from_numpy(x).to(self.device), self._state,
            self._track_state)
        host = [a.cpu().numpy() for a in (*dets, ids)]
        return [[track_dicts(boxes_to_list(*(a[b, t] for a in host)),
                             self.labels)
                 for t in range(self.window)]
                for b in range(self.batch)]
