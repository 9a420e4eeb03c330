"""Two-stage detection cells: Faster R-CNN VGG16 behind the program's
`FasterRCNNDetector.detect_images`.

The mix's `entry` is `detect_images` and its `loop` `closed`: B camera
streams, one frame of each a call, the next call as soon as the last
returned, for `--seconds`. The frames come from a pool of `pool` calls
of continuing scenes (`frames_pool`), cycled. `drivers/detect.py` serves
darknet `.cfg` detectors on square frames; these frames are the
configuration's `image_hw`, made here from `--seed` by the same recipe as
`traffic.scenes`: dark noise with `objects` drifting rectangles a stream,
each in its class's colour, inside the frame.

Set-up: the scenes, the seeded weights on the device, the program's
detector built with them, and `warmup` calls of the cell's own shape. A
program without `models/faster_rcnn.py` stops the run there with an
`ImportError`, a few seconds in.

`correct`: the calls of `traffic.sample_calls` (the first, and others
drawn from the seed) are judged once the window has closed, stage by
stage, each stage of the reference fed the program's own outputs of the
stage before (the forward hook keeps them):
- `rpn`: the reference's trunk and RPN on the call's frames against the
  program's foreground scores and deltas (the larger rel max);
- `rois`: images whose RoIs differ from the reference's proposal layer
  on the program's scores and deltas: another count, or a coordinate more
  than `ROI_ULPS` float32 ulps of the reference's off (boxes are pixels up
  to 1000: an ulp there is 6.1e-5);
- `head`: the reference's RoI pooling and head on the program's conv5_3
  and RoIs against its class probabilities and box deltas (the larger rel
  max);
- `answers`: frames whose detections differ from the reference's
  post-processing of the program's probabilities, deltas and RoIs (in a
  label, or by more than `drivers/detect.py::TOL` in a score or a
  relative box coordinate, or missing).
A number that is not finite reads infinite; a NaN box differs.

Spans of a traced run: `spans.installed` on the detector's module
(`model`, and kernel 1's launches kept as `nms` notes), `proposals`,
`roi_pool` and `box_head` around the module's `propose`, `pool` and
`box_head` (each RoI-pooling launch's sizes kept as a `roi_pool` note),
and `decode_nms` around the detector's `decode` (class-specific boxes,
the per-class NMS on kernel 1 and the top-`max_per_image` cap).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, models, spans, traffic, weights
from portbench.drivers.common import (
    Context, Outcome, Phases, memory_peak, now, precision, program_model,
    quantile, rel_max, release, sync)
from portbench.drivers.detect import _same_frame
from portbench.trace import Traced

ROI_ULPS = 4
# (owner, method, span): the owner is the detector's module or the
# detector itself
STAGES = (('module', 'propose', 'proposals'), ('module', 'pool', 'roi_pool'),
          ('module', 'box_head', 'box_head'),
          ('detector', 'decode', 'decode_nms'))


def scenes(gen: np.random.Generator, streams: int, frames: int, hw,
           objects: int, classes: int) -> np.ndarray:
    """`streams` videos of `frames` frames of size hw = (H, W): uint8
    (S, F, H, W, 3), `objects` rectangles a stream, of classes 1 to
    classes − 1 (0 is the background), drifting and bouncing inside."""
    h, w = hw
    colours = np.random.default_rng(123).integers(80, 256, (classes, 3))
    images = gen.integers(0, 60, (streams, frames, h, w, 3), dtype=np.uint8)
    size = np.array([w, h])
    lo, hi = size // 16, size // 3
    wh = gen.integers(lo, hi, (streams, objects, 2))
    start = gen.integers(0, size - hi, (streams, objects, 2))
    speed = gen.integers(-6, 7, (streams, objects, 2))
    kinds = gen.integers(1, classes, (streams, objects))
    pos = traffic._bounce(start, speed, np.arange(frames), size - wh)
    for s in range(streams):
        for o in range(objects):
            bw, bh = wh[s, o]
            for f in range(frames):
                x, y = pos[s, o, :, f]
                images[s, f, y:y + bh, x:x + bw] = colours[kinds[s, o]]
    return images


def frames_pool(mix: dict, cfg: dict, seed: int) -> np.ndarray:
    """(P, B, H, W, 3) float32 in [0, 1]: call p holds frame p of each of
    the B streams."""
    made = scenes(traffic.rng(seed, 1), mix['streams'], mix['pool'],
                  cfg['image_hw'], mix['objects'], len(cfg['labels']))
    frames = made.transpose(1, 0, 2, 3, 4)
    return np.ascontiguousarray(frames, dtype=np.float32) / np.float32(255.0)


def program_detector(cfg: dict, w: dict, device):
    from object_tracking_tpu_torch.models.faster_rcnn import (
        FasterRCNNDetector)
    return FasterRCNNDetector(labels=cfg['labels'], device=device,
                              module=program_model(cfg, w, device))


@contextlib.contextmanager
def installed(tracer, det):
    """The traced run's spans around `det`'s stages (module docstring)."""
    owners = {'module': det.module, 'detector': det}

    def pool_note(args, out):
        conv5, rois = args
        tracer.notes['roi_pool'].append(
            (rois.shape[0] * rois.shape[1], conv5.shape[1],
             out.shape[-2] * out.shape[-1], conv5.numel()))
    for owner, attr, name in STAGES:
        setattr(owners[owner], attr, spans._wrapped(
            tracer, getattr(owners[owner], attr), name,
            pool_note if name == 'roi_pool' else None))
    try:
        with spans.installed(tracer, det.module, serving=True):
            yield
    finally:
        for owner, attr, _ in STAGES:
            delattr(owners[owner], attr)


def run(ctx: Context) -> Outcome:
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    phase = Phases(ctx.t0)
    phase('imports')
    pool = frames_pool(mix, cfg, ctx.seed)
    phase('scenes')
    with precision(cfg), torch.no_grad():
        w = weights.make(cfg, ctx.seed, dev)
        phase('weights')
        det = (ctx.program or program_detector)(cfg, w, dev)
        phase('program')
        for i in range(mix['warmup']):
            det.detect_images(pool[i % len(pool)])
        sync(dev)
        phase('warmup')
        setup_s = now() - ctx.t0
        from object_tracking_tpu_torch.ops.cuda.nms import nms_scores
        from object_tracking_tpu_torch.ops.cuda.roi_pool import roi_pool
        launched = (nms_scores.launches, roi_pool.launches)
        loop = _loop(ctx, det, pool)
        launched = (nms_scores.launches - launched[0],
                    roi_pool.launches - launched[1])
    peak = memory_peak(dev)
    reading = None
    if ctx.trace:
        reading = loop['traced'].reading(
            mix['streams'] * flops.forward_per_frame(cfg))
    kept = loop['kept']
    del det, loop['traced']
    release(dev)
    numbers, checked = check(cfg, mix, kept, pool, w, dev)
    lat = loop['latency']
    calls = max(loop['calls'], 1)
    e2e = {'setup_s': setup_s,
           'frames_per_s': loop['calls'] * mix['streams'] / loop['elapsed']}
    lines = [{'checked_calls': checked, 'setup_phases_s': phase.took,
              'nms_launches_per_call': launched[0] / calls,
              'roi_pool_launches_per_call': launched[1] / calls},
             {'call_ms': {'median': quantile(lat, 0.5) * 1e3,
                          'p95': quantile(lat, 0.95) * 1e3,
                          'max': max(lat) * 1e3, 'calls': len(lat)}}]
    return Outcome(e2e, loop['calls'], loop['failed'], numbers, peak,
                   reading, lines)


def _loop(ctx: Context, det, pool: np.ndarray) -> dict:
    """The measured window, closed loop: the calls made, the failures,
    each call's time, the checked calls' records and the traced part."""
    mix = ctx.traffic
    sample = set(traffic.sample_calls(ctx.seed, mix['check_calls'],
                                      mix['check_span']))
    traced = Traced(ctx.trace, mix['trace_calls'],
                    lambda tracer: installed(tracer, det))
    kept: Dict[int, dict] = {}
    grabbed: List[dict] = []
    latency: List[float] = []
    failed = calls = 0
    start = now()
    while True:
        began = now()
        if (began - start >= ctx.seconds and calls >= ctx.min_units
                and traced.done()):
            break
        if (ctx.trace and traced.at is None
                and began - start >= ctx.seconds / 2):
            traced.at = calls
        traced.begin(calls)
        record = calls in sample
        if record:
            hook = det.module.register_forward_hook(
                lambda m, a, out: grabbed.append(out))
        try:
            with traced.span('call'):
                out = det.detect_images(pool[calls % len(pool)])
        except Exception as err:        # a failed call counts as missing
            failed += 1
            out = err
        latency.append(now() - began if not isinstance(out, Exception)
                       else float('inf'))
        if record:
            hook.remove()
            kept[calls] = {'dets': out,
                           'out': grabbed.pop() if grabbed else None}
        calls += 1
        traced.end()
    elapsed = now() - start
    traced.close()
    return {'calls': calls, 'failed': failed, 'latency': latency,
            'elapsed': elapsed, 'kept': kept, 'traced': traced}


def _reading(got: torch.Tensor, want: torch.Tensor) -> float:
    """`rel_max`; infinite where the shapes differ or a value is not
    finite (a NaN would read as nothing)."""
    if got.shape != want.shape:
        return float('inf')
    value = rel_max(got, want)
    return value if math.isfinite(value) else float('inf')


def same_rois(got: torch.Tensor, valid: torch.Tensor,
              want: torch.Tensor) -> bool:
    """One image's RoIs (R, 4) with their valid mask against the
    reference's (n, 4): the first n rows valid and no other, each
    coordinate within ROI_ULPS float32 ulps of the reference's."""
    n = want.shape[0]
    if int(valid.sum()) != n or not bool(valid[:n].all()):
        return False
    got, want = got[:n].float(), want.float()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) \
        - want.abs()
    return bool(((got - want).abs() <= ROI_ULPS * ulp).all())


def check(cfg: dict, mix: dict, kept: Dict[int, dict], pool: np.ndarray,
          w: dict, device):
    """The numbers that decide `correct`, over the recorded calls, and
    the indices of the calls checked."""
    numbers = {'rpn': 0.0, 'rois': 0, 'head': 0.0, 'answers': 0}
    if not kept:
        numbers['answers'] = 1
        return numbers, []
    kind, b = models.kind(cfg), mix['streams']
    with precision(cfg), torch.no_grad():
        for i, rec in sorted(kept.items()):
            out = rec['out']
            if isinstance(rec['dets'], Exception) or out is None:
                numbers['rois'] += b
                numbers['answers'] += b
                continue
            frames = torch.from_numpy(pool[i % len(pool)]).to(device)
            ref = kind.reference_forward(w, cfg, frames)
            numbers['rpn'] = max(
                numbers['rpn'], _reading(out['rpn_fg'], ref['rpn_fg']),
                _reading(out['rpn_deltas'], ref['rpn_deltas']))
            del ref
            props = kind.reference_proposals(out['rpn_fg'],
                                             out['rpn_deltas'], cfg)
            numbers['rois'] += abs(out['rois'].shape[0] - len(props)) + sum(
                not same_rois(r, v, p) for r, v, p in
                zip(out['rois'], out['roi_valid'], props))
            cls, box = kind.reference_head(w, cfg, out['conv5_3'],
                                           out['rois'])
            numbers['head'] = max(numbers['head'],
                                  _reading(out['cls_prob'], cls),
                                  _reading(out['bbox_pred'], box))
            want = kind.reference_detections(out, cfg)
            got = rec['dets']
            numbers['answers'] += abs(len(got) - len(want)) + sum(
                not _same_frame(g, wf, cfg['labels'])
                for g, wf in zip(got, want))
    return numbers, sorted(kept)
