"""Detection cells: a darknet `.cfg` detector behind the program's
`CfgDetector.detect_images`.

The mix's `entry` is `detect_images` and its `loop` `closed`: B camera
streams, one frame of each a call, the next call as soon as the last
returned, for `--seconds`. The frames come from a pool of `pool` calls
of continuing scenes, cycled.

Set-up: the scenes, the weights on the device with their BatchNorm
statistics set from the first call's frames (the model kind's
`calibrate`), an `obj_threshold` that leaves `live_candidates`
candidates in every frame of the first call (from the reference's
decoded scores, handed to both sides), the program's detector on the
configuration's `.cfg` with those weights, and `warmup` calls of the
cell's own shape. The weights are kept for the check. A program whose
cfg compiler does not carry each [yolo] head's `scale_x_y` decodes every
box off the configuration's, and the run stops before set-up with an
error.

`correct`: the calls of `traffic.sample_calls` (the first, and others
drawn from the seed) are judged once the window has closed. Their frames
go through the reference: its heads against those the program's forward
returned (`heads`: the largest over the heads of max |diff| over
max |reference|); its decode, merge, top-K cap and NMS of the program's
own heads against what the call returned (`answers`: frames that differ
in a label, or by more than `TOL` in a score or a box, or are missing).
A head or an answer that holds a NaN fails: the head reads infinite, the
frame differs.

Spans of a traced run: `spans.installed` on the detector's module
(`model`, `batch_norm`, and the NMS kernel's launches kept as `nms`
notes), `mish` around each Mish activation of the compiled network (its
element count kept as a `mish` note) and `decode_nms` around the heads'
decode, merge, cap and NMS.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, models, spans, traffic, weights
from portbench.drivers.common import (
    Context, Outcome, Phases, memory_peak, now, precision, quantile,
    rel_max, release, sync)
from portbench.trace import Traced

TOL = 1e-6      # boxes and scores of a returned detection, absolute


def frames_pool(mix: dict, cfg: dict, seed: int) -> np.ndarray:
    """(P, B, H, W, 3) float32 in [0, 1]: call p holds frame p of each of
    the B streams."""
    made = traffic.scenes(traffic.rng(seed, 1), mix['streams'], mix['pool'],
                          cfg['image'], mix['objects'], cfg['num_classes'],
                          mix['objects'])
    frames = made['images_u8'].transpose(1, 0, 2, 3, 4)
    return np.ascontiguousarray(frames, dtype=np.float32) / np.float32(255.0)


def live_threshold(scores: np.ndarray, live: int) -> float:
    """The `live`-th best candidate score of the worst frame of (N, M, C)
    class scores, nudged down: a threshold that leaves at least `live`
    candidates in every frame."""
    best = np.sort(scores.max(-1), axis=-1)[:, ::-1]
    return float(best[:, min(live, best.shape[1]) - 1].min()) * 0.999


def require_scale_x_y(cfg: dict, text: str) -> None:
    """Raise unless the program's cfg compiler gives each [yolo] head the
    configuration's `scale_x_y`."""
    from object_tracking_tpu_torch.models import darknet_cfg
    _, plan = darknet_cfg.compile_cfg(darknet_cfg.parse_darknet_cfg(text))
    got = [spec.get('scale_x_y') for spec in darknet_cfg.head_specs(plan)]
    if got != list(cfg['scale_x_y']):
        raise RuntimeError(
            f"the program's [yolo] heads carry scale_x_y {got}, the "
            f"configuration's are {cfg['scale_x_y']}: its boxes would be "
            'decoded off the published ones')


def program_detector(cfg: dict, text: str, w, obj: float, device):
    from object_tracking_tpu_torch.models.darknet_cfg import CfgDetector
    det = CfgDetector(text, labels=cfg['labels'], obj_threshold=obj,
                      nms_threshold=cfg['nms_threshold'], device=device)
    det.module.load_state_dict(w, strict=True)
    return det


@contextlib.contextmanager
def installed(tracer, det):
    """The traced run's spans around `det`'s layers (module docstring)."""
    from object_tracking_tpu_torch.models import darknet_cfg
    activate, decode = darknet_cfg._activate, darknet_cfg.decode_cfg_outputs

    def mish_span(x, kind):
        if kind != 'mish':
            return activate(x, kind)
        with tracer.span('mish'):
            out = activate(x, kind)
        if tracer.active:
            tracer.notes['mish'].append(out.numel())
        return out
    darknet_cfg._activate = mish_span
    darknet_cfg.decode_cfg_outputs = spans._wrapped(tracer, decode,
                                                    'decode_nms')
    try:
        with spans.installed(tracer, det.module, serving=True):
            yield
    finally:
        darknet_cfg._activate = activate
        darknet_cfg.decode_cfg_outputs = decode


def run(ctx: Context) -> Outcome:
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    kind = models.kind(cfg)
    text = kind.cfg_text(cfg)
    require_scale_x_y(cfg, text)
    phase = Phases(ctx.t0)
    phase('imports')
    pool = frames_pool(mix, cfg, ctx.seed)
    phase('scenes')
    with precision(cfg), torch.no_grad():
        w = weights.make(cfg, ctx.seed, dev)
        first = kind.calibrate(w, cfg, torch.from_numpy(pool[0]).to(dev))
        obj = live_threshold(kind.reference_scores(first, cfg),
                             mix['live_candidates'])
        del first
        phase('weights_and_threshold')
        det = (ctx.program or program_detector)(cfg, text, w, obj, dev)
        phase('program')
        for i in range(mix['warmup']):
            det.detect_images(pool[i % len(pool)])
        sync(dev)
        phase('warmup')
        setup_s = now() - ctx.t0
        from object_tracking_tpu_torch.ops.cuda.nms import nms_scores
        launched = nms_scores.launches
        loop = _detect_loop(ctx, det, pool)
        launched = nms_scores.launches - launched
    peak = memory_peak(dev)
    reading = None
    if ctx.trace:
        reading = loop['traced'].reading(
            mix['streams'] * flops.forward_per_frame(cfg))
    kept = loop['kept']
    del det, loop['traced']
    release(dev)
    numbers, checked = check(cfg, mix, kept, pool, w, obj, dev)
    lat = loop['latency']
    e2e = {'setup_s': setup_s,
           'frames_per_s': loop['calls'] * mix['streams'] / loop['elapsed']}
    lines = [{'checked_calls': checked, 'setup_phases_s': phase.took,
              'obj_threshold': obj,
              'nms_launches_per_call': launched / max(loop['calls'], 1)},
             {'call_ms': {'median': quantile(lat, 0.5) * 1e3,
                          'p95': quantile(lat, 0.95) * 1e3,
                          'max': max(lat) * 1e3, 'calls': len(lat)}}]
    return Outcome(e2e, loop['calls'], loop['failed'], numbers, peak,
                   reading, lines)


def _detect_loop(ctx: Context, det, pool: np.ndarray) -> dict:
    """The measured window, closed loop: the calls made, the failures,
    each call's time, the checked calls' records and the traced part."""
    mix = ctx.traffic
    sample = set(traffic.sample_calls(ctx.seed, mix['check_calls'],
                                      mix['check_span']))
    traced = Traced(ctx.trace, mix['trace_calls'],
                    lambda tracer: installed(tracer, det))
    kept: Dict[int, dict] = {}
    grabbed: List[list] = []
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
                lambda m, a, out: grabbed.append(out['heads']))
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
            kept[calls] = {'out': out,
                           'heads': grabbed.pop() if grabbed else None}
        calls += 1
        traced.end()
    elapsed = now() - start
    traced.close()
    return {'calls': calls, 'failed': failed, 'latency': latency,
            'elapsed': elapsed, 'kept': kept, 'traced': traced}


def _close(x: float, y: float) -> bool:
    """Within `TOL`, or the same infinity; a NaN on either side is not."""
    return x == y or abs(x - y) <= TOL


def _same_frame(got: list, want: list, names) -> bool:
    if len(got) != len(want):
        return False
    for (label, score, box), (cls, ref_score, ref_box) in zip(got, want):
        if (label != names[cls] or not _close(score, ref_score)
                or len(box) != len(ref_box)
                or not all(_close(x, y) for x, y in zip(box, ref_box))):
            return False
    return True


def _heads_reading(got: torch.Tensor, want: torch.Tensor) -> float:
    """`rel_max` of one head; infinite where the shapes differ or either
    side holds a value that is not finite (a NaN would read as nothing)."""
    if got.shape != want.shape:
        return float('inf')
    value = rel_max(got, want)
    return value if math.isfinite(value) else float('inf')


def check(cfg: dict, mix: dict, kept: Dict[int, dict], pool: np.ndarray,
          w: dict, obj: float, device):
    """The numbers that decide `correct`, over the recorded calls, and
    the indices of the calls checked."""
    numbers = {'heads': 0.0, 'answers': 0}
    if not kept:
        numbers['answers'] = 1
        return numbers, []
    kind, b = models.kind(cfg), mix['streams']
    with precision(cfg), torch.no_grad():
        for i, rec in sorted(kept.items()):
            if isinstance(rec['out'], Exception) or rec['heads'] is None:
                numbers['answers'] += b
                continue
            frames = torch.from_numpy(pool[i % len(pool)]).to(device)
            ref = kind.reference_heads(w, cfg, frames)
            if len(rec['heads']) != len(ref):
                numbers['heads'] = float('inf')
            for got, want in zip(rec['heads'], ref):
                numbers['heads'] = max(numbers['heads'],
                                       _heads_reading(got, want))
            want = kind.reference_detections(rec['heads'], cfg, obj)
            numbers['answers'] += abs(len(rec['out']) - len(want)) + sum(
                not _same_frame(g, wf, cfg['labels'])
                for g, wf in zip(rec['out'], want))
    return numbers, sorted(kept)
