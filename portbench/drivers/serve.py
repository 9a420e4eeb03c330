"""Serving cells: the joint detect+track model behind `JointPredictor`.

The mix's `entry` is `predict_batch` (B streams a call) or
`predict_window` (one stream). Its `loop` is `closed` (the next call as
soon as the last returned, for `--seconds`) or `open` (a window due every
window / fps seconds, window · fps windows in `--seconds`, each timed from
when it was due). Each stream's ConvLSTM and track state carry from call
to call, over a pool of `pool` windows of continuing scenes, cycled.

Set-up: the scenes, the weights on the device, an `obj_threshold` that
leaves `live_candidates` candidates in every frame of the first window
(from the reference's netout, handed to both sides), the program's model
and predictor, `warmup` calls of the cell's own shape, the states reset.

`correct`: the calls of `traffic.sample_calls` (the first, and others
drawn from the seed) are judged once the window has closed. The program's
state before each (for the first, the zero state) and its frames go
through the reference: its netout and carried ConvLSTM state against the
program's (`netout`, `state`: max |diff| over max |reference|); decode,
the top-K cap and NMS of the program's netout, and track assignment from
the program's track table, against what the call returned and the table
it left (`answers`: frames or tables that differ).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, spans, traffic, weights
from portbench.drivers.common import (
    Context, Outcome, Phases, memory_peak, now, precision, program_model,
    quantile, rel_max, release, sync)
from portbench.reference import model as ref_model
from portbench.reference import serve as ref_serve
from portbench.trace import Traced

TOL = 1e-6      # boxes and scores of a returned detection, absolute


def live_threshold(netout: torch.Tensor, anchors, live: int) -> float:
    """The `live`-th best candidate score of the worst frame of a netout,
    nudged down: a threshold that leaves at least `live` candidates in
    every frame."""
    _, scores = ref_serve.decode(netout, anchors, 0.0)
    best = scores.amax(-1).reshape(-1, scores.shape[-2])
    kth = best.sort(dim=-1, descending=True).values[
        :, min(live - 1, best.shape[1] - 1)]
    return float(kth.min()) * 0.999


def program_predictor(cfg: dict, mix: dict, w, obj: float, device):
    from object_tracking_tpu_torch.inference import JointPredictor
    return JointPredictor(
        program_model(cfg, w, device), cfg['anchors'], cfg['labels'],
        obj_threshold=obj, nms_threshold=cfg['nms_threshold'],
        iou_threshold=cfg['track_gate_iou'],
        net_size=(cfg['image'], cfg['image']), max_tracks=cfg['max_tracks'],
        max_age=cfg['max_age'], device=device)


def _states(pred, batched: bool):
    if batched:
        return pred._bstate, pred._btrack_state
    return pred._state, pred._track_state


def _call(pred, clips: np.ndarray, batched: bool):
    """One call of the cell's entry; per stream, per frame, the detection
    dicts."""
    if batched:
        return pred.predict_batch(clips)
    return [pred.predict_window(clips[0])]


def run(ctx: Context) -> Outcome:
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    batched = mix['entry'] == 'predict_batch'
    b, t = mix['streams'], mix['window']
    phase = Phases(ctx.t0)
    phase('imports')
    pool = traffic.serve_pool(mix, cfg, ctx.seed)
    phase('scenes')
    with precision(cfg), torch.no_grad():
        w = weights.make(cfg, ctx.seed, dev)
        first = ref_model.joint_forward(
            w, cfg, torch.from_numpy(pool[0]).to(dev))['track']
        obj = live_threshold(first, cfg['anchors'], mix['live_candidates'])
        del first
        phase('weights_and_threshold')
        pred = (ctx.program or program_predictor)(cfg, mix, w, obj, dev)
        del w
        phase('program')
        for i in range(mix['warmup']):
            _call(pred, pool[i % len(pool)], batched)
        pred.reset_batch_state()
        pred.reset_state()
        sync(dev)
        phase('warmup')
        setup_s = now() - ctx.t0
        from object_tracking_tpu_torch.ops.cuda.nms import nms_scores
        launched = nms_scores.launches
        loop = _serve_loop(ctx, pred, pool, batched)
        launched = nms_scores.launches - launched
    peak = memory_peak(dev)
    reading = None
    if ctx.trace:
        reading = loop['traced'].reading(b * t * flops.forward_per_frame(cfg))
    kept = loop['kept']
    del pred, loop['traced']
    release(dev)
    numbers, checked = check(cfg, mix, kept, pool, ctx.seed, obj, dev)
    lat = loop['latency']
    frames = loop['calls'] * b * t
    e2e = {'setup_s': setup_s,
           'frames_per_s': frames / loop['elapsed'],
           'latency_p95_ms': quantile(lat, 0.95) * 1e3}
    lines = [{'checked_calls': checked, 'setup_phases_s': phase.took,
              'nms_launches_per_call': launched / max(loop['calls'], 1)},
             {'slowest_calls': _slowest(lat, loop['timing'], loop['gc']),
              'gc_gen2_in_window': loop['gc'].summary()}]
    if mix['loop'] == 'open':
        late = loop['late']
        lines.append({'generator_late_ms': {
            'median': quantile(late, 0.5) * 1e3,
            'p95': quantile(late, 0.95) * 1e3, 'max': max(late) * 1e3,
            'windows': len(late)}})
    return Outcome(e2e, loop['calls'], loop['failed'], numbers, peak,
                   reading, lines)


def _serve_loop(ctx: Context, pred, pool: np.ndarray, batched: bool) -> dict:
    """The measured window. Returns the calls made, the failures, every
    call's latency (from when it was due), start, end and host thread
    time, how late each open-loop call started, the checked calls'
    records and the traced part."""
    mix = ctx.traffic
    sample = set(traffic.sample_calls(ctx.seed, mix['check_calls'],
                                      mix['check_span']))
    open_loop = mix['loop'] == 'open'
    period = mix['window'] / mix['fps'] if open_loop else 0.0
    windows = int(ctx.seconds / period) if open_loop else 0
    traced = Traced(ctx.trace, mix['trace_calls'],
                    lambda tracer: spans.installed(tracer, pred.model,
                                                   serving=True))
    if ctx.trace and open_loop:
        traced.at = windows // 2
    kept: Dict[int, dict] = {}
    grabbed: List[torch.Tensor] = []
    latency, late, timing = [], [], []
    failed = calls = 0
    pauses = _GcPauses()
    gc.callbacks.append(pauses)
    start = now()
    while True:
        if open_loop:
            if calls >= max(windows, ctx.min_units) and traced.done():
                break
            due = start + calls * period
            wait = due - now()
            if wait > 0:
                time.sleep(wait)
            late.append(now() - due)
        else:
            due = now()
            if (due - start >= ctx.seconds and calls >= ctx.min_units
                    and traced.done()):
                break
            if (ctx.trace and traced.at is None
                    and due - start >= ctx.seconds / 2):
                traced.at = calls
        traced.begin(calls)
        record = calls in sample
        if record:
            rec = {'prior': _states(pred, batched)}
            hook = pred.model.register_forward_hook(
                lambda m, a, out: grabbed.append(out['track']))
        began, cpu = now(), time.thread_time()
        try:
            with traced.span('call'):
                out = _call(pred, pool[calls % len(pool)], batched)
        except Exception as err:        # a failed call counts as missing
            failed += 1
            out = err
        ended = now()
        timing.append((began, ended, time.thread_time() - cpu))
        latency.append(ended - due if not isinstance(out, Exception)
                       else float('inf'))
        if record:
            hook.remove()
            rec.update(out=out, netout=grabbed.pop() if grabbed else None,
                       post=_states(pred, batched))
            kept[calls] = rec
        calls += 1
        traced.end()
    elapsed = now() - start
    gc.callbacks.remove(pauses)
    traced.close()
    return {'calls': calls, 'failed': failed, 'latency': latency,
            'late': late, 'elapsed': elapsed, 'kept': kept,
            'traced': traced, 'timing': timing, 'gc': pauses}


class _GcPauses:
    """The interpreter's collections of its oldest generation inside the
    window, for the run's report: a host stall that no layer owns."""

    def __init__(self):
        self.spans: List[tuple] = []
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if info['generation'] != 2:
            return
        if phase == 'start':
            self._t = now()
        else:
            self.spans.append((self._t, now()))

    def within(self, lo: float, hi: float) -> float:
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.spans)

    def summary(self) -> dict:
        took = [b - a for a, b in self.spans]
        return {'count': len(took), 'max_ms': max(took, default=0.0) * 1e3,
                'total_ms': sum(took) * 1e3}


def _slowest(latency: List[float], timing: List[tuple], pauses: _GcPauses,
             count: int = 5) -> List[list]:
    """The slowest calls, for telling a stall of the run from one of the
    machine: [call, latency ms, call ms, host thread CPU ms, ms of the
    interpreter's full collections inside the call]. A call whose thread
    time falls far short of its length waited: on the device, or off
    the CPU."""
    slow = sorted(range(len(latency)), key=lambda i: -latency[i])[:count]
    return [[i, latency[i] * 1e3, (timing[i][1] - timing[i][0]) * 1e3,
             timing[i][2] * 1e3, pauses.within(*timing[i][:2]) * 1e3]
            for i in slow]


def _tables(tracks, clips: int, slots: int) -> List[dict]:
    """Per clip, a track table as the reference keeps it, from the
    program's TrackState (tensors (B, S, ...)), a list of the reference's
    tables, or None (no table yet)."""
    if tracks is None:
        return [ref_serve.empty_tracks(slots) for _ in range(clips)]
    if isinstance(tracks, list):
        return tracks
    arrays = {k: getattr(tracks, k).detach().cpu().numpy()
              for k in ('boxes', 'vel', 'labels', 'ids', 'age', 'active',
                        'next_id')}
    return [{k: (int(v[i]) if k == 'next_id' else v[i])
             for k, v in arrays.items()} for i in range(clips)]


def _same_table(a: dict, b: dict) -> bool:
    for k in ('labels', 'ids', 'age', 'active', 'next_id'):
        if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            return False
    return all(np.allclose(a[k], b[k], rtol=0, atol=TOL)
               for k in ('boxes', 'vel'))


def _same_frame(got: list, want: list) -> bool:
    if len(got) != len(want):
        return False
    for d, (label, score, box, tid) in zip(got, want):
        if (d['label'] != label or int(d['track_id']) != tid
                or abs(d['score'] - score) > TOL
                or max(abs(x - y) for x, y in zip(d['box'], box)) > TOL):
            return False
    return True


def check(cfg: dict, mix: dict, kept: Dict[int, dict], pool: np.ndarray,
          seed: int, obj: float, device):
    """The numbers that decide `correct`, over the recorded calls, and
    the indices of the calls checked."""
    numbers = {'netout': 0.0, 'state': 0.0, 'answers': 0}
    if not kept:
        numbers['answers'] = 1
        return numbers, []
    b, t, slots = mix['streams'], mix['window'], cfg['max_tracks']
    with precision(cfg), torch.no_grad():
        w = weights.make(cfg, seed, device)
        for i, rec in sorted(kept.items()):
            if isinstance(rec['out'], Exception) or rec['netout'] is None:
                numbers['answers'] += b * t
                continue
            state, tracks = rec['prior']
            frames = torch.from_numpy(pool[i % len(pool)]).to(device)
            ref = ref_model.joint_forward(w, cfg, frames, state)
            numbers['netout'] = max(numbers['netout'],
                                    rel_max(rec['netout'], ref['track']))
            post_state, post_tracks = rec['post']
            for got, want in zip(post_state, ref['state']):
                numbers['state'] = max(numbers['state'], rel_max(got, want))
            lists, tables = ref_serve.serve_clips(
                rec['netout'], _tables(tracks, b, slots), cfg, obj)
            after = _tables(post_tracks, b, slots)
            for clip in range(b):
                numbers['answers'] += sum(
                    not _same_frame(g, wf)
                    for g, wf in zip(rec['out'][clip], lists[clip]))
                numbers['answers'] += not _same_table(tables[clip],
                                                      after[clip])
    return numbers, sorted(kept)
