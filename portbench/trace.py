"""The traced part of a `--trace 1` run and its reduction to readings.

`Traced` times a fixed number of calls or steps in the middle of the
window under the benchmark's spans alone (host time), then profiles as
many more with torch.profiler (CPU and CUDA activity, kept in memory,
never written to disk). Spans come from the benchmark's own files:
`Tracer.span()` adds its host time and, under the profiler, opens a
profiler range; `spans.py` installs module hooks and wrappers that call
it. `reduce()` turns the profile into the plain numbers that the
per-layer readers (`portbench/metrics/`) read:

- device kernels (and copies) by name, and the union of their intervals
  (the device's busy time);
- the device time of the kernels launched inside each span (by the
  profiler's op tree), and the BatchNorm kernels of forward and backward
  (backward nodes matched by autograd sequence number);
- the device time of convolution kernels (those of aten convolution ops,
  forward and backward);
- host time per span (under the profiler), the traced window, the
  calls' spans;
- the idle gaps of the device, by the innermost span the host was in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

PREFIX = 'portbench.'
BN_SPAN = PREFIX + 'batch_norm'
CONV_OPS = ('aten::cudnn_convolution', 'aten::convolution_backward',
            'aten::_convolution', 'aten::convolution', 'aten::conv2d',
            'aten::cudnn_convolution_backward')


class Tracer:
    """Spans, and with `profile` the profiler, of one part of a traced
    run. Inactive until `start`, so that spans cost nothing outside it.
    Without `profile` a span only adds its host time."""

    def __init__(self, profile: bool = True):
        self.profile = profile
        self.active = False
        self.host_s: Dict[str, float] = defaultdict(float)
        self.prof = None
        self.window_s = 0.0
        self.units = 0              # calls or steps traced
        self.notes: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        start = time.perf_counter()
        if self.profile:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.host_s[name] += time.perf_counter() - start

    def start(self) -> None:
        _sync()
        if self.profile:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.start()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.window_s = time.perf_counter() - self._t0
        self.active = False
        if self.profile:
            self.prof.stop()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Traced:
    """The traced part of a `--trace 1` run, from the unit (call or step)
    `at` in the middle of the window: `n` units under the spans alone,
    timed by the host's clock, which give the host-time and mfu readings
    free of the profiler's own cost; then the next `n` under the profiler
    as well, which give the device readings. The profiler is first
    started only after the timed part: one start and stop of it left
    later launch-bound calls slower (an H100's live calls: 59-66 ms
    before, 80-83 ms after). `install(tracer)` is the
    context in which the spans report to `tracer`. Inert unless
    `enabled`."""

    def __init__(self, enabled: bool, n: int, install):
        self.enabled, self.n, self.install = enabled, n, install
        self.timer, self.profiled = Tracer(profile=False), Tracer()
        self.at = None
        self._hooks = None

    def begin(self, unit: int) -> None:
        """Before unit `unit`: open a part where one starts."""
        if self.at is None:
            return
        for offset, tracer in ((0, self.timer), (self.n, self.profiled)):
            if unit == self.at + offset:
                if tracer.profile:
                    warm_profiler()
                self._hooks = self.install(tracer)
                self._hooks.__enter__()
                tracer.start()

    def span(self, name: str):
        for tracer in (self.timer, self.profiled):
            if tracer.active:
                return tracer.span(name)
        return contextlib.nullcontext()

    def end(self) -> None:
        """After a unit: count it, and close its part after the n-th."""
        for tracer in (self.timer, self.profiled):
            if tracer.active:
                tracer.units += 1
                if tracer.units == self.n:
                    self._close(tracer)

    def done(self) -> bool:
        return not self.enabled or self.profiled.units >= self.n

    def close(self) -> None:
        for tracer in (self.timer, self.profiled):
            if tracer.active:
                self._close(tracer)

    def _close(self, tracer: Tracer) -> None:
        tracer.stop()
        self._hooks.__exit__(None, None, None)

    def reading(self, flops_per_unit: float) -> dict:
        """The profiled part reduced (`reduce`), with the operations of its
        units (`flops`), and the timed part's units, window, spans' host
        seconds and operations (`host`)."""
        out = reduce(self.profiled)
        out['flops'] = self.profiled.units * flops_per_unit
        out['host'] = {'units': self.timer.units,
                       'window_s': self.timer.window_s,
                       'span_s': dict(self.timer.host_s),
                       'flops': self.timer.units * flops_per_unit}
        return out


def warm_profiler() -> None:
    """Start and stop the profiler once around a tiny op, so that its own
    first start does not fall inside the profiled calls."""
    t = Tracer()
    t.start()
    x = torch.ones(8, device='cuda' if torch.cuda.is_available() else 'cpu')
    (x + 1).sum().item()
    t.stop()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _covered(union, lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union)


def _chain(evt):
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def reduce(tracer: Tracer) -> dict:
    """The profile of `tracer` as plain numbers; times in seconds."""
    from torch.autograd import DeviceType
    events = tracer.prof.events()
    kernels, spans, cpu_ops = [], [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and hi > lo:
                kernels.append((e.name, lo, hi))
        elif e.name.startswith(PREFIX):
            spans.append((e.name[len(PREFIX):], lo, hi))
        elif e.cpu_parent is None:
            cpu_ops.append((e.name, lo, hi))
    by_name: Dict[str, float] = defaultdict(float)
    for name, lo, hi in kernels:
        by_name[name] += (hi - lo) / 1e6
    union = _union([(lo, hi) for _, lo, hi in kernels])

    in_span: Dict[str, float] = defaultdict(float)
    conv_s = 0.0
    bn_forward = {e.sequence_nr for e in events
                  if e.sequence_nr >= 0 and e.device_type == DeviceType.CPU
                  and any(a.name == BN_SPAN for a in _chain(e))}
    bn_s = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        took = sum(k.duration for k in e.kernels) / 1e6
        names = [a.name for a in _chain(e)]
        for n in set(names):
            if n.startswith(PREFIX):
                in_span[n[len(PREFIX):]] += took
        if any(n in CONV_OPS for n in names):
            conv_s += took
        if BN_SPAN in names or any(
                a.name.startswith('autograd::engine::evaluate_function')
                and a.sequence_nr in bn_forward for a in _chain(e)):
            bn_s += took

    calls = [(lo, hi) for name, lo, hi in spans if name == 'call']
    gaps: Dict[str, float] = defaultdict(float)
    if union:
        edges = [(union[i][1], union[i + 1][0])
                 for i in range(len(union) - 1)]
        for lo, hi in edges:
            mid = (lo + hi) / 2
            inner = [(s_lo, name) for name, s_lo, s_hi in spans
                     if s_lo <= mid <= s_hi]
            if inner:
                where = max(inner)[1]
            else:
                tops = [name for name, s_lo, s_hi in cpu_ops
                        if s_lo <= mid <= s_hi]
                where = tops[0] if tops else 'host (no op)'
            gaps[where] += (hi - lo) / 1e6
    return {
        'window_s': tracer.window_s,
        'units': tracer.units,
        'busy_s': sum(hi - lo for lo, hi in union) / 1e6,
        'call_s': sum(hi - lo for lo, hi in calls) / 1e6,
        'busy_in_calls_s': sum(_covered(union, lo, hi)
                               for lo, hi in calls) / 1e6,
        'kernel_s': dict(by_name),
        'span_device_s': dict(in_span),
        'span_host_s': dict(tracer.host_s),
        'conv_s': conv_s,
        'batch_norm_s': bn_s,
        'gaps_s': dict(gaps),
        'notes': tracer.notes,
    }


def kernel_seconds(reading: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds `fragment`."""
    return sum(s for name, s in reading['kernel_s'].items()
               if fragment in name)


def breakdown(reading: dict) -> dict:
    """The ten costliest device operations and the ten longest idle gaps
    by what the host was doing, in seconds over the traced window."""
    ops = sorted(reading['kernel_s'].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(reading['gaps_s'].items(), key=lambda kv: -kv[1])[:10]
    return {'device_ops': [[name[:120], s] for name, s in ops],
            'idle_gaps': [[name[:120], s] for name, s in gaps]}
