"""Profiling and tracing.

Port of `object_tracking_tpu/utils/profiling.py`, with the program's own
spans and counters:

- `profile_trace(log_dir)`: `torch.profiler.profile` over the block, with
  CPU activities and, where a card is present, CUDA ones; the trace is
  written into `log_dir` as a Chrome trace (`<host>_<pid>.pt.trace.json`,
  which Perfetto and TensorBoard's profile plugin open);
- `span(name)`: a named span of the program (a context manager). Under a
  running profiler it is the range `ott.<name>`
  (`torch.profiler.record_function`), so that the kernels launched inside
  group under it on the device trace's clock; with a `Recorder` attached
  it also records its name, parent and host start and end. With neither,
  it is one shared null context: no kernel, no allocation;
- `count(name, value)`: adds a host int, or the device tensor that a
  zero-argument callable returns, to the attached `Recorder`. Without one
  the callable is never called, so no device reduction is launched;
- `Recorder` and `recording(recorder)`: spans and counters kept in memory
  while the recorder is attached to the calling thread's context;
- `device_memory_stats()`: `torch.cuda.memory_stats` of every local card,
  and [] on a machine without one.

The spans are placed in `inference.py` (`predict` and its six parts), in
`models/darknet_cfg.py::CfgDetector.detect_images` (`detect` and its five
parts), in `models/faster_rcnn.py` (`detect` and the same five parts, with
`detect.proposals`, `detect.roi_pool` and `detect.box_head` inside
`detect.forward`), in `training/steps.py` (`train` and its parts) and the
counters in `ops/matching.py::assign_tracks` (`assign.frames`,
`assign.kernel_frames`, `assign.steps`, `assign.matches`),
`models/darknet_cfg.py::decode_cfg_outputs` (`detect.candidates`,
`detect.capped`), `ops/proposals.py` (`rcnn.pre_nms`, `rcnn.proposals`,
`rcnn.short_images`, `rcnn.detections`, `rcnn.capped`) and
`ops/cuda/roi_pool.py` (`roi_pool.rois`, `roi_pool.kernel_rois`).

The JAX module's `enable_compile_cache` has no counterpart: the port
compiles nothing ahead of time but its CUDA kernels, which
`ops/cuda/_build.py` already caches by a hash of their sources.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import socket
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Union

import torch

PREFIX = 'ott.'         # of the profiler ranges that `span` opens

_attached: contextvars.ContextVar[Optional['Recorder']] = \
    contextvars.ContextVar('ott_recorder', default=None)
_profiler_on = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host, and the card when there is one) and write
    its trace into `log_dir`; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f'{socket.gethostname()}_{os.getpid()}.pt.trace.json'))


@dataclasses.dataclass
class SpanRecord:
    """One recorded span. `index` is its place in `Recorder.spans`;
    `parent` the index of the span it opened in (None for a root); `root`
    the index of its root, which every span of one call shares; times are
    `time.perf_counter_ns()` (`end_ns` None while open)."""
    index: int
    name: str
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: Optional[int] = None


class Recorder:
    """Spans and counters of the program, in memory, while attached by
    `recording`. Open spans nest on one stack, so a recorder serves the
    one thread it was attached in. Device counts stay on their device,
    summed there with no sync, until `reading()` reads them once."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self._open: List[int] = []
        self._host: Dict[str, int] = defaultdict(int)
        self._device: Dict[str, torch.Tensor] = {}

    def open(self, name: str) -> int:
        parent = self._open[-1] if self._open else None
        index = len(self.spans)
        root = index if parent is None else self.spans[parent].root
        self.spans.append(SpanRecord(index, name, parent, root,
                                     time.perf_counter_ns()))
        self._open.append(index)
        return index

    def close(self, index: int) -> None:
        self.spans[index].end_ns = time.perf_counter_ns()
        self._open.pop()

    def add(self, name: str,
            value: Union[int, Callable[[], torch.Tensor]]) -> None:
        if not callable(value):
            self._host[name] += int(value)
            return
        value = value().detach()
        held = self._device.get(name)
        self._device[name] = value.clone() if held is None else held + value

    def reading(self) -> dict:
        """{'spans': [SpanRecord, ...] closed, in opening order, 'host_s'
        and 'self_s': seconds per span name (self: the duration less
        what its child spans cover), 'counters': name -> int}. Reads each
        device counter (a sync): call it after the recorded work."""
        closed = [s for s in self.spans if s.end_ns is not None]
        children_ns: Dict[int, int] = defaultdict(int)
        for s in closed:
            if s.parent is not None:
                children_ns[s.parent] += s.end_ns - s.start_ns
        host_s: Dict[str, float] = defaultdict(float)
        self_s: Dict[str, float] = defaultdict(float)
        for s in closed:
            took = s.end_ns - s.start_ns
            host_s[s.name] += took / 1e9
            self_s[s.name] += (took - children_ns[s.index]) / 1e9
        counters = dict(self._host)
        for name, value in self._device.items():
            counters[name] = counters.get(name, 0) + int(value.item())
        return {'spans': closed, 'host_s': dict(host_s),
                'self_s': dict(self_s), 'counters': counters}


@contextlib.contextmanager
def recording(recorder: Recorder) -> Iterator[Recorder]:
    """Attach `recorder` to this thread's context for the block."""
    token = _attached.set(recorder)
    try:
        yield recorder
    finally:
        _attached.reset(token)


class _Span:
    __slots__ = ('name', 'recorder', 'range', 'index')

    def __init__(self, name: str, recorder: Optional[Recorder]):
        self.name, self.recorder, self.range = name, recorder, None

    def __enter__(self):
        if _profiler_on():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        if self.recorder is not None:
            self.index = self.recorder.open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self.recorder is not None:
            self.recorder.close(self.index)
        if self.range is not None:
            self.range.__exit__(*exc)


def span(name: str):
    """The program's span `name` (a context manager): a profiler range
    `ott.<name>` under a running profiler, a record in the attached
    `Recorder`, or, with neither, a shared null context."""
    recorder = _attached.get()
    if recorder is None and not _profiler_on():
        return _NULL
    return _Span(name, recorder)


def count(name: str, value: Union[int, Callable[[], torch.Tensor]]) -> None:
    """Add `value` (a host int, or a zero-argument callable returning a
    device tensor, called only when a `Recorder` is attached) to the
    counter `name` of the attached recorder; nothing without one."""
    recorder = _attached.get()
    if recorder is not None:
        recorder.add(name, value)


def device_memory_stats() -> List[Dict[str, float]]:
    """Per-card memory statistics (bytes and counts, as
    `torch.cuda.memory_stats` gives them); [] without a card."""
    if not torch.cuda.is_available():
        return []
    return [dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())]
