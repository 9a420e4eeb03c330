"""Profiling and tracing.

Port of `object_tracking_tpu/utils/profiling.py`:

- `profile_trace(log_dir)`: `torch.profiler.profile` over the block, with
  CPU activities and, where a card is present, CUDA ones; the trace is
  written into `log_dir` as a Chrome trace (`<host>_<pid>.pt.trace.json`,
  which Perfetto and TensorBoard's profile plugin open);
- `annotate(name)`: a named range (`torch.profiler.record_function`), so
  that host spans and the kernels launched inside group under `name`;
- `device_memory_stats()`: `torch.cuda.memory_stats` of every local card,
  and [] on a machine without one;
- `StepTimer`: steps/s and examples/s, excluding the first (warm-up)
  step.

The JAX module's `enable_compile_cache` has no counterpart: the port
compiles nothing ahead of time but its CUDA kernels, which
`ops/cuda/_build.py` already caches by a hash of their sources.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Iterator, List, Optional

import torch


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


def annotate(name: str):
    """Named trace range (a context manager)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> List[Dict[str, float]]:
    """Per-card memory statistics (bytes and counts, as
    `torch.cuda.memory_stats` gives them); [] without a card."""
    if not torch.cuda.is_available():
        return []
    return [dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())]


class StepTimer:
    """Throughput meter that ignores the first (warm-up) step.

    >>> timer = StepTimer(batch_size=8)
    >>> for batch in batches:
    ...     state, _ = step(state, batch)
    ...     timer.tick()
    >>> timer.steps_per_sec(), timer.examples_per_sec()
    """

    def __init__(self, batch_size: int = 1, skip_first: int = 1):
        self.batch_size = batch_size
        self.skip_first = skip_first
        self._count = 0
        self._t0: Optional[float] = None
        self._timed_steps = 0

    def tick(self) -> None:
        self._count += 1
        if self._count == self.skip_first:
            self._t0 = time.perf_counter()
        elif self._count > self.skip_first:
            self._timed_steps += 1

    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        return time.perf_counter() - self._t0

    def steps_per_sec(self) -> float:
        dt = self.elapsed()
        return self._timed_steps / dt if dt > 0 else 0.0

    def examples_per_sec(self) -> float:
        return self.steps_per_sec() * self.batch_size
