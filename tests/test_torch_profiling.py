"""The port's profiling utilities on the CPU (`utils/profiling.py`, port
of `object_tracking_tpu/utils/profiling.py`, which has no test of its
own): a trace file is written with the annotated range in it, the
memory statistics are empty without a card, and StepTimer's arithmetic
is exact on a fake clock."""

import json
import os

import pytest
import torch

from object_tracking_tpu_torch.utils import profiling
from object_tracking_tpu_torch.utils.profiling import (StepTimer, annotate,
                                                       device_memory_stats,
                                                       profile_trace)


def test_profile_trace_writes_a_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / 'trace'
    with profile_trace(str(log_dir)):
        with annotate('ott_step'):
            torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                                       torch.ones(4, 3, 3, 3))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    with open(log_dir / files[0]) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    assert {'ott_step', 'aten::conv2d'} <= names


def test_device_memory_stats_empty_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert device_memory_stats() == []


def test_step_timer_skips_the_first_step(monkeypatch):
    clock = iter([10.0, 14.0, 14.0, 14.0])
    monkeypatch.setattr(profiling.time, 'perf_counter', lambda: next(clock))
    timer = StepTimer(batch_size=8)
    assert timer.elapsed() == 0.0 and timer.steps_per_sec() == 0.0
    for _ in range(5):          # the first starts the clock at 10 s
        timer.tick()
    assert timer.elapsed() == 4.0                # 14 s
    assert timer.steps_per_sec() == pytest.approx(1.0)      # 4 steps, 4 s
    assert timer.examples_per_sec() == pytest.approx(8.0)


def test_step_timer_skip_first_counts(monkeypatch):
    monkeypatch.setattr(profiling.time, 'perf_counter', lambda: 3.0)
    timer = StepTimer(skip_first=3)
    timer.tick()
    timer.tick()
    assert timer.elapsed() == 0.0                # clock not started
    timer.tick()
    assert timer.elapsed() == 0.0 and timer.steps_per_sec() == 0.0
