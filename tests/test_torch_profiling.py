"""The port's profiling utilities on the CPU (`utils/profiling.py`, port
of `object_tracking_tpu/utils/profiling.py`, which has no test of its
own): a trace file is written with the program's span in it as the range
`ott.<name>`, and the memory statistics are empty without a card. The
spans and counters themselves are tested in test_torch_tracing.py."""

import json
import os

import torch

from object_tracking_tpu_torch.utils.profiling import (device_memory_stats,
                                                       profile_trace, span)


def test_profile_trace_writes_a_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / 'trace'
    with profile_trace(str(log_dir)):
        with span('step'):
            torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                                       torch.ones(4, 3, 3, 3))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    with open(log_dir / files[0]) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    assert {'ott.step', 'aten::conv2d'} <= names


def test_device_memory_stats_empty_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert device_memory_stats() == []

