"""Scalar metric logging: JSONL and, where installed, TensorBoard.

Port of `object_tracking_tpu/training/metrics.py`: numbered run dirs
(logs/<prefix>_<n>) and a logger that writes one JSON line per record and,
when tensorboardX or torch's TensorBoard writer can be imported, event
files. The metrics reach it as host floats (the fit loop pulls them once
per epoch).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def numbered_run_dir(base: str, prefix: str = 'run') -> str:
    """Reference behavior: logs/<prefix>_<n> with n = #existing + 1
    (MultiObjDetTracker.py:268-269)."""
    os.makedirs(base, exist_ok=True)
    n = len([d for d in os.listdir(base)
             if os.path.isdir(os.path.join(base, d))]) + 1
    path = os.path.join(base, f'{prefix}_{n}')
    os.makedirs(path, exist_ok=True)
    return path


def _summary_writer(log_dir: str):
    """A TensorBoard writer from tensorboardX or torch.utils.tensorboard,
    or None when neither package is installed: a missing writer changes no
    result, only the event files are not written."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir)


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')
        self._tb = None
        if use_tensorboard:
            self._tb = _summary_writer(log_dir)

    def log(self, step: int, scalars: Dict[str, float],
            prefix: Optional[str] = None) -> None:
        scalars = {
            (f'{prefix}/{k}' if prefix else k): float(v)
            for k, v in scalars.items()}
        rec = {'step': int(step), 'time': time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
