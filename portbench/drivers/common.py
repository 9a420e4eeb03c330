"""What every driver shares: the run's context, the outcome it returns,
the precision the configuration states (`precisions/<name>.json`), and
the program's model (`models/<builder>.py`) built from the benchmark's
weights."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import models
from portbench.cells import HERE


@dataclasses.dataclass
class Context:
    """One run of one cell. `program` overrides how the system under test
    is built (the control and the tests put other systems in its place);
    `min_units` makes a closed loop run at least that many calls or steps
    (the tests, the control)."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    program: Optional[Callable] = None
    min_units: int = 0


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int
    reading: Optional[dict] = None
    lines: List[dict] = dataclasses.field(default_factory=list)


def precision_spec(name: str) -> dict:
    """`precisions/<name>.json`: the compute dtype, whether matmuls and
    convolutions may use TF32, and the precision named as its control
    (the next one below)."""
    with open(HERE / 'precisions' / f'{name}.json') as f:
        return json.load(f)


@contextlib.contextmanager
def precision(cfg: dict, lower: bool = False):
    """The precision the configuration states (its TF32 flags) for the
    duration of the block, which gets its compute dtype; `lower` takes
    the control's precision instead."""
    spec = precision_spec(cfg['precision'])
    if lower:
        spec = precision_spec(spec['control'])
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = spec['allow_tf32']
    torch.backends.cudnn.allow_tf32 = spec['allow_tf32']
    try:
        yield getattr(torch, spec['dtype'])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def program_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The program's model of the configuration (its kind's `program`, in
    the compute dtype of its precision), built without an init and
    loaded with `weights`."""
    dtype = getattr(torch, precision_spec(cfg['precision'])['dtype'])
    with torch.device('meta'):
        model = models.kind(cfg).program(cfg, dtype)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == 'cuda':
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


class Phases:
    """Seconds of each phase of set-up, for the run's report: what a later
    change to the program could shorten."""

    def __init__(self, t0: float):
        self.last, self.took = t0, {}

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        self.took[name], self.last = t - self.last, t


def quantile(values: List[float], q: float) -> float:
    return float(np.quantile(np.asarray(values, np.float64), q))


def now() -> float:
    return time.perf_counter()
