"""Checkpoints of a TrainState over `torch.save`.

Port of `object_tracking_tpu/training/checkpoint.py` (orbax there). One
file per saved step, `<dir>/ckpt_<step>.pt`, holding the train step, the
parameters, the BatchNorm statistics and the optimizer state, all on the
host; its metrics go beside it in `ckpt_<step>.json`. A save writes a
temporary file and `os.replace`s it, so a crash never leaves a torn
checkpoint under a step's name.

The policies are orbax's: at most `max_to_keep` checkpoints stay, the
latest ones, or with `best_mode` the ones with the lowest 'val_loss' (and
every one saved without metrics); a save at a step not above the latest
saved step is skipped.

In a multi-rank run every rank calls `save` and `restore`: only rank 0
writes, every rank restores. A pipelined stack's parameters and their
Adam moments are gathered into the dense (L, …) layout on save (so that
a checkpoint of any layout restores into the dense model) and each stage
takes its slice back on restore.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import torch

from object_tracking_tpu_torch.parallel.mesh import barrier, is_writer
from object_tracking_tpu_torch.parallel.pipeline import (
    gather_stages, local_stage, stage_sharded_parameters)

_NAME = re.compile(r'ckpt_(\d+)\.pt$')


def _map_moments(model, optimizer_state: Dict, staged: Dict, fn) -> None:
    """Apply `fn` ({name: tensor}, staged) → {name: tensor} to the Adam
    moments of the stage-sharded parameters, in place; the optimizer's
    state is keyed by the parameters' order in the model."""
    for i, (name, _) in enumerate(model.named_parameters()):
        moments = optimizer_state['state'].get(i)
        if name not in staged or moments is None:
            continue
        # a new dict: state_dict() shares the live optimizer's
        optimizer_state['state'][i] = dict(moments, **{
            key: fn({name: moments[key]}, {name: staged[name]})[name]
            for key in ('exp_avg', 'exp_avg_sq')})


def _atomic_write(path: str, write) -> None:
    tmp = path + '.tmp'
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Save and restore the serialisable part of a TrainState (step,
    params, batch stats, optimizer state); the module and optimizer
    objects come from the caller's template."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 best_mode: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_mode = best_mode

    def _path(self, step: int, ext: str = 'pt') -> str:
        return os.path.join(self.directory, f'ckpt_{step}.{ext}')

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metrics(self, step: int) -> Optional[Dict]:
        path = self._path(step, 'json')
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f) or None

    def save(self, step: int, state, metrics: Optional[dict] = None) -> bool:
        """Save `state` under `step`; False (and nothing written) when
        `step` is not above the latest saved step."""
        latest = self.latest_step()
        # Every rank reads the directory before rank 0 writes to it, so
        # that all take the same branch (and the barrier below) alike.
        barrier()
        if latest is not None and step <= latest:
            return False
        params = {k: v.detach() for k, v in state.params.items()}
        optimizer = state.optimizer.state_dict()
        staged = stage_sharded_parameters(state.model)
        if staged:
            params = gather_stages(params, staged)
            _map_moments(state.model, optimizer, staged, gather_stages)
        if is_writer():
            payload = {
                'step': int(state.step),
                'params': {k: v.cpu() for k, v in params.items()},
                'batch_stats': {k: v.detach().cpu()
                                for k, v in state.batch_stats.items()},
                'optimizer': optimizer}
            scalars = {k: float(v) for k, v in (metrics or {}).items()}

            def write_json(path):
                with open(path, 'w') as f:
                    json.dump(scalars, f)
            _atomic_write(self._path(step, 'json'), write_json)
            _atomic_write(self._path(step), lambda p: torch.save(payload, p))
            self._remove_old()
        barrier()
        return True

    def _remove_old(self) -> None:
        steps = self.all_steps()
        if self.best_mode:
            rated = [s for s in steps if self._metrics(s) is not None]
            rated.sort(key=lambda s: self._metrics(s)['val_loss'])
            keep = set(rated[:self.max_to_keep]) | (set(steps) - set(rated))
        else:
            keep = set(steps[-self.max_to_keep:])
        for s in steps:
            if s not in keep:
                for ext in ('pt', 'json'):
                    if os.path.exists(self._path(s, ext)):
                        os.remove(self._path(s, ext))

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def restore(self, state_template, step: Optional[int] = None,
                variables_only: bool = False):
        """Restore into the template TrainState, in place; returns
        (state, step), or (template, None) when there is no checkpoint.

        `variables_only=True` restores the step, parameters and batch
        statistics and keeps the template's optimizer state: an eval state
        built with any optimizer takes a checkpoint trained with another.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            return state_template, None
        payload = torch.load(self._path(step), map_location='cpu',
                             weights_only=True)
        params = payload['params']
        staged = stage_sharded_parameters(state_template.model)
        if staged:
            params = local_stage(params, staged)
            _map_moments(state_template.model, payload['optimizer'], staged,
                         local_stage)
        state_template.model.load_state_dict(
            {**params, **payload['batch_stats']}, strict=True)
        if not variables_only:
            state_template.optimizer.load_state_dict(payload['optimizer'])
        state_template.step = int(payload['step'])
        return state_template, step

    def close(self) -> None:
        """Nothing held open."""
