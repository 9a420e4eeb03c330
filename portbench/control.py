"""The control of each cell's check: the reference put in the program's
place and computed one precision below the configuration's (float32 →
TF32 in matmuls and convolutions), judged by the same check. It has to
come out as not correct. The benchmark's own runs never run it.

    python -m portbench.control --workload <name> --seeds 1 2 3

prints one JSON line per seed with the numbers the check compared. Needs
the card (TF32 exists only there); `tests/test_portbench_card.py` runs
it at the cells' own sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch import nn

from portbench import cells, traffic
from portbench.drivers import train
from portbench.drivers.common import precision
from portbench.reference import model as ref_model
from portbench.reference import serve as ref_serve


class _Forward(nn.Module):
    """The reference's joint forward as a module, so that the benchmark's
    forward hook reads its netout as it reads the program's."""

    def __init__(self, cfg: dict, w: dict):
        super().__init__()
        self.cfg, self.w = cfg, w

    def forward(self, images, state):
        return ref_model.joint_forward(self.w, self.cfg, images, state)


class ReferencePredictor:
    """JointPredictor's calls served by the reference in `lower`
    precision: the same carried state and outputs."""

    def __init__(self, cfg: dict, mix: dict, w: dict, obj: float, device,
                 lower: bool = True):
        self.cfg, self.obj, self.device, self.lower = cfg, obj, device, lower
        self.model = _Forward(cfg, w)
        self.reset_state()
        self.reset_batch_state()

    def reset_state(self):
        self._state, self._track_state = None, None

    def reset_batch_state(self):
        self._bstate, self._btrack_state = None, None

    def _run(self, clips: np.ndarray, state, tables):
        cfg = self.cfg
        b = clips.shape[0]
        if tables is None:
            tables = [ref_serve.empty_tracks(cfg['max_tracks'])
                      for _ in range(b)]
        with precision(cfg, self.lower), torch.no_grad():
            out = self.model(torch.from_numpy(clips).to(self.device), state)
        frames, new_tables = ref_serve.serve_clips(out['track'], tables,
                                                   cfg, self.obj)
        results = [[[{'label': l, 'score': s, 'box': bx, 'track_id': i}
                     for l, s, bx, i in frame] for frame in clip]
                   for clip in frames]
        return results, out['state'], new_tables

    def predict_batch(self, clips):
        out, self._bstate, self._btrack_state = self._run(
            np.asarray(clips, np.float32), self._bstate, self._btrack_state)
        return out

    def predict_window(self, frames):
        out, self._state, self._track_state = self._run(
            np.asarray(frames, np.float32)[None], self._state,
            self._track_state)
        return out[0]


def serve_control(cell, seed: int, device) -> dict:
    """The control's numbers on a serving cell: the window runs until the
    last checked call, served by the reference in TF32."""
    from portbench.run import run_cell
    last = max(traffic.sample_calls(
        seed, cell.traffic['check_calls'], cell.traffic['check_span']))
    out = run_cell(cell, seed, 0.0, False, device, time.perf_counter(),
                   program=ReferencePredictor, min_units=last + 1)
    return out['result']['checks']


def train_control(cell, seed: int, device) -> dict:
    """The control's numbers on a training cell: the reference's first
    steps in TF32 against its own in float32."""
    cfg, mix = cell.config, cell.traffic
    pool = train.train_pool(cfg, mix, seed)
    lower = train.reference(cfg, mix, pool, seed, device, lower=True)
    ref = train.reference(cfg, mix, pool, seed, device)
    numbers = train.compare(lower, ref)
    return {name: {'value': numbers[name], 'limit': limit}
            for name, limit in cell.limits.items()}


def control(cell, seed: int, device) -> dict:
    if cell.traffic['driver'] == 'serve':
        return serve_control(cell, seed, device)
    return train_control(cell, seed, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('portbench.control: no CUDA device (TF32 exists only on the '
              'card)', file=sys.stderr)
        return 2
    cell = cells.cell(args.workload)
    device = torch.device('cuda', 0)
    for seed in args.seeds:
        checks = control(cell, seed, device)
        failed = [n for n, c in checks.items() if not c['value'] <= c['limit']]
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'checks': checks, 'fails': failed}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
