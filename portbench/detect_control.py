"""The control of a detection cell's check (`drivers/detect.py`): the
reference put in the program's place and computed one precision below
the configuration's (float32 → TF32 in matmuls and convolutions), judged
by the same check. It has to come out as not correct. The benchmark's
own runs never run it; `control.py` does the same for the other cells.

    python -m portbench.detect_control --workload <name> --seeds 1 2 3

prints one JSON line per seed with the numbers the check compared. Needs
the card (TF32 exists only there).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch import nn

from portbench import cells, models, traffic
from portbench.drivers.common import precision


class _Forward(nn.Module):
    """The reference's forward as a module, so that the driver's forward
    hook reads its heads as it reads the program's."""

    def __init__(self, cfg: dict, w: dict):
        super().__init__()
        self.cfg, self.w = cfg, w

    def forward(self, images, train=False):
        return {'heads': models.kind(self.cfg).reference_heads(
            self.w, self.cfg, images)}


class ReferenceDetector:
    """`CfgDetector.detect_images` served by the reference in `lower`
    precision: the same outputs, label names and all."""

    def __init__(self, cfg: dict, text: str, w: dict, obj: float, device,
                 lower: bool = True):
        self.cfg, self.obj, self.device, self.lower = cfg, obj, device, lower
        self.module = _Forward(cfg, w)

    def detect_images(self, images):
        cfg = self.cfg
        with precision(cfg, self.lower), torch.no_grad():
            heads = self.module(torch.as_tensor(images,
                                                device=self.device))['heads']
        found = models.kind(cfg).reference_detections(heads, cfg, self.obj)
        return [[(cfg['labels'][c], s, box) for c, s, box in frame]
                for frame in found]


def control(cell, seed: int, device) -> dict:
    """The control's numbers: the window runs until the last checked
    call, served by the reference in TF32."""
    from portbench.run import run_cell
    last = max(traffic.sample_calls(
        seed, cell.traffic['check_calls'], cell.traffic['check_span']))
    out = run_cell(cell, seed, 0.0, False, device, time.perf_counter(),
                   program=ReferenceDetector, min_units=last + 1)
    return out['result']['checks']


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('portbench.detect_control: no CUDA device (TF32 exists only '
              'on the card)', file=sys.stderr)
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
