"""The control of a two-stage detection cell's check (`drivers/rcnn.py`):
the reference put in the program's place, its trunk, RPN and head
computed one precision below the configuration's (float32 → TF32 in
matmuls and convolutions), judged by the same check. It has to come out
as not correct. The benchmark's own runs never run it.

    python -m portbench.rcnn_control --workload <name> --seeds 1 2 3

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


class _Forward(nn.Module):
    """The reference's stages as a module, so that the driver's forward
    hook reads its outputs as it reads the program's: the trunk and RPN
    and the head in `lower` precision, the proposal layer as the
    reference computes it."""

    def __init__(self, cfg: dict, w: dict, lower: bool):
        super().__init__()
        self.cfg, self.w, self.lower = cfg, w, lower

    def forward(self, images):
        cfg, kind = self.cfg, models.kind(self.cfg)
        out = kind.reference_forward(self.w, cfg, images, self.lower)
        props = kind.reference_proposals(out['rpn_fg'], out['rpn_deltas'],
                                         cfg)
        n, r = images.shape[0], cfg['post_nms_top_n']
        rois = images.new_zeros((n, r, 4))
        valid = torch.zeros((n, r), dtype=torch.bool, device=images.device)
        for i, p in enumerate(props):
            rois[i, :len(p)] = p
            valid[i, :len(p)] = True
        cls, box = kind.reference_head(self.w, cfg, out['conv5_3'], rois,
                                       self.lower)
        return {**out, 'rois': rois, 'roi_valid': valid, 'cls_prob': cls,
                'bbox_pred': box}


class ReferenceDetector:
    """`FasterRCNNDetector.detect_images` served by the reference: the
    same outputs, label names and all. Calls outside `only` (the calls
    the check reads) return no detections without computing: the
    reference's proposal layer loops on the host, and the control's time
    is not measured."""

    def __init__(self, cfg: dict, w: dict, device, lower: bool = True,
                 only=None):
        self.cfg, self.device, self.only = cfg, device, only
        self.module = _Forward(cfg, w, lower)
        self.calls = 0

    def detect_images(self, images):
        cfg = self.cfg
        call, self.calls = self.calls, self.calls + 1
        if self.only is not None and call not in self.only:
            return [[] for _ in range(len(images))]
        with torch.no_grad():
            out = self.module(torch.as_tensor(images, device=self.device))
        found = models.kind(cfg).reference_detections(out, cfg)
        return [[(cfg['labels'][c], s, box) for c, s, box in frame]
                for frame in found]


def control(cell, seed: int, device) -> dict:
    """The control's numbers: the window runs until the last checked
    call, served by the reference in TF32."""
    from portbench.run import run_cell
    mix = cell.traffic
    sample = traffic.sample_calls(seed, mix['check_calls'],
                                  mix['check_span'])
    # the detector counts the warm-up calls before the window's
    only = {mix['warmup'] + i for i in sample}
    out = run_cell(cell, seed, 0.0, False, device, time.perf_counter(),
                   program=lambda cfg, w, dev: ReferenceDetector(
                       cfg, w, dev, only=only),
                   min_units=max(sample) + 1)
    return out['result']['checks']


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('portbench.rcnn_control: no CUDA device (TF32 exists only on '
              'the card)', file=sys.stderr)
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
