"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
tests: 64x64 images, an eighth of every width, two streams or windows."""

import time

import torch

from portbench import cells
from portbench.run import run_cell


def cell(name: str):
    c = cells.cell(name)
    c.config.update(image=64, width_div=8)
    if 'convlstm_features' in c.config:
        c.config['convlstm_features'] = 32
    if c.traffic['driver'] == 'serve':
        c.traffic.update(streams=min(c.traffic['streams'], 2), pool=3,
                         check_span=6, check_calls=2, live_candidates=8,
                         warmup=1, trace_calls=2)
        if c.traffic['loop'] == 'open':
            c.traffic['fps'] = 400
    else:
        c.traffic.update(batch=2, pool=4, trace_steps=2)
    return c


def run(name: str, seed: int = 2**31 + 7, trace: bool = False,
        program=None, c=None) -> dict:
    """One CPU run of the cut cell: the result object."""
    torch.set_num_threads(2)
    c = c or cell(name)
    seconds = 0.05 if c.traffic.get('loop') == 'open' else 0.0
    return run_cell(c, seed, seconds, trace, torch.device('cpu'),
                    time.perf_counter(), program=program,
                    min_units=6)['result']
