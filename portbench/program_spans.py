"""The program's own spans and counters in a cell's traced run.

    python -m portbench.program_spans --workload <name> --seed <n> \\
        [--seconds <s>] [--oncost 1]

from the root of a checkout, on a card. The program names its parts itself
(`object_tracking_tpu_torch/utils/profiling.py`: `span`, `count`,
`Recorder`): `predict` and its six parts in `inference.py`, `train` and
its seven parts in `training/steps.py`, the counters `assign.steps` and
`assign.matches` in `ops/matching.py`. `run.py` reads none of them (its
`trace.reduce` keeps the benchmark's own `portbench.` ranges alone), so
this module reads them beside a cell's traced run:

- the cell runs as `run.py --trace 1` runs it, with a program `Recorder`
  attached in the timed part (host seconds and self seconds per span, and
  the counters) and nothing added to the profiled part, whose `ott.*`
  ranges give each span's device time and launches (through the
  profiler's op tree) and name the device's idle gaps by the innermost
  range of either kind;
- `READERS` turns that into the per-layer numbers of the program's spans,
  each None where its spans or counters are absent.

It prints one JSON line: the cell's result as `run.py` gives it (the
benchmark's readings, their host times with the recorder's cost in
them) and, under `program`, the readers' numbers and the tables they come
from. With `--oncost 1` it prints instead the host ms a call or step with
a recorder attached and without, in alternating blocks of one process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402
from unittest import mock  # noqa: E402

import torch  # noqa: E402

from portbench import spans, trace  # noqa: E402

PREFIX = 'ott.'                             # the program's profiler ranges
BARE = ('portbench.call', 'portbench.step', '(no span)')
PREP = ('to_device', 'augment', 'targets')


def reduce(events) -> dict:
    """Device seconds and kernel launches of what each `ott.*` range
    launched, and the device's idle seconds by the innermost range (of
    the program's or the benchmark's) the host was in."""
    from torch.autograd import DeviceType
    device_s, launches = defaultdict(float), defaultdict(int)
    kernels, ranges = [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and hi > lo:
                kernels.append((lo, hi))
            continue
        if e.name.startswith((PREFIX, trace.PREFIX)):
            ranges.append((lo, hi, e.name))
        if not e.kernels:
            continue
        took = sum(k.duration for k in e.kernels) / 1e6
        for name in {a.name for a in trace._chain(e)}:
            if name.startswith(PREFIX):
                device_s[name[len(PREFIX):]] += took
                launches[name[len(PREFIX):]] += len(e.kernels)
    union = trace._union(kernels)
    gaps = defaultdict(float)
    for before, after in zip(union, union[1:]):
        lo, hi = before[1], after[0]
        mid = (lo + hi) / 2
        inner = [(r_lo, name) for r_lo, r_hi, name in ranges
                 if r_lo <= mid <= r_hi]
        gaps[max(inner)[1] if inner else '(no span)'] += (hi - lo) / 1e6
    return {'program_span_device_s': dict(device_s),
            'program_span_launches': dict(launches),
            'idle_gaps_s': dict(gaps)}


def _per(value, units) -> Optional[float]:
    return None if value is None or not units else value / units


def host_ms(span: str) -> Callable:
    return lambda r: _per(r['program_span_host_s'].get(span),
                          r['host_units'] / 1e3)


def launches(span: str) -> Callable:
    return lambda r: _per(r['program_span_launches'].get(span), r['units'])


def assign_useful(r: dict) -> Optional[float]:
    c = r['program_counters']
    if not c.get('assign.steps') or 'assign.matches' not in c:
        return None
    return 100.0 * c['assign.matches'] / c['assign.steps']


def adam_ms(r: dict) -> Optional[float]:
    return _per(r['program_span_device_s'].get('optimizer'), r['units'] / 1e3)


def prep_idle_ms(r: dict) -> Optional[float]:
    gaps = [r['idle_gaps_s'][PREFIX + n] for n in PREP
            if PREFIX + n in r['idle_gaps_s']]
    return _per(sum(gaps), r['units'] / 1e3) if gaps else None


def bare_idle_share(r: dict) -> Optional[float]:
    """Percent of the traced idle time under the benchmark's bare `call`
    or `step` span or under no span at all."""
    idle = sum(r['idle_gaps_s'].values())
    if not idle:
        return None
    return 100.0 * sum(r['idle_gaps_s'].get(n, 0.0) for n in BARE) / idle


# name: (reader, the cells whose traced runs it reads)
SERVE, LIVE = ['joint_serve_b8'], ['joint_live_b1']
TRAIN = ['yolov2_train_b32', 'joint_train_b4']
READERS: Dict[str, tuple] = {
    'serve.results_ms': (host_ms('predict.results'), SERVE),
    'serve.fetch_ms': (host_ms('predict.fetch'), SERVE),
    'serve.h2d_host_ms': (host_ms('predict.h2d'), SERVE),
    'serve.assign_launches': (launches('predict.assign'), SERVE),
    'serve.assign_useful': (assign_useful, SERVE),
    'live.assign_launches': (launches('predict.assign'), LIVE),
    'train.adam_ms': (adam_ms, TRAIN),
    'train.prep_idle_ms': (prep_idle_ms, ['joint_train_b4']),
    'bare_idle_share': (bare_idle_share, SERVE + LIVE + TRAIN),
}


def read(reading: dict, cell: str) -> dict:
    out = {}
    for name, (reader, cells) in READERS.items():
        value = reader(reading) if cell in cells else None
        if value is not None:
            out[name] = value
    return out


def traced(cell, seed: int, seconds: float, device, t0: float,
           min_units: int = 0) -> dict:
    """One traced run of `cell` (`run.run_cell`), with a program recorder
    attached in its timed part: the run's result and, under `program`,
    the program's readings."""
    from object_tracking_tpu_torch.utils.profiling import Recorder, recording
    from portbench.run import run_cell
    parts, installed = [], spans.installed

    @contextlib.contextmanager
    def with_recorder(tracer, model, serving):
        recorder = Recorder()
        parts.append((tracer, recorder))
        attach = contextlib.nullcontext() if tracer.profile \
            else recording(recorder)
        with installed(tracer, model, serving), attach:
            yield

    with mock.patch.object(spans, 'installed', with_recorder):
        out = run_cell(cell, seed, seconds, True, device, t0,
                       min_units=min_units)
    [(timer, recorder)] = [p for p in parts if not p[0].profile]
    [(profiled, _)] = [p for p in parts if p[0].profile]
    rec = recorder.reading()
    reading = {'units': profiled.units, 'host_units': timer.units,
               'program_span_host_s': rec['host_s'],
               'program_span_self_s': rec['self_s'],
               'program_counters': rec['counters'],
               **reduce(profiled.prof.events())}
    per_unit = {  # table: (key of `reading`, factor to a call or step)
        'span_host_ms': ('program_span_host_s', 1e3 / max(timer.units, 1)),
        'span_self_ms': ('program_span_self_s', 1e3 / max(timer.units, 1)),
        'span_device_ms': ('program_span_device_s',
                           1e3 / max(profiled.units, 1)),
        'span_launches': ('program_span_launches',
                          1 / max(profiled.units, 1))}
    tables = {table: {k: v * f for k, v in reading[key].items()}
              for table, (key, f) in per_unit.items()}
    program = {'readings': read(reading, cell.name), **tables,
               'counters': rec['counters'],
               'idle_gaps_s': dict(sorted(reading['idle_gaps_s'].items(),
                                          key=lambda kv: -kv[1])),
               'units': profiled.units, 'host_units': timer.units}
    return {**out, 'program': program}


def _quartiles(values) -> dict:
    q = statistics.quantiles(values, n=4)
    return {'median': statistics.median(values), 'q1': q[0], 'q3': q[2],
            'n': len(values)}


def oncost(cell, seed: int, device, per_block: int = 8,
           rounds: int = 10) -> dict:
    """Host ms of each call or step, in blocks of `per_block` with a
    recorder attached and without, alternating for `rounds` rounds (the
    order swapped each round); median and quartiles of each side."""
    from object_tracking_tpu_torch.utils.profiling import Recorder, recording
    from portbench import traffic, weights
    from portbench.drivers import common, serve, train
    from portbench.reference import model as ref_model
    cfg, mix = cell.config, cell.traffic
    done = [0]

    def blocks(unit, warm: int) -> dict:
        for _ in range(warm):
            unit()
        got = {'off': [], 'on': []}
        for r in range(rounds):
            for side in ('off', 'on') if r % 2 == 0 else ('on', 'off'):
                recorder = Recorder()
                with recording(recorder) if side == 'on' \
                        else contextlib.nullcontext():
                    for _ in range(per_block):
                        common.sync(device)
                        t = time.perf_counter()
                        unit()
                        common.sync(device)
                        got[side].append((time.perf_counter() - t) * 1e3)
                recorder.reading()
        return {side: _quartiles(v) for side, v in got.items()}

    if mix['driver'] == 'serve':
        batched = mix['entry'] == 'predict_batch'
        pool = traffic.serve_pool(mix, cfg, seed)
        with common.precision(cfg), torch.no_grad():
            w = weights.make(cfg, seed, device)
            first = ref_model.joint_forward(
                w, cfg, torch.from_numpy(pool[0]).to(device))['track']
            obj = serve.live_threshold(first, cfg['anchors'],
                                       mix['live_candidates'])
            pred = serve.program_predictor(cfg, mix, w, obj, device)

            def unit():
                serve._call(pred, pool[done[0] % len(pool)], batched)
                done[0] += 1
            return {'call_ms': blocks(unit, 3)}
    pool = train.train_pool(cfg, mix, seed)
    with common.precision(cfg):
        trainer = train.ProgramTrainer(
            cfg, mix, weights.make(cfg, seed, device), device)

        def unit():
            trainer.step(pool[done[0] % len(pool)])
            done[0] += 1
        return {'step_ms': blocks(unit, 2)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, default=30.0)
    parser.add_argument('--oncost', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from portbench import cells
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        print('portbench.program_spans: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    if args.oncost:
        out = {'cell': cell.name, 'seed': args.seed,
               **oncost(cell, args.seed, device)}
    else:
        out = {'cell': cell.name, 'seed': args.seed,
               **traced(cell, args.seed, args.seconds, device, T0)}
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
