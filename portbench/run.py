"""Run one cell of the port's benchmark once, on the card of this machine.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`) names its
configuration, traffic mix and metrics; `cells.py` finds their files. Set-
up (imports, the weights, the inputs, warm-up of the cell's own shapes,
in which the program builds or loads its kernels) is `setup_s`; then the cell's driver measures
for `--seconds`, and once the window has closed it checks what the timed
path produced against the plain reference (`correct`). With `--trace 0`
the result holds the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from a profile of a fixed number of calls or
steps in the middle of the window, and the breakdown of that profile.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, [breakdown,] and last `checks`, each compared
number beside its limit; the same numbers end standard error. Without a
CUDA card, with fewer cards than the cell asks for, or with JAX loaded in
this process once the window has closed, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'object_tracking_tpu')


def loaded_forbidden() -> list:
    """Modules of this process whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's (compared whole: the port's own name
    begins with the JAX package's)."""
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi unavailable'


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, program=None, min_units: int = 0) -> dict:
    """One run of `cell` on `device`: the result object, without the
    device's name (the caller adds it). The tests call this on the CPU at
    small sizes; the command line refuses a machine without a card."""
    from portbench.drivers.common import Context
    ctx = Context(config=cell.config, traffic=cell.traffic,
                  seed=seed, seconds=seconds,
                  trace=trace, device=device, t0=t0, program=program,
                  min_units=min_units)
    out = cell.driver().run(ctx)
    if trace:
        metrics, readers = {}, cell.readers()
        for m in cell.per_layer:
            value = readers[m['name']](out.reading)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': out.end_to_end[m['name']],
                               'unit': m['unit']} for m in cell.end_to_end}
    checks = {name: {'value': out.numbers[name], 'limit': limit}
              for name, limit in cell.limits.items()}
    correct = (out.failed == 0 and all(
        math.isfinite(c['value']) and c['value'] <= c['limit']
        for c in checks.values()))
    result = {'correct': correct, 'attempted': out.attempted,
              'failed': out.failed, 'metrics': metrics,
              'device': {'count': 1,
                         'memory_peak_bytes': out.memory_peak_bytes}}
    if trace and out.reading is not None:
        from portbench.trace import breakdown
        result['device']['busy_s'] = out.reading['busy_s']
        result['device']['window_s'] = out.reading['window_s']
        result['breakdown'] = breakdown(out.reading)
    result['checks'] = checks
    return {'result': result, 'lines': out.lines}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import cells
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        print('portbench: no CUDA device; the benchmark runs on a card and '
              'never on the CPU', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f'portbench: {args.workload} needs {cell.chips} cards, this '
              f'machine has {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    import object_tracking_tpu_torch  # noqa: F401  (the system under test)
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T0)
    found = loaded_forbidden()
    if found:
        print(f'portbench: JAX is loaded in this process: {found}',
              file=sys.stderr)
        return 3
    result = out['result']
    result['device'] = {'platform': 'gpu',
                        'kind': torch.cuda.get_device_name(device),
                        **result['device']}
    for line in out['lines'] + [{'card': card_line()}]:
        print(json.dumps(line), flush=True)
    for name, c in result['checks'].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
