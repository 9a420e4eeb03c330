"""The benchmark's cells, found by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration, traffic mix and metrics; each lives in a file of its own
under `portbench/`:

- `configs/<config>.json`: the model's sizes, precision and source;
- `traffic/<traffic>.json`: the mix's parameters, read by `traffic.py`
  and by the driver the mix names (`drivers/<driver>.py`);
- `metrics/<metric>.py`: the per-layer reader of one metric;
- `checks/<workload>.json`: the limit of each number that decides
  `correct`, with the readings it was set from.

A new cell or metric is new files and new entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with everything it needs."""

    def __init__(self, bench: dict, name: str):
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json; '
                           f'known: {sorted(cells)}')
        self.workload = cells[name]
        self.name = name
        self.chips = self.workload['chips']
        self.config = _json(HERE / 'configs' / f"{self.workload['config']}.json")
        self.traffic = _json(HERE / 'traffic' /
                             f"{self.workload['traffic']}.json")
        self.limits = _json(HERE / 'checks' / f'{name}.json')['limits']
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench['per_layer']
            if (name in m['workloads'] if 'workloads' in m
                else m['moves'] in reported)]

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")

    def readers(self) -> Dict[str, Callable]:
        return {m['name']: reader(m['name']) for m in self.per_layer}


def reader(metric: str) -> Callable:
    """The `read` function of metrics/<metric>.py (a name may hold dots,
    so the file is loaded by path)."""
    path = HERE / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        'portbench.metrics.' + metric.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load() -> dict:
    return _json(ROOT / 'BENCHMARK.json')


def cell(name: str) -> Cell:
    return Cell(load(), name)


def names() -> List[str]:
    return [w['name'] for w in load()['workloads']]
