"""On the card: the control (the reference in the program's place, in
TF32) fails each cell's check on three seeds, and each planted fault
fails it at the cell's own size. Skips without a card.

    python -m pytest portbench/tests/test_portbench_card.py -q
"""

import time

import pytest

from portbench import cells
from portbench.control import control
from portbench.run import run_cell
from portbench.tests.test_portbench_faults import SERVE, TRAIN

WORKLOADS = [w for w in cells.names()]


@pytest.mark.card
@pytest.mark.parametrize('workload', WORKLOADS)
def test_control_is_not_correct(card, workload):
    c = cells.cell(workload)
    for seed in (101, 102, 103):
        checks = control(c, seed, card)
        assert any(not v['value'] <= v['limit'] for v in checks.values()), \
            (seed, checks)


@pytest.mark.card
@pytest.mark.parametrize('workload,fault', [
    (w, f) for w in WORKLOADS
    for f in (TRAIN if 'train' in w else SERVE)])
def test_fault_is_not_correct_at_size(card, monkeypatch, workload, fault):
    (TRAIN if 'train' in workload else SERVE)[fault](monkeypatch)
    c = cells.cell(workload)
    for seed in (111, 112, 113):
        out = run_cell(c, seed, 2.0, False, card, time.perf_counter())
        assert not out['result']['correct'], (seed,
                                              out['result']['checks'])
