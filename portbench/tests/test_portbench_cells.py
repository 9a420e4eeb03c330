"""Every cell and metric of BENCHMARK.json resolves to its files by name,
and the file keeps to the shape the benchmark's contract gives it."""

import json
import re

import pytest
import torch

from portbench import cells
from portbench.cells import HERE, ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
BENCH = cells.load()


@pytest.mark.parametrize('workload', cells.names())
def test_cell_resolves(workload):
    c = cells.cell(workload)
    assert c.driver().run
    assert c.end_to_end and any(m['name'] == 'setup_s'
                                for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.readers()) == {m['name'] for m in c.per_layer}
    assert c.limits


@pytest.mark.parametrize('metric', [m['name'] for m in BENCH['per_layer']])
def test_metric_has_a_reader(metric):
    assert callable(cells.reader(metric))


def test_names_and_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    names = ([c['name'] for c in BENCH['configs']]
             + [w['name'] for w in BENCH['workloads']]
             + [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH['configs']:
        assert (ROOT / c['file']).is_file()
        assert json.loads((ROOT / c['file']).read_text())['name'] == c['name']
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH['workloads']:
        assert (HERE / 'traffic' / f"{w['traffic']}.json").is_file()
        assert w['chips'] == 1


def test_every_bound_and_metric_is_well_formed():
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    layers = {}
    for m in BENCH['per_layer']:
        assert m['moves'] in {e['name'] for e in BENCH['end_to_end']}
        for w in m['workloads']:
            assert m['moves'] in [e['name'] for e in
                                  cells.cell(w).end_to_end]
        layers.setdefault(m['layer'], m['layer'])
    roofs = [m for m in BENCH['per_layer']
             if m['name'].endswith('_roofline') or 'mfu' in m['name']]
    assert all(m['unit'] == '%' for m in roofs)


@pytest.mark.parametrize('config', [c['name'] for c in BENCH['configs']])
def test_config_resolves_its_kind_and_precision(config):
    from portbench import models
    from portbench.drivers.common import precision_spec
    cfg = json.loads((HERE / 'configs' / f'{config}.json').read_text())
    kind = models.kind(cfg)
    for fn in ('weight_spec', 'conv_table', 'program', 'program_step',
               'train_batches', 'reference_batch', 'reference_loss'):
        assert callable(getattr(kind, fn)), fn
    spec = precision_spec(cfg['precision'])
    assert hasattr(torch, spec['dtype'])
    control = precision_spec(spec['control'])
    assert control['dtype'] and control['allow_tf32'] != spec['allow_tf32']
