"""A traced run times its host spans and mfu without the profiler, then
profiles as many calls or steps after them for the device readings."""

import contextlib
import time

import torch

from portbench import readers
from portbench.tests import tiny
from portbench.trace import Traced


def test_parts_follow_each_other():
    seen = []

    @contextlib.contextmanager
    def install(tracer):
        seen.append(('on', tracer.profile))
        yield
        seen.append(('off', tracer.profile))

    traced = Traced(True, 2, install)
    traced.at = 3
    profiled_units = []
    for unit in range(10):
        traced.begin(unit)
        with traced.span('call'):
            torch.ones(4).sum()
        if traced.profiled.active:
            profiled_units.append(unit)
        traced.end()
    assert seen == [('on', False), ('off', False), ('on', True),
                    ('off', True)]
    assert profiled_units == [5, 6]
    assert traced.timer.units == 2 and traced.profiled.units == 2
    assert traced.done()
    assert 'call' in traced.timer.host_s and not traced.timer.prof


def test_host_readings_come_from_the_unprofiled_part():
    from portbench.drivers import serve
    from portbench.drivers.common import Context
    c = tiny.cell('joint_serve_b8')
    out = serve.run(Context(config=c.config, traffic=c.traffic, seed=9,
                            seconds=0.0, trace=True,
                            device=torch.device('cpu'),
                            t0=time.perf_counter(), min_units=1))
    reading = out.reading
    host = reading['host']
    assert host['units'] == reading['units'] == c.traffic['trace_calls']
    assert readers.span_host_ms(reading, 'assign_tracks') == (
        host['span_s']['assign_tracks'] / host['units'] * 1e3)
    assert out.attempted >= 2 * c.traffic['trace_calls']
    assert readers.span_host_ms(dict(reading, host=dict(
        host, span_s={})), 'assign_tracks') is None
