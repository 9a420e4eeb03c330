"""The program's own spans (`ott.*` profiler ranges, from
`object_tracking_tpu_torch/utils/profiling.py::span`) leave every reading
of `trace.reduce` as it was: a profile holding them reduces to the same
numbers as the same profile with them taken out and their children hung
on their parents. The profile is built by hand, with device kernels, a
user annotation on the device and a backward node, which a CPU profile
lacks. `program_spans` reads them: its reduction of the same profile, its
readers on readings built by hand, and a traced run of a cut cell on the
CPU with a program recorder attached."""

import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import program_spans, trace
from portbench.tests import tiny


class Event(types.SimpleNamespace):
    pass


def kernel(name, lo, hi, annotation=False):
    return Event(name=name, time_range=types.SimpleNamespace(start=lo, end=hi),
                 device_type=DeviceType.CUDA, is_user_annotation=annotation,
                 cpu_parent=None, kernels=[], sequence_nr=-1)


def op(name, lo, hi, parent=None, kernels=(), seq=-1):
    return Event(name=name, time_range=types.SimpleNamespace(start=lo, end=hi),
                 device_type=DeviceType.CPU, is_user_annotation=False,
                 cpu_parent=parent, sequence_nr=seq,
                 kernels=[types.SimpleNamespace(duration=k.time_range.end
                                                - k.time_range.start)
                          for k in kernels])


def profile(program_spans: bool) -> list:
    """A served call and a backward node, in microseconds: the benchmark's
    `call`, `model`, `batch_norm` and `assign_tracks` spans, with or
    without the program's `ott.predict*` ranges between them."""
    k_conv = kernel('sm90_conv_fprop', 10, 30)
    k_bn = kernel('elementwise_bn', 31, 35)
    k_arg = kernel('reduce_argmax', 60, 61)
    k_copy = kernel('Memcpy DtoH (Device -> Pageable)', 90, 92)
    k_bwd = kernel('elementwise_bn_backward', 150, 160)
    events = [k_conv, k_bn, k_arg, k_copy, k_bwd]
    call = op('portbench.call', 0, 100)
    events.append(call)
    top = call
    if program_spans:
        top = op('ott.predict', 1, 99, call)
        forward = op('ott.predict.forward', 2, 40, top)
        assign = op('ott.predict.assign', 41, 88, top)
        fetch = op('ott.predict.fetch', 89, 98, top)
        events += [top, forward, assign, fetch,
                   kernel('ott.predict', 10, 92, annotation=True),
                   kernel('ott.predict.forward', 10, 35, annotation=True)]
    else:
        forward = assign = fetch = top
    model = op('portbench.model', 3, 39, forward)
    conv = op('aten::conv2d', 4, 9, model)
    cudnn = op('aten::cudnn_convolution', 5, 8, conv, [k_conv])
    bn = op('portbench.batch_norm', 10, 20, model)
    mul = op('aten::mul', 11, 12, bn, [k_bn], seq=7)
    wrapped = op('portbench.assign_tracks', 42, 87, assign)
    argmax = op('aten::argmax', 43, 44, wrapped, [k_arg])
    copy = op('aten::copy_', 90, 91, fetch, [k_copy])
    backward = op('autograd::engine::evaluate_function: MulBackward0',
                  140, 170, None, seq=7)
    bwd = op('aten::mul', 141, 142, backward, [k_bwd])
    return events + [model, conv, cudnn, bn, mul, wrapped, argmax, copy,
                     backward, bwd]


def reduced(events) -> dict:
    tracer = trace.Tracer()
    tracer.prof = types.SimpleNamespace(events=lambda: events)
    tracer.window_s, tracer.units = 0.5, 1
    tracer.host_s.update(call=1e-4, model=4e-5)
    return trace.reduce(tracer)


def test_reduce_reads_the_same_with_the_program_spans():
    without = reduced(profile(program_spans=False))
    got = reduced(profile(program_spans=True))
    assert got.keys() == without.keys()
    for key in without:
        assert got[key] == without[key], key


def test_the_profile_exercises_every_reading():
    r = reduced(profile(program_spans=True))
    assert r['busy_s'] > 0 and r['conv_s'] > 0 and r['batch_norm_s'] > 0
    assert {'call', 'model', 'batch_norm', 'assign_tracks'} <= set(
        r['span_device_s'])
    assert r['gaps_s'] and not any(name.startswith('ott.')
                                   for name in r['kernel_s'])
    assert not any(name.startswith('ott.') for name in r['gaps_s'])


def test_program_reduction_of_the_ranges():
    got = program_spans.reduce(profile(program_spans=True))
    us = 1e-6
    assert got['program_span_device_s'] == pytest.approx({
        'predict': 27 * us, 'predict.forward': 24 * us,
        'predict.assign': 1 * us, 'predict.fetch': 2 * us})
    assert got['program_span_launches'] == {
        'predict': 4, 'predict.forward': 2, 'predict.assign': 1,
        'predict.fetch': 1}
    # the innermost range of either kind names a gap; the backward's gap
    # falls under none
    assert got['idle_gaps_s'] == pytest.approx({
        'portbench.model': 1 * us, 'portbench.assign_tracks': 54 * us,
        '(no span)': 58 * us})


def test_an_idle_gap_under_a_program_range_is_named_by_it():
    k1, k2 = kernel('a', 10, 20), kernel('b', 60, 70)
    call = op('portbench.call', 0, 100)
    predict = op('ott.predict', 1, 99, call)
    results = op('ott.predict.results', 50, 98, predict)
    events = [k1, k2, call, predict, results,
              op('aten::add', 5, 6, predict, [k1]),
              op('aten::mul', 55, 56, results, [k2])]
    got = program_spans.reduce(events)
    assert got['idle_gaps_s'] == pytest.approx({'ott.predict': 40e-6})
    assert got['program_span_launches'] == {'predict': 2,
                                            'predict.results': 1}


BUILT = {'units': 2, 'host_units': 4,
         'program_span_host_s': {'predict.results': 0.008,
                                 'predict.fetch': 0.02, 'predict.h2d': 0.004},
         'program_span_self_s': {},
         'program_counters': {'assign.steps': 512, 'assign.matches': 64},
         'program_span_device_s': {'optimizer': 0.006},
         'program_span_launches': {'predict.assign': 8000},
         'idle_gaps_s': {'ott.to_device': 0.001, 'ott.augment': 0.002,
                         'ott.targets': 0.001, 'portbench.step': 0.004,
                         'ott.forward': 0.002}}
EXPECTED = {'serve.results_ms': 2.0, 'serve.fetch_ms': 5.0,
            'serve.h2d_host_ms': 1.0, 'serve.assign_launches': 4000.0,
            'serve.assign_useful': 12.5, 'live.assign_launches': 4000.0,
            'train.adam_ms': 3.0, 'train.prep_idle_ms': 2.0,
            'bare_idle_share': 40.0}


@pytest.mark.parametrize('name', sorted(program_spans.READERS))
def test_reader_reads_a_built_reading_and_none_without_data(name):
    reader, _ = program_spans.READERS[name]
    assert reader(BUILT) == pytest.approx(EXPECTED[name])
    empty = {k: ({} if isinstance(v, dict) else v) for k, v in BUILT.items()}
    assert reader(empty) is None


def test_every_reader_has_an_expected_number():
    assert set(EXPECTED) == set(program_spans.READERS)


@pytest.mark.parametrize('workload', ['joint_serve_b8', 'joint_train_b4'])
def test_traced_run_of_a_cut_cell_reads_the_program(workload):
    torch.set_num_threads(2)
    cell = tiny.cell(workload)
    out = program_spans.traced(cell, 2**31 + 11, 0.0, torch.device('cpu'),
                               time.perf_counter(), min_units=6)
    assert out['result']['correct']
    got = out['program']
    host = got['span_host_ms']
    if workload == 'joint_serve_b8':
        b, t = cell.traffic['streams'], cell.traffic['window']
        assert set(host) == {'predict', 'predict.h2d', 'predict.forward',
                             'predict.decode_nms', 'predict.assign',
                             'predict.fetch', 'predict.results'}
        slots = cell.config['max_tracks']
        assert got['counters']['assign.steps'] % (got['host_units'] * t * b) \
            == 0 and got['counters']['assign.steps'] <= \
            got['host_units'] * t * b * slots
        assert {'serve.results_ms', 'serve.fetch_ms', 'serve.h2d_host_ms',
                'serve.assign_useful'} <= set(got['readings'])
    else:
        assert set(host) == {'train', 'to_device', 'augment', 'targets',
                             'forward', 'loss', 'backward', 'optimizer'}
        assert got['counters'] == {}
    assert host[next(iter(host))] >= max(host.values())
    # device readings need kernels, which a CPU profile lacks
    assert got['span_device_ms'] == {} and got['span_launches'] == {}
