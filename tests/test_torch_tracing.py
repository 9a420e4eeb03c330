"""The port's spans and counters on the CPU (`utils/profiling.py`: `span`,
`count`, `Recorder`, `recording`) and where the program places them: the
serving entry (`inference.py`), the identity assignment
(`ops/matching.py::assign_tracks`) and the train steps
(`training/steps.py`).

With no recorder attached and no profiler running, a span is one shared
null context and a counter's callable is never called; a recorder
changes no output; each call or step records its spans once, in order,
under one root; self time is the duration less the children's; the
assignment's counters agree with the ids the predictor returned."""

import json
import os

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch.config import YOLOV2_ANCHORS
from object_tracking_tpu_torch.inference import JointPredictor
from object_tracking_tpu_torch.models import Darknet19, MultiObjDetTracker
from object_tracking_tpu_torch.ops.targets import encode_targets_batch
from object_tracking_tpu_torch.training import (
    TrainState, make_detector_train_step, make_joint_eval_step_fused,
    make_joint_train_step_fused, make_optimizer)
from object_tracking_tpu_torch.utils import profiling
from object_tracking_tpu_torch.utils.profiling import (
    Recorder, count, profile_trace, recording, span)

SMALL = dict(num_classes=3, num_anchors=2, convlstm_features=8,
             width_div=8)
ANCHORS = np.asarray(YOLOV2_ANCHORS[:4], np.float32)
LABELS = ('a', 'b', 'c')
NET, B, T, M, SLOTS = 64, 2, 4, 5, 16
PREDICT = ['predict.h2d', 'predict.forward', 'predict.decode_nms',
           'predict.assign', 'predict.fetch', 'predict.results']
TRAIN = ['to_device', 'augment', 'targets', 'forward', 'loss', 'backward',
         'optimizer']
ENC = dict(net_h=NET, net_w=NET, grid_h=2, grid_w=2, num_classes=3,
           true_box_buffer=M)


def predictor(seed=0):
    torch.manual_seed(seed)
    return JointPredictor(MultiObjDetTracker(**SMALL), ANCHORS, LABELS,
                          obj_threshold=0.05, net_size=(NET, NET),
                          max_tracks=SLOTS, device='cpu')


def clips(seed=0):
    """B streams of a still scene: detections persist, so tracks match."""
    frame = np.random.RandomState(seed).rand(B, 1, NET, NET, 3)
    return np.repeat(frame.astype(np.float32), T, axis=1)


def call(pred, entry, x):
    if entry == 'predict_batch':
        return pred.predict_batch(x)
    return [pred.predict_window(x[0])]


def tree(reading, root_name):
    """[(root, [child names in order])] of every root named `root_name`."""
    spans = reading['spans']
    return [(r.index, [s.name for s in spans if s.parent == r.index])
            for r in spans if r.parent is None and r.name == root_name]


def fake_clock(monkeypatch, ticks):
    clock = iter(ticks)
    monkeypatch.setattr(profiling.time, 'perf_counter_ns',
                        lambda: next(clock))


# ------------------------------------------------------------------ the API
def test_span_and_count_are_inert_without_recorder_or_profiler():
    called = []
    first, second = span('a'), span('b')
    assert first is second and isinstance(first, type(profiling._NULL))
    with first:
        count('n', lambda: called.append(1) or torch.ones(()))
        count('m', 3)
    assert called == []
    recorder = Recorder()
    with recording(recorder):
        pass
    with span('a'):
        count('n', lambda: called.append(1) or torch.ones(()))
    assert called == [] and recorder.reading() == {
        'spans': [], 'host_s': {}, 'self_s': {}, 'counters': {}}


def test_recording_attaches_only_inside_the_block():
    recorder = Recorder()
    with recording(recorder) as attached:
        assert attached is recorder
        with span('inside'):
            count('n', 2)
    with span('outside'):
        count('n', 5)
    reading = recorder.reading()
    assert [s.name for s in reading['spans']] == ['inside']
    assert reading['counters'] == {'n': 2}
    assert span('after') is profiling._NULL


def test_span_tree_parents_and_shared_root_ids():
    recorder = Recorder()
    with recording(recorder):
        for _ in range(2):
            with span('call'):
                with span('call.a'):
                    with span('call.a.x'):
                        pass
                with span('call.b'):
                    pass
    got = [(s.index, s.name, s.parent, s.root)
           for s in recorder.reading()['spans']]
    assert got == [(0, 'call', None, 0), (1, 'call.a', 0, 0),
                   (2, 'call.a.x', 1, 0), (3, 'call.b', 0, 0),
                   (4, 'call', None, 4), (5, 'call.a', 4, 4),
                   (6, 'call.a.x', 5, 4), (7, 'call.b', 4, 4)]


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    # call [0, 100]: a [10, 40] holding x [15, 35], b [50, 90]
    fake_clock(monkeypatch, [0, 10, 15, 35, 40, 50, 90, 100])
    recorder = Recorder()
    with recording(recorder):
        with span('call'):
            with span('a'):
                with span('x'):
                    pass
            with span('b'):
                pass
    reading = recorder.reading()
    ns = 1e-9
    assert reading['host_s'] == pytest.approx(
        {'call': 100 * ns, 'a': 30 * ns, 'x': 20 * ns, 'b': 40 * ns})
    assert reading['self_s'] == pytest.approx(
        {'call': 30 * ns, 'a': 10 * ns, 'x': 20 * ns, 'b': 40 * ns})
    for s in reading['spans']:
        children = sum(c.end_ns - c.start_ns for c in reading['spans']
                       if c.parent == s.index)
        assert reading['self_s'][s.name] == pytest.approx(
            (s.end_ns - s.start_ns - children) * ns)


def test_counters_sum_host_ints_and_device_tensors_apart():
    calls = []

    def matched():
        calls.append(1)
        return torch.tensor([1, 0, 1]).sum()
    recorder = Recorder()
    with recording(recorder):
        for _ in range(3):
            count('steps', 4)
            count('hits', matched)
    assert len(calls) == 3
    assert recorder.reading()['counters'] == {'steps': 12, 'hits': 6}


def test_a_span_left_by_an_exception_is_closed():
    recorder = Recorder()
    with recording(recorder):
        with pytest.raises(ValueError):
            with span('call'):
                with span('call.part'):
                    raise ValueError('x')
        with span('next'):
            pass
    spans = recorder.reading()['spans']
    assert [(s.name, s.parent) for s in spans] == [
        ('call', None), ('call.part', 0), ('next', None)]
    assert all(s.end_ns >= s.start_ns for s in spans)


def test_spans_are_profiler_ranges_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span('call'):
            torch.ones(4).sum()
    assert span('call') is profiling._NULL
    names = {e.name for e in prof.events()}
    assert 'ott.call' in names


# -------------------------------------------------------------- serving
@pytest.mark.parametrize('entry', ['predict_batch', 'predict_window'])
def test_predictor_outputs_bitwise_equal_with_a_recorder(entry):
    plain, traced = predictor(), predictor()
    recorder = Recorder()
    for seed in range(2):
        want = call(plain, entry, clips(seed))
        with recording(recorder):
            got = call(traced, entry, clips(seed))
        assert got == want
    if entry == 'predict_batch':
        states = [(p._bstate, p._btrack_state) for p in (plain, traced)]
    else:
        states = [(p._state, p._track_state) for p in (plain, traced)]
    a, b = (torch.utils._pytree.tree_leaves(s) for s in states)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert recorder.reading()['counters']['assign.steps'] > 0


@pytest.mark.parametrize('entry', ['predict_batch', 'predict_window'])
def test_predict_span_tree(entry):
    pred, recorder = predictor(), Recorder()
    with recording(recorder):
        call(pred, entry, clips())
    reading = recorder.reading()
    assert tree(reading, 'predict') == [(0, PREDICT)]
    assert {s.root for s in reading['spans']} == {0}
    assert len(reading['spans']) == 1 + len(PREDICT)


def test_assign_counters_agree_with_the_returned_ids():
    """A valid detection is matched exactly when it carries an id its
    stream had before that frame (a fresh id is always new)."""
    pred, recorder = predictor(), Recorder()
    seen = [set() for _ in range(B)]
    matched = 0
    with recording(recorder):
        for seed in (0, 0, 1):
            before = None if pred._btrack_state is None else \
                pred._btrack_state.ids.numpy()
            out = pred.predict_batch(clips(seed))
            for clip in range(B):
                if before is not None:
                    assert set(before[clip][before[clip] >= 0]) <= seen[clip]
                for frame in out[clip]:
                    ids = [d['track_id'] for d in frame]
                    matched += sum(i in seen[clip] for i in ids)
                    seen[clip].update(i for i in ids if i >= 0)
    counters = recorder.reading()['counters']
    candidates = min(128, (NET // 32) ** 2 * 2)   # top-K of the lattice
    assert counters['assign.steps'] == 3 * T * B * min(SLOTS, candidates)
    assert counters['assign.matches'] == matched
    assert 0 < matched < counters['assign.steps']


# ------------------------------------------------------------- training
def raw_batch(seed):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, T, M, 4), np.float32)
    for index in np.ndindex(B, T, 3):
        x1, y1 = rng.uniform(0, 40, 2)
        w, h = rng.uniform(6, 24, 2)
        boxes[index] = (x1, y1, x1 + w, y1 + h)
    valid = np.zeros((B, T, M), bool)
    valid[..., :3] = True
    return {'images_u8': rng.randint(0, 256, (B, T, NET, NET, 3)).astype(
                np.uint8),
            'boxes': boxes, 'cls': rng.randint(0, 3, (B, T, M)).astype(
                np.int32),
            'valid': valid, 'aug_seeds': np.arange(B, dtype=np.uint32)}


def joint_state(seed=0):
    torch.manual_seed(seed)
    return TrainState.create(MultiObjDetTracker(**SMALL),
                             make_optimizer(1e-3))


def test_fused_joint_step_records_the_train_spans_once_a_step():
    state, recorder = joint_state(), Recorder()
    step = make_joint_train_step_fused(ANCHORS, augment=True, **ENC)
    with recording(recorder):
        for seed in range(2):
            state, _ = step(state, raw_batch(seed))
    reading = recorder.reading()
    roots = tree(reading, 'train')
    assert [children for _, children in roots] == [TRAIN, TRAIN]
    assert all(s.root in {r for r, _ in roots} for s in reading['spans'])
    assert len(reading['spans']) == 2 * (1 + len(TRAIN))


def test_fused_joint_step_equal_with_a_recorder():
    plain, traced = joint_state(), joint_state()
    step = make_joint_train_step_fused(ANCHORS, augment=True, **ENC)
    for seed in range(2):
        plain, want = step(plain, raw_batch(seed))
        with recording(Recorder()):
            traced, got = step(traced, raw_batch(seed))
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(
        plain.model.state_dict().values(), traced.model.state_dict().values()))


def test_detector_step_records_its_train_spans_once_a_step():
    torch.manual_seed(0)
    state = TrainState.create(Darknet19(num_classes=3, num_anchors=2,
                                        width_div=8), make_optimizer(1e-3))
    step = make_detector_train_step(ANCHORS)
    recorder = Recorder()
    with recording(recorder):
        for seed in range(2):
            raw = raw_batch(seed)
            y, true_boxes = encode_targets_batch(
                torch.from_numpy(raw['boxes'][:, 0]),
                torch.from_numpy(raw['cls'][:, 0]),
                torch.from_numpy(raw['valid'][:, 0]), ANCHORS, image_h=NET,
                image_w=NET, grid_h=2, grid_w=2, num_classes=3,
                true_box_buffer=M)
            batch = {'images': raw['images_u8'][:, 0] / np.float32(255.0),
                     'y_true': y, 'true_boxes': true_boxes}
            state, _ = step(state, batch)
    prepared = [n for n in TRAIN if n not in ('augment', 'targets')]
    assert [c for _, c in tree(recorder.reading(), 'train')] == [
        prepared, prepared]


def test_eval_step_spans_are_named_eval():
    state, recorder = joint_state(), Recorder()
    step = make_joint_eval_step_fused(ANCHORS, **ENC)
    with recording(recorder):
        step(state, raw_batch(0))
    assert tree(recorder.reading(), 'eval') == [(0, [
        'to_device', 'augment', 'targets', 'forward', 'loss'])]


def test_profile_trace_of_a_fused_step_holds_its_ranges(tmp_path):
    state = joint_state()
    step = make_joint_train_step_fused(ANCHORS, augment=True, **ENC)
    with profile_trace(str(tmp_path)):
        step(state, raw_batch(0))
    [name] = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'ott.train', *('ott.' + n for n in TRAIN)} <= names
