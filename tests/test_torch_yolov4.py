"""YOLOv4 through the port's cfg compiler and `CfgDetector`, held to the
benchmark's plain reference (`portbench/reference/yolov4.py`, written from
the paper's blocks, not from the `.cfg`).

- The committed `portbench/configs/yolov4_coco_608.cfg`: 162 layers, the
  heads at 139, 150 and 161 on grids of 1/8, 1/16 and 1/32 of the input
  with 255 channels each, SPP and PANet routed as darknet's file routes
  them, each head's `scale_x_y`.
- At full widths on a 96x96 input (the `.cfg`'s [net] set to 96), with
  the benchmark's seeded weights and BatchNorm statistics calibrated on
  the frames: the program's heads equal the reference's in float64; in
  float32 the program lies no further from float64 than the reference
  does (this net amplifies float32 rounding ~1e4-fold at 96², to ~3e-3
  of the heads' scale, so no fixed float32 tolerance is tighter than the
  net itself). The decoded, capped and NMS'd detections equal the
  reference's on the program's heads to 1e-6.
- The [yolo] decode: `scale_x_y = 1` bit for bit v3's arithmetic, 1.2
  against a hand-computed box; an unsupported [yolo] key raises.
- `CfgDetector.detect_images`' spans and counters with a recorder, and
  nothing without one.
"""

import inspect
import math

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch.models import darknet_cfg as tcfg
from object_tracking_tpu_torch.models.darknet_cfg import CfgDetector
from object_tracking_tpu_torch.utils import profiling
from object_tracking_tpu_torch.utils.profiling import Recorder, recording
from portbench import cells, trace, weights
from portbench.drivers import detect
from portbench.models import yolov4 as kind
from portbench.reference import yolov4 as ref

CFG = cells.cell('yolov4_detect_b8').config
SIZE, B = 96, 2
HEADS = (139, 150, 161)
DETECT = ['detect.h2d', 'detect.forward', 'detect.decode_nms',
          'detect.fetch', 'detect.results']


def plan_and_shapes(size):
    hwc, plan = tcfg.compile_cfg(tcfg.parse_darknet_cfg(
        kind.cfg_text(dict(CFG, image=size))))
    return plan, tcfg.plan_shapes(plan, hwc)


# ------------------------------------------------------------ the .cfg
@pytest.mark.parametrize('size', [608, SIZE])
def test_cfg_heads_grids_and_channels(size):
    plan, shapes = plan_and_shapes(size)
    assert len(plan) == ref.LAYERS == 162
    assert [i for i, layer in enumerate(plan) if layer[0] == 'yolo'] == \
        list(HEADS)
    for head, stride in zip(HEADS, (8, 16, 32)):
        assert shapes[head - 1] == (size // stride, size // stride, 255)
        assert plan[head - 1][:2] == ('conv', 255)
    specs = tcfg.head_specs(plan)
    assert [s['scale_x_y'] for s in specs] == CFG['scale_x_y']
    assert [s['num_classes'] for s in specs] == [80] * 3
    assert [list(map(list, s['anchors'])) for s in specs] == [
        ref.head_anchors(CFG)[i].tolist() for i in range(3)]


def test_cfg_backbone_spp_and_pan_routes():
    plan, shapes = plan_and_shapes(608)
    acts = [layer[5] for layer in plan[:105] if layer[0] == 'conv']
    assert set(acts) == {'mish'} and len(acts) == 72
    assert {layer[5] for layer in plan[105:] if layer[0] == 'conv'} == {
        'leaky', 'linear'}
    assert [(i, plan[i][1]) for i in (108, 110, 112)] == [
        (108, 5), (110, 9), (112, 13)]
    assert plan[113] == ('route', (112, 110, 108, 107))
    assert plan[119] == ('route', (85,)) and plan[129] == ('route', (54,))
    assert plan[142] == ('route', (141, 126))
    assert plan[153] == ('route', (152, 116))
    assert [shapes[i] for i in (54, 85, 104)] == [
        (76, 76, 256), (38, 38, 512), (19, 19, 1024)]
    assert sum(layer[0] == 'shortcut' for layer in plan) == 1 + 2 + 8 + 8 + 4


def test_weight_spec_names_and_shapes_are_the_programs_state_dict():
    with torch.device('meta'):
        model = kind.program(CFG, torch.float32)
    state = model.state_dict()
    spec = kind.weight_spec(CFG)
    assert [name for name, *_ in spec] == list(state)
    assert all(tuple(state[n].shape) == s for n, s, *_ in spec)
    count = sum(math.prod(shape) for _, shape, *_ in spec)
    assert 64.0e6 < count < 64.5e6     # darknet's 245 MB yolov4.weights


def test_conv_table_within_two_percent_of_darknets_count():
    flops = sum(f for _, f, _ in kind.conv_table(CFG))
    assert len(kind.conv_table(CFG)) == 110
    assert abs(flops / 128.5e9 - 1) < 0.02   # darknet's 128.5 BFlops


# --------------------------------------------- program against reference
@pytest.fixture(scope='module')
def small():
    """Seeded weights at 96x96, BatchNorm calibrated on two frames of the
    benchmark's scenes; the program's module loaded with them."""
    cfg = dict(CFG, image=SIZE)
    mix = dict(cells.cell('yolov4_detect_b8').traffic, streams=B, pool=2)
    frames = detect.frames_pool(mix, cfg, 2**31 + 11)
    w = weights.make(cfg, 2**31 + 11, 'cpu')
    with torch.no_grad():
        kind.calibrate(w, cfg, torch.from_numpy(frames[0]))
    return cfg, frames, w


def program_heads(cfg, w, x, dtype):
    model = kind.program(cfg, dtype).to(dtype)
    model.load_state_dict(w)
    with torch.no_grad():
        return model.eval()(x.to(dtype))['heads']


def rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def test_program_heads_equal_the_reference_in_float64(small):
    cfg, frames, w = small
    x = torch.from_numpy(frames[1])
    w64 = {k: v.double() for k, v in w.items()}
    with torch.no_grad():
        want = ref.forward(w64, x.double(), 80)
    got = program_heads(cfg, w, x, torch.float64)
    assert [tuple(h.shape) for h in got] == [
        (B, SIZE // s, SIZE // s, 3, 85) for s in (8, 16, 32)]
    for g, r in zip(got, want):
        # in float64 throughout, but the program hands its heads out in
        # float32 (DarknetCfgNet.forward): one rounding, ~6e-8 at most
        assert rel(g, r) < 2e-7


def test_program_float32_is_as_close_to_float64_as_the_reference(small):
    cfg, frames, w = small
    x = torch.from_numpy(frames[1])
    with torch.no_grad():
        exact = ref.forward({k: v.double() for k, v in w.items()},
                            x.double(), 80)
        ref32 = ref.forward(w, x, 80)
    got = program_heads(cfg, w, x, torch.float32)
    for g, r, e in zip(got, ref32, exact):
        assert g.dtype == torch.float32
        # both round in float32, in different orders: the program is
        # held to the reference's own distance from float64, with room
        assert rel(g, e) < 3 * rel(r, e) + 1e-6
        assert rel(r, e) < 1e-2


def test_detections_equal_the_references_on_the_programs_heads(small):
    cfg, frames, w = small
    det = CfgDetector(kind.cfg_text(cfg), labels=cfg['labels'],
                      nms_threshold=cfg['nms_threshold'], device='cpu')
    det.module.load_state_dict(w)
    with torch.no_grad():
        heads = ref.forward(w, torch.from_numpy(frames[0]), 80)
    det.obj_threshold = detect.live_threshold(
        kind.reference_scores(heads, cfg), 200)
    grabbed = []
    det.module.register_forward_hook(
        lambda m, a, out: grabbed.append(out['heads']))
    got = det.detect_images(frames[0])
    want = ref.detections(grabbed[0], cfg, det.obj_threshold)
    scores = kind.reference_scores(grabbed[0], cfg)
    assert ((scores.max(-1) > det.obj_threshold).sum(-1) > 128).all()
    assert len(got) == len(want) == B and all(got)
    for g, wf in zip(got, want):
        assert [d[0] for d in g] == [cfg['labels'][c] for c, _, _ in wf]
        np.testing.assert_allclose([d[1] for d in g], [s for _, s, _ in wf],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose([d[2] for d in g], [b for _, _, b in wf],
                                   rtol=0, atol=1e-6)


# ------------------------------------------------------- the [yolo] decode
def test_scale_x_y_one_is_v3s_arithmetic_bit_for_bit():
    netout = torch.from_numpy(np.random.RandomState(0).randn(
        2, 4, 5, 3, 7).astype(np.float32))
    anchors = [[10.0, 13.0], [16.0, 30.0], [33.0, 23.0]]
    boxes, scores = tcfg.decode_yolo3_netout(netout, anchors, (32, 40), 0.3)
    col = torch.arange(5, dtype=torch.float32)[None, :, None]
    row = torch.arange(4, dtype=torch.float32)[:, None, None]
    x = (col + torch.sigmoid(netout[..., 0])) / 5
    y = (row + torch.sigmoid(netout[..., 1])) / 4
    assert torch.equal(boxes[..., 0], x.reshape(2, -1))
    assert torch.equal(boxes[..., 1], y.reshape(2, -1))
    again = tcfg.decode_yolo3_netout(netout, anchors, (32, 40), 0.3, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(again, (boxes, scores)))


def test_scale_x_y_against_a_hand_computed_box():
    netout = torch.zeros((1, 2, 2, 1, 6))
    netout[0, 1, 0, 0, :4] = torch.tensor([2.0, -1.0, 0.5, -0.25])
    boxes, _ = tcfg.decode_yolo3_netout(netout, [[20.0, 40.0]], (64, 64),
                                        0.5, scale_x_y=1.2)
    sx, sy = 1 / (1 + math.exp(-2.0)), 1 / (1 + math.exp(1.0))
    want = [(0 + 1.2 * sx - 0.1) / 2, (1 + 1.2 * sy - 0.1) / 2,
            20 * math.exp(0.5) / 64, 40 * math.exp(-0.25) / 64]
    np.testing.assert_allclose(boxes[0, 2].numpy(), want, rtol=1e-6)
    plain, _ = tcfg.decode_yolo3_netout(netout, [[20.0, 40.0]], (64, 64))
    assert abs(float(plain[0, 2, 0]) - (0 + sx) / 2) < 1e-7


TINY = """[net]
height=32
width=32
channels=3
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
activation=mish
[convolutional]
filters=21
size=1
activation=linear
[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=2
scale_x_y = 1.2
iou_loss=ciou
nms_kind=greedynms
beta_nms=0.6
"""


@pytest.mark.parametrize('key', ['new_coords=1', 'embedding_layer=-5'])
def test_an_unsupported_yolo_key_raises_naming_it(key):
    name = key.split('=')[0]
    with pytest.raises(ValueError, match=name):
        tcfg.compile_cfg(tcfg.parse_darknet_cfg(TINY + key + '\n'))


def test_training_and_nms_keys_are_ignored_and_scale_is_carried():
    _, plan = tcfg.compile_cfg(tcfg.parse_darknet_cfg(TINY))
    assert plan[-1] == ('yolo', ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0)),
                        2, 1.2)
    every = TINY + ''.join(f'{k}=1\n' for k in tcfg.YOLO_KEYS['training'])
    assert tcfg.compile_cfg(tcfg.parse_darknet_cfg(every))[1] == plan


# ------------------------------------------------------ spans and counters
def tiny_detector():
    torch.manual_seed(0)
    return CfgDetector(TINY, labels=('a', 'b'), obj_threshold=0.3,
                       device='cpu')


def test_detect_records_its_spans_and_counters_with_a_recorder():
    det, recorder = tiny_detector(), Recorder()
    x = np.random.RandomState(1).rand(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        heads = det.module(torch.from_numpy(x))['heads']
    _, scores = tcfg.decode_yolo3_netout(heads[0], det.specs[0]['anchors'],
                                         (32, 32), 0.3, 1.2)
    passing = (scores.amax(-1) > 0.3).sum(-1)
    with recording(recorder):
        out = det.detect_images(x)
    reading = recorder.reading()
    roots = [s for s in reading['spans'] if s.parent is None]
    assert [s.name for s in roots] == ['detect']
    assert [s.name for s in reading['spans'][1:]] == DETECT
    assert all(s.parent == 0 for s in reading['spans'][1:])
    assert reading['counters'] == {
        'detect.candidates': int(passing.sum()),
        'detect.capped': int((passing > 128).sum()),
        'mish.elements': 3 * 16 * 16 * 8, 'mish.kernel_elements': 0}
    assert sum(map(len, out)) <= int(passing.sum())


def test_detect_records_nothing_without_a_recorder(monkeypatch):
    det = tiny_detector()
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    called, real = [], profiling.count

    def spied(name, value):
        if callable(value):
            inner = value
            value = lambda: called.append(name) or inner()   # noqa: E731
        real(name, value)
    monkeypatch.setattr(tcfg, 'count', spied)
    plain = det.detect_images(x)
    assert called == [] and profiling.span('detect') is profiling._NULL
    with recording(Recorder()):
        traced = det.detect_images(x)
    assert called == ['detect.candidates', 'detect.capped']
    assert traced == plain


# ------------------------------------------- the benchmark's Mish spans
def test_the_benchmarks_mish_wrapper_engages_all_72_layers():
    """`drivers/detect.py::installed` measures Mish (`detect.mish_ms`,
    `detect.mish_roofline`) by wrapping `darknet_cfg._activate(x, kind)`,
    which the forward must still call through the module's name: one
    `mish` span and note a layer, each note its output's elements, the
    same elements the program counts."""
    assert list(inspect.signature(tcfg._activate).parameters) == [
        'x', 'kind']
    size, frames = 64, 2
    cfg = dict(CFG, image=size)
    torch.manual_seed(0)
    det = CfgDetector(kind.cfg_text(cfg), labels=cfg['labels'],
                      device='cpu')
    plan, shapes = plan_and_shapes(size)
    want = [frames * h * w * c for layer, (h, w, c) in zip(plan, shapes)
            if layer[0] == 'conv' and layer[5] == 'mish']
    tracer, recorder = trace.Tracer(profile=False), Recorder()
    activate = tcfg._activate
    x = torch.rand(frames, size, size, 3)
    with detect.installed(tracer, det), recording(recorder), \
            torch.no_grad():
        tracer.start()
        det.module(x)
        tracer.stop()
    assert tcfg._activate is activate
    assert len(want) == 72 and tracer.notes['mish'] == want
    assert tracer.host_s['mish'] > 0
    counters = recorder.reading()['counters']
    assert counters['mish.elements'] == sum(want)
    assert counters['mish.kernel_elements'] == 0
