"""Faster R-CNN VGG16 in the port (`models/faster_rcnn.py`,
`ops/proposals.py`, `ops/cuda/roi_pool.py`), held to the benchmark's plain
reference (`portbench/reference/frcnn.py`, written from py-faster-rcnn's
test net and settings). The JAX package has no two-stage detector.

- The nine anchors are `generate_anchors(16, (0.5, 1, 2), (8, 16, 32))`'s,
  shifted in (h, w, a) order; the trunk's ceil-mode pools give 36x63 at
  562x1000 while `VGG16` keeps its floor-mode pools; the weight spec is
  the program's state dict (137.1 M parameters) and the operations are
  429.1 GFLOP a frame.
- The proposal layer equals the reference's, with ties broken by the
  lower anchor index, the minimum size applied, and an image short of
  proposals keeping fewer, marked.
- The RoI-pooling twin equals the reference's Caffe arithmetic: C's round
  at half-integer coordinates (where torch.round differs), empty bins,
  RoIs at and past the map's edge, and the float32 bin of a RoI 57 cells
  wide; the custom op passes opcheck.
- At full widths on 96x160 frames (proposal counts cut to 300 and 50):
  the program's stages equal the reference's in float64; in float32 the
  program lies no further from float64 than three times the reference's
  own distance; its RoIs and detections equal the reference's on the
  program's own outputs.
- Kernel 1's twin at K = 6,000 is greedy NMS.
- The detector's spans and counters with a recorder, and nothing without.

Tests marked `card` hold the RoI-pooling kernel to its twin bit for bit
at the cell's widths (B=8, 300 RoIs an image, 512x36x63), and kernel 1
to its twin at K = 6,000 and 8,192; they skip without a card. This file
imports no JAX, so on the card's machine it runs alone:

    python -m pytest --noconftest -q tests/test_torch_faster_rcnn.py
"""

import math
import re

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch.models.faster_rcnn import (
    FasterRCNN, FasterRCNNDetector)
from object_tracking_tpu_torch.models.vgg16 import VGG16
from object_tracking_tpu_torch.ops import proposals as props
from object_tracking_tpu_torch.ops.cuda import _build
from object_tracking_tpu_torch.ops.cuda import nms as cuda_nms
from object_tracking_tpu_torch.ops.cuda import roi_pool as cuda_roi
from object_tracking_tpu_torch.utils.profiling import Recorder, recording
from portbench import cells, weights
from portbench.drivers import rcnn as driver
from portbench.models import frcnn as kind
from portbench.reference import frcnn as ref

CFG = cells.cell('frcnn_detect_b8').config
PUBLISHED = [[-84, -40, 99, 55], [-176, -88, 191, 103],
             [-360, -184, 375, 199], [-56, -56, 71, 71],
             [-120, -120, 135, 135], [-248, -248, 263, 263],
             [-36, -80, 51, 95], [-80, -168, 95, 183],
             [-168, -344, 183, 359]]
HW, B = (96, 160), 2
SMALL = dict(CFG, image_hw=list(HW), pre_nms_top_n=300, post_nms_top_n=50)
SPANS = {'detect', 'detect.h2d', 'detect.forward', 'detect.proposals',
         'detect.roi_pool', 'detect.box_head', 'detect.decode_nms',
         'detect.fetch', 'detect.results'}


def rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


# ------------------------------------------------------------- the net
def test_the_nine_anchors_are_the_published_ones():
    assert props.generate_anchors().tolist() == PUBLISHED
    assert ref.anchors_of(16, (0.5, 1, 2), (8, 16, 32)).tolist() == PUBLISHED
    assert CFG['anchors'] == PUBLISHED


def test_anchors_shift_with_the_shifts_outer_and_anchors_inner():
    base = props.generate_anchors()
    got = props.shifted_anchors(base, 3, 4, 16, 'cpu')
    assert torch.equal(got, ref.all_anchors(CFG, 3, 4, 'cpu'))
    for h, w, a in ((0, 0, 0), (1, 2, 5), (2, 3, 8)):
        assert got[(h * 4 + w) * 9 + a].tolist() == (
            base[a] + 16 * np.array([w, h, w, h])).tolist()


def test_trunk_pools_in_ceil_mode_and_vgg16_keeps_floor_mode():
    with torch.device('meta'):
        model = FasterRCNN()
        conv5 = model.trunk(torch.empty(1, 562, 1000, 3))
        vgg = VGG16(fc_features=8)
        floor = vgg(torch.empty(1, 100, 100, 3))['conv5_3']
        ceil = model.trunk(torch.empty(1, 100, 100, 3))
    assert tuple(conv5.shape) == (1, 512, 36, 63)
    assert ref.feature_hw(562, 1000) == (36, 63)
    assert tuple(floor.shape) == (1, 6, 6, 512)     # 100 → 50 → 25 → 12 → 6
    assert tuple(ceil.shape) == (1, 512, 7, 7)      # 100 → 50 → 25 → 13 → 7


def test_weight_spec_is_the_programs_state_dict():
    with torch.device('meta'):
        model = kind.program(CFG, torch.float32)
    state = model.state_dict()
    spec = kind.weight_spec(CFG)
    assert [name for name, *_ in spec] == list(state)
    assert all(tuple(state[n].shape) == s for n, s, *_ in spec)
    count = sum(math.prod(shape) for _, shape, *_ in spec)
    assert 137.0e6 < count < 137.2e6     # 548 MB in float32


def test_operations_are_429_gflop_a_frame():
    rows = dict((n, f) for n, f, _ in kind.conv_table(CFG))
    trunk = sum(f for n, f in rows.items() if n.startswith('conv'))
    rpn = sum(f for n, f in rows.items() if n.startswith('rpn'))
    head = rows['fc6'] + rows['fc7'] + rows['cls_score'] + rows['bbox_pred']
    assert abs(trunk / 346.3e9 - 1) < 0.005
    assert abs(rpn / 10.8e9 - 1) < 0.01
    assert abs(head / 72.0e9 - 1) < 0.005
    assert abs(sum(rows.values()) / 429.1e9 - 1) < 0.02


# ------------------------------------------------------- proposal layer
def _rpn_outputs(seed, b, gh, gw, ties=False):
    g = torch.Generator().manual_seed(seed)
    n = gh * gw * 9
    fg = torch.rand(b, n, generator=g)
    if ties:        # four values: most candidates tie
        fg = torch.floor(fg * 4) / 4 + 0.1
    deltas = torch.randn(b, n, 4, generator=g) * 0.15
    # a few boxes shrunk below the minimum size
    deltas[:, ::17, 2:] = -4.0
    return fg, deltas


def _program_proposals(cfg, fg, deltas, gh, gw):
    with torch.device('meta'):
        model = FasterRCNN(settings=kind.settings(cfg))
    hw = (gh * 16, gw * 16)
    model._constants[('anchors', fg.device, gh, gw)] = \
        props.shifted_anchors(model.base_anchors, gh, gw, 16, fg.device)
    return model.propose(fg, deltas, hw, (gh, gw))


@pytest.mark.parametrize('ties', [False, True])
def test_proposal_layer_equals_the_reference(ties):
    gh, gw = 8, 12
    cfg = dict(CFG, pre_nms_top_n=500, post_nms_top_n=100)
    fg, deltas = _rpn_outputs(3 + ties, 2, gh, gw, ties)
    recorder = Recorder()
    with recording(recorder):
        rois, valid = _program_proposals(cfg, fg, deltas, gh, gw)
    want = ref.proposals(fg, deltas, cfg, (gh * 16, gw * 16))
    for r, v, p in zip(rois, valid, want):
        assert driver.same_rois(r, v, p)
        assert torch.equal(r[:len(p)], p)
        assert not r[len(p):].any()
    # the filter removes the shrunken boxes before the top 500
    boxes = props.clip(props.decode(
        props.shifted_anchors(props.generate_anchors(), gh, gw, 16, 'cpu'),
        deltas), gh * 16, gw * 16)
    small = ((boxes[..., 2] - boxes[..., 0] + 1) < 16 * CFG['scale']).sum()
    assert small > 0
    counters = recorder.reading()['counters']
    assert counters['rcnn.pre_nms'] == 2 * 500
    assert counters['rcnn.proposals'] == int(valid.sum())


def test_ties_break_by_the_lower_anchor_index():
    """Every score equal: the walk takes the anchors in index order, so
    the first proposal is anchor 0's box and each kept box comes after
    the ones it could have suppressed. (Zero deltas move x2 and y2 by +1:
    py-faster-rcnn's `bbox_transform_inv` adds half the +1 width to
    both sides.)"""
    gh, gw = 4, 5
    cfg = dict(CFG, pre_nms_top_n=180, post_nms_top_n=40)
    fg = torch.full((1, gh * gw * 9), 0.5)
    deltas = torch.zeros(1, gh * gw * 9, 4)
    rois, valid = _program_proposals(cfg, fg, deltas, gh, gw)
    anchors = props.clip(props.decode(props.shifted_anchors(
        props.generate_anchors(), gh, gw, 16, 'cpu'), deltas[0]),
        gh * 16, gw * 16)
    assert torch.equal(rois[0, 0], anchors[0])
    want = ref.proposals(fg, deltas, cfg, (gh * 16, gw * 16))[0]
    assert torch.equal(rois[0, :len(want)], want)
    index = [int((anchors == r).all(-1).nonzero()[0]) for r in want]
    assert index == sorted(index)


def test_an_image_short_of_proposals_keeps_fewer_marked():
    gh, gw = 2, 2
    cfg = dict(CFG, pre_nms_top_n=36, post_nms_top_n=30)
    fg, deltas = _rpn_outputs(5, 2, gh, gw)
    recorder = Recorder()
    with recording(recorder):
        rois, valid = _program_proposals(cfg, fg, deltas, gh, gw)
    want = ref.proposals(fg, deltas, cfg, (gh * 16, gw * 16))
    assert [int(v.sum()) for v in valid] == [len(p) for p in want]
    assert all(len(p) < 30 for p in want)
    assert not rois[~valid].any()
    assert recorder.reading()['counters']['rcnn.short_images'] == 2


# ---------------------------------------------------------- RoI pooling
def _pool_case(seed=0):
    g = torch.Generator().manual_seed(seed)
    features = torch.randn(2, 16, 9, 13, generator=g)
    rois = torch.tensor([
        [[8.0, 24.0, 40.0, 88.0],        # ×1/16: 0.5, 1.5, 2.5, 5.5
         [0.0, 0.0, 207.0, 143.0],       # the whole map
         [40.0, 40.0, 40.0, 40.0],       # one cell, at 2.5
         [180.0, 120.0, 500.0, 400.0],   # past the right and bottom edge
         [-100.0, -60.0, 20.0, 30.0],    # before the left and top edge
         [300.0, 300.0, 310.0, 310.0]],  # outside: every bin empty
        [[72.0, 8.0, 168.0, 104.0],      # 4.5, 0.5, 10.5, 6.5
         [23.9, 7.99, 24.1, 8.01],
         [56.0, 40.0, 200.0, 136.0],
         [1.0, 2.0, 3.0, 4.0],
         [120.0, 0.0, 8.0, 50.0],        # x2 < x1: width 1
         [0.0, 0.0, 0.0, 0.0]]])
    return features, rois


def _reference_pool(features, rois, scale=1 / 16):
    b, r, _ = rois.shape
    image = torch.arange(b).repeat_interleave(r)
    return ref.roi_pool(features, rois.reshape(-1, 4), image, scale
                        ).reshape(b, r, features.shape[1], 7, 7)


def test_roi_pool_twin_equals_the_reference():
    features, rois = _pool_case()
    got = cuda_roi.roi_pool(features, rois, 1 / 16)
    assert got.shape == (2, 6, 16, 7, 7)
    assert torch.equal(got, _reference_pool(features, rois))
    assert not got[0, 5].any()                   # empty bins read 0
    whole = got[0, 1]
    assert torch.equal(whole.amax((1, 2)), features[0].amax((1, 2)))


def test_roi_pool_rounds_half_away_from_zero(monkeypatch):
    """torch.round's half to even moves the RoIs at half-integer cells:
    the pooled values differ from the reference's."""
    features, rois = _pool_case()
    assert cuda_roi.c_round(torch.tensor([0.5, 1.5, 2.5, -2.5, 2.4999])
                            ).tolist() == [1, 2, 3, -3, 2]
    monkeypatch.setattr(cuda_roi, 'c_round', torch.round)
    got = cuda_roi.roi_pool(features, rois, 1 / 16)
    assert not torch.equal(got, _reference_pool(features, rois))


def test_roi_pool_keeps_caffes_float_bins_at_width_57():
    """7·fl(57/7) rounds above 57 in float32: the last bin of a RoI 57
    cells wide reaches one cell past it, as Caffe's float arithmetic
    does (an exact integer bin would stop at 57)."""
    features = torch.zeros(1, 1, 1, 64)
    features[0, 0, 0, 57] = 5.0
    rois = torch.tensor([[[0.0, 0.0, 56 * 16.0, 0.0]]])
    got = cuda_roi.roi_pool(features, rois, 1 / 16)
    assert float(got[0, 0, 0, 0, 6]) == 5.0
    assert math.ceil(np.float32(7) * (np.float32(57) / np.float32(7))) == 58
    assert torch.equal(got, _reference_pool(features, rois))


def test_roi_pool_op_passes_opcheck_and_refuses_other_types():
    features, rois = _pool_case()
    torch.library.opcheck(torch.ops.ott_torch.roi_pool.default,
                          (features, rois, 0.0625, 7, 7))
    with pytest.raises(TypeError):
        cuda_roi.roi_pool(features.half(), rois.half(), 1 / 16)
    with pytest.raises(ValueError):
        cuda_roi.roi_pool(features, rois, 1 / 16, (9, 9))


def test_roi_pool_constants_equal_the_kernels():
    text = (_build.CSRC / 'roi_pool.cu').read_text()
    found = dict(re.findall(r'constexpr int (k\w+) = (\d+);', text))
    assert int(found['kMaxBins']) == cuda_roi.MAX_BINS
    assert re.search(r'constexpr float kClamp = 1e6f;', text)
    assert cuda_roi.CLAMP == 1e6


# ------------------------------------ the whole model at full widths
@pytest.fixture(scope='module')
def small():
    """Seeded weights (the benchmark's draw), two 96x160 frames of the
    cell's scenes, and the program's module loaded with the weights."""
    mix = dict(cells.cell('frcnn_detect_b8').traffic, streams=B, pool=1)
    frames = torch.from_numpy(driver.frames_pool(mix, SMALL, 2**31 + 13)[0])
    w = weights.make(SMALL, 2**31 + 13, 'cpu')
    return frames, w, program(w)


def program(w):
    """The program's module holding `w` itself (no init, no copy)."""
    with torch.device('meta'):
        model = kind.program(SMALL, torch.float32)
    model.load_state_dict(w, assign=True)
    return model.eval()


def test_program_stages_equal_the_reference_in_float64(small):
    frames, w, model = small
    w64 = {k: v.double() for k, v in w.items()}
    model64 = program(w64)
    with torch.no_grad():
        want = ref.forward(w64, frames.double(), SMALL)
        conv5 = model64.trunk(frames.double())
        fg, deltas = model64.rpn(conv5)
        assert rel(conv5, want['conv5_3']) < 1e-12
        assert rel(fg, want['rpn_fg']) < 1e-12
        assert rel(deltas, want['rpn_deltas']) < 1e-12
        rois = torch.zeros(B, 50, 4, dtype=torch.float64)
        for i, p in enumerate(ref.proposals(
                fg.float(), deltas.float(), SMALL, HW)):
            rois[i, :len(p)] = p.double()
        cls, box = model64.box_head(model64.pool(conv5, rois))
        want_cls, want_box = ref.pool_and_head(w64, want['conv5_3'], rois,
                                               1 / 16)
    assert rel(cls, want_cls) < 1e-12 and rel(box, want_box) < 1e-12


def test_program_float32_is_as_close_to_float64_as_the_reference(small):
    """The program's float32 outputs lie within 3x the reference's own
    float32 distance from float64, stage by stage on the program's own
    outputs; its RoIs equal the reference's proposal layer's on its own
    RPN outputs."""
    frames, w, model = small
    w64 = {k: v.double() for k, v in w.items()}
    with torch.no_grad():
        out = model(frames)
        exact = ref.forward(w64, frames.double(), SMALL)
        ref32 = ref.forward(w, frames, SMALL)
        for key in ('conv5_3', 'rpn_fg', 'rpn_deltas'):
            assert out[key].dtype == torch.float32
            assert rel(out[key], exact[key]) < \
                3 * rel(ref32[key], exact[key]) + 1e-7, key
        want = ref.proposals(out['rpn_fg'], out['rpn_deltas'], SMALL, HW)
        assert all(driver.same_rois(r, v, p) for r, v, p in
                   zip(out['rois'], out['roi_valid'], want))
        assert out['roi_valid'].sum(1).min() > 10
        cls64, box64 = ref.pool_and_head(w64, out['conv5_3'].double(),
                                         out['rois'].double(), 1 / 16)
        cls32, box32 = ref.pool_and_head(w, out['conv5_3'], out['rois'],
                                         1 / 16)
    assert rel(out['cls_prob'], cls64) < 3 * rel(cls32, cls64) + 1e-7
    assert rel(out['bbox_pred'], box64) < 3 * rel(box32, box64) + 1e-7


def test_detections_equal_the_references_on_the_programs_outputs(small):
    frames, _, model = small
    det = FasterRCNNDetector(labels=CFG['labels'], device='cpu',
                             module=model)
    grabbed = []
    hook = det.module.register_forward_hook(
        lambda m, a, out: grabbed.append(out))
    try:
        got = det.detect_images(frames.numpy())
    finally:
        hook.remove()
    want = kind.reference_detections(grabbed[0], SMALL)
    assert len(got) == len(want) == B and all(got)
    for g, wf in zip(got, want):
        assert [d[0] for d in g] == [CFG['labels'][c] for c, _, _ in wf]
        np.testing.assert_allclose([d[1] for d in g], [s for _, s, _ in wf],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose([d[2] for d in g], [b for _, _, b in wf],
                                   rtol=0, atol=1e-6)
        assert all(d[1] > CFG['score_thresh'] for d in g)


def test_spans_and_counters_with_a_recorder_and_none_without(small,
                                                            monkeypatch):
    frames, _, model = small
    det = FasterRCNNDetector(labels=CFG['labels'], device='cpu',
                             module=model)
    recorder = Recorder()
    with recording(recorder):
        got = det.detect_images(frames.numpy())
    reading = recorder.reading()
    assert {s.name for s in reading['spans']} == SPANS
    parents = {s.name: reading['spans'][s.parent].name
               for s in reading['spans'] if s.parent is not None}
    for name in ('detect.proposals', 'detect.roi_pool', 'detect.box_head'):
        assert parents[name] == 'detect.forward'
    counters = reading['counters']
    assert counters['rcnn.pre_nms'] == B * 300
    assert counters['roi_pool.rois'] == B * 50
    assert counters['roi_pool.kernel_rois'] == 0
    assert counters['rcnn.detections'] == sum(map(len, got))
    assert set(counters) == {
        'rcnn.pre_nms', 'rcnn.proposals', 'rcnn.short_images',
        'roi_pool.rois', 'roi_pool.kernel_rois', 'rcnn.detections',
        'rcnn.capped'}

    def refuse(self, name, value):
        raise AssertionError(f'counter {name} recorded without a recorder')
    monkeypatch.setattr(Recorder, 'add', refuse)
    det.detect_images(frames.numpy())


# ------------------------------------------------------------ kernel 1
def test_kernel_1_twin_at_6000_candidates_is_greedy_nms():
    """The proposal NMS's shape: 6,000 candidates of one frame and one
    class, ranked scores, at IoU 0.7."""
    g = torch.Generator().manual_seed(7)
    corners = props.clip(props.decode(
        props.shifted_anchors(props.generate_anchors(), 30, 25, 16, 'cpu')
        [:6000], torch.randn(6000, 4, generator=g) * 0.2), 480, 400)
    centre = props.centre_form(corners)
    score = torch.arange(6000, 0, -1, dtype=torch.float32)
    out = cuda_nms.nms_scores(centre[None], score[None, :, None], 0.7)
    kept = torch.nonzero(out[0, :, 0] > 0)[:, 0].tolist()
    assert kept == ref.greedy_nms(centre, np.arange(6000), 0.7, 6000)
    assert 300 < len(kept) < 6000


# ----------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the RoI-pooling kernel and kernel 1 '
                    'have no CPU mode')
    return torch.device('cuda', 0)


@pytest.mark.card
def test_roi_pool_kernel_equals_its_twin_at_the_cells_widths(card):
    g = torch.Generator(device=card).manual_seed(11)
    features = torch.relu(torch.randn(8, 512, 36, 63, generator=g,
                                      device=card))
    features = features.contiguous(memory_format=torch.channels_last)
    corners = torch.rand(8, 300, 4, generator=g, device=card) * 1100 - 50
    rois = torch.cat([corners[..., :2].minimum(corners[..., 2:]),
                      corners[..., :2].maximum(corners[..., 2:])], -1)
    rois[:, :40] = torch.floor(rois[:, :40] / 8) * 8   # half cells and whole
    rois[:, 40:50] = torch.tensor([0.0, 0.0, 999.0, 561.0], device=card)
    features[0, 3, 5, 7] = float('nan')
    before = cuda_roi.roi_pool.launches
    got = cuda_roi.roi_pool(features, rois, 1 / 16)
    torch.cuda.synchronize()
    assert cuda_roi.roi_pool.launches == before + 1
    want = cuda_roi.roi_pool_plain(features, rois, 1 / 16)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    with pytest.raises(TypeError):
        cuda_roi.roi_pool(features.double(), rois.double(), 1 / 16)


@pytest.mark.card
@pytest.mark.parametrize('k', [6000, 8192])
@pytest.mark.parametrize('ranked', [False, True])
def test_kernel_1_equals_its_twin_past_4096(card, k, ranked):
    g = torch.Generator(device=card).manual_seed(k + ranked)
    f = 3
    xy = torch.rand(f, k, 2, generator=g, device=card) * 900
    wh = torch.rand(f, k, 2, generator=g, device=card) * 200 + 10
    boxes = torch.cat([xy, wh], -1).contiguous()
    scores = torch.rand(f, k, 1, generator=g, device=card)
    if ranked:      # sorted input, as the proposal NMS gives it
        scores = torch.arange(k, 0, -1, dtype=torch.float32, device=card
                              ).expand(f, k)[..., None].contiguous()
    scores[:, ::7] = 0.0
    got = cuda_nms.nms_scores(boxes, scores, 0.7)
    torch.cuda.synchronize()
    want = cuda_nms.nms_scores_plain(boxes, scores, 0.7)
    assert torch.equal(got, want)
