"""The Faster R-CNN cell (`frcnn_detect_b8`, `drivers/rcnn.py`) run by
`run_cell` on the CPU at full widths on 105x169 frames, two streams, the
proposal counts cut to 300 and 50: `correct`, the traced run's spans and
notes; and each planted fault makes it not correct, by the number it
should move:

- proposals without NMS (the proposal layer's NMS at IoU 1.01): `rois`;
- half the batch left out (the first half's frames served twice): `rpn`;
- RoI pooling at a scale of 1/32: `head`;
- RoI pooling rounding with torch.round (half to even): `head`. It moves
  only RoIs with a coordinate on a half cell; on these frames the RoIs
  clipped to the last column and row lie on one (168/16 = 10.5 and
  104/16 = 6.5), at the cell's 562x1000 none does (999/16, 561/16);
- class-agnostic NMS over the detections: `answers`;
- the class probabilities returned as NaN: `head`;
- the control, the reference in TF32 in the program's place (on the card
  only: TF32 does not exist on the CPU).

The same faults at the cell's own size, and the control, run on the card
(`card` marker), printing what the check read:

    python -m pytest portbench/tests/test_portbench_frcnn.py -q -s -m card
"""

import json
import time

import pytest
import torch

from portbench import cells, traffic
from portbench.drivers.common import Context
from portbench.models import frcnn as kind
from portbench.run import run_cell

SEED = 2**31 + 31


def small():
    c = cells.cell('frcnn_detect_b8')
    c.config.update(image_hw=[105, 169], pre_nms_top_n=300,
                    post_nms_top_n=50)
    c.traffic.update(streams=2, pool=3, check_span=6, check_calls=2,
                     warmup=1, trace_calls=2)
    return c


def run(program=None):
    torch.set_num_threads(2)
    return run_cell(small(), SEED, 0.0, False, torch.device('cpu'),
                    time.perf_counter(), program=program,
                    min_units=6)['result']


def test_cell_is_correct():
    result = run()
    assert result['correct'], result['checks']
    assert result['attempted'] == 6 and result['failed'] == 0
    assert set(result['checks']) == {'rpn', 'rois', 'head', 'answers'}
    assert set(result['metrics']) == {'frames_per_s', 'setup_s'}


def test_traced_run_holds_the_spans_and_notes_the_metrics_read():
    """The CPU launches no device kernel, so the readers find no device
    time; the spans they read and the RoI-pooling notes are there."""
    c = small()
    torch.set_num_threads(2)
    out = c.driver().run(Context(
        config=c.config, traffic=c.traffic, seed=SEED, seconds=0.0,
        trace=True, device=torch.device('cpu'), t0=time.perf_counter(),
        min_units=6))
    reading = out.reading
    assert reading['units'] == reading['host']['units'] == 2
    for span in ('model', 'proposals', 'roi_pool', 'box_head',
                 'nms_scores', 'call'):
        assert reading['span_host_s'][span] > 0, span
    # one pooling launch a call: 2 images x 50 RoIs x 512 channels x 7x7
    # bins, over a 7x11 map
    assert reading['notes']['roi_pool'] == [(100, 512, 49, 2 * 512 * 77)] * 2
    assert len(reading['notes']['nms']) == 2 * 2    # proposals, detections
    assert reading['host']['flops'] == 2 * 2 * sum(
        f for _, f, _ in kind.conv_table(c.config))
    assert all(cells.reader(m['name'])(reading) is None
               for m in c.per_layer)


def _no_proposal_nms(monkeypatch):
    from object_tracking_tpu_torch.models import faster_rcnn
    propose = faster_rcnn.propose

    def unsuppressed(*args):
        return propose(*args[:-1], 1.01)
    monkeypatch.setattr(faster_rcnn, 'propose', unsuppressed)


def _half_batch(monkeypatch):
    from object_tracking_tpu_torch.models.faster_rcnn import FasterRCNN
    forward = FasterRCNN.forward

    def half(self, images):
        keep = max(images.shape[0] // 2, 1)
        return forward(self, images[:keep].repeat(
            -(-images.shape[0] // keep), 1, 1, 1)[:images.shape[0]])
    monkeypatch.setattr(FasterRCNN, 'forward', half)


def _roi_scale_1_32(monkeypatch):
    from object_tracking_tpu_torch.models.faster_rcnn import (
        FasterRCNN, roi_pool)
    monkeypatch.setattr(FasterRCNN, 'pool', lambda self, conv5, rois:
                        roi_pool(conv5, rois, 1 / 32, (7, 7)))


def _torch_round(monkeypatch):
    from object_tracking_tpu_torch.models.faster_rcnn import FasterRCNN
    from object_tracking_tpu_torch.ops.cuda import roi_pool
    monkeypatch.setattr(roi_pool, 'c_round', torch.round)
    monkeypatch.setattr(FasterRCNN, 'pool', lambda self, conv5, rois:
                        roi_pool.roi_pool_plain(conv5, rois, 1 / 16, (7, 7)))


def _class_agnostic(monkeypatch):
    """Every class's boxes of an image in one NMS: the image's R·(K−1)
    (RoI, class) boxes as one frame of candidates."""
    from object_tracking_tpu_torch.models import faster_rcnn
    from object_tracking_tpu_torch.ops import proposals as props

    def agnostic(cls_prob, bbox_pred, rois, valid, image_hw, score_thresh,
                 nms_thresh, max_per_image):
        h, w = image_hw
        b, r, k = cls_prob.shape
        boxes = props.clip(props.decode(
            rois[:, :, None, :], bbox_pred.reshape(b, r, k, 4)),
            h, w)[:, :, 1:].transpose(1, 2).reshape(b, -1, 4)
        scores = cls_prob[:, :, 1:].transpose(1, 2).reshape(b, -1)
        live = (scores > score_thresh) & valid.repeat(1, k - 1)
        scores = torch.where(live, scores, torch.zeros_like(scores))
        kept = props._nms(props.centre_form(boxes), scores[..., None],
                          nms_thresh)[..., 0]
        best = torch.sort(kept, dim=1, descending=True, stable=True)
        top = best.values[:, :max_per_image]
        index = best.indices[:, :max_per_image]
        picked = props._gather_rows(props.centre_form(boxes), index)
        size = torch.full((4,), float(w))
        size[1::2] = float(h)
        return picked / size.to(picked.device), index // r + 1, top, top > 0
    monkeypatch.setattr(faster_rcnn, 'class_detections', agnostic)


def _nan_scores(monkeypatch):
    from object_tracking_tpu_torch.models.faster_rcnn import FasterRCNN
    box_head = FasterRCNN.box_head

    def nan(self, pooled):
        cls, box = box_head(self, pooled)
        return torch.full_like(cls, float('nan')), box
    monkeypatch.setattr(FasterRCNN, 'box_head', nan)


FAULTS = [(_no_proposal_nms, 'rois'), (_half_batch, 'rpn'),
          (_roi_scale_1_32, 'head'), (_torch_round, 'head'),
          (_class_agnostic, 'answers'), (_nan_scores, 'head')]


@pytest.mark.parametrize('plant,number', FAULTS)
def test_fault_is_not_correct(monkeypatch, plant, number):
    plant(monkeypatch)
    result = run()
    assert not result['correct']
    check = result['checks'][number]
    assert not check['value'] <= check['limit'], result['checks']


def _until_checked(seed):
    mix = cells.cell('frcnn_detect_b8').traffic
    return max(traffic.sample_calls(seed, mix['check_calls'],
                                    mix['check_span'])) + 1


@pytest.mark.card
@pytest.mark.parametrize('plant,number', FAULTS)
def test_fault_is_not_correct_at_size(card, monkeypatch, plant, number):
    """At 562x1000, B=8, every checked call inside the window. The
    torch.round fault moves nothing here (module docstring): it reads
    correct at this size, and the test says so."""
    plant(monkeypatch)
    c = cells.cell('frcnn_detect_b8')
    for seed in (2**31 + 211,):
        result = run_cell(c, seed, 0.0, False, card, time.perf_counter(),
                          min_units=_until_checked(seed))['result']
        print(json.dumps({'fault': plant.__name__, 'seed': seed,
                          'checks': result['checks']}))
        check = result['checks'][number]
        if plant is _torch_round:
            assert result['correct'], (seed, result['checks'])
            continue
        assert not result['correct'], (seed, result['checks'])
        assert not check['value'] <= check['limit'], (seed, result['checks'])


@pytest.mark.card
def test_control_is_not_correct(card):
    from portbench.rcnn_control import control
    c = cells.cell('frcnn_detect_b8')
    for seed in (101, 102, 103):
        checks = control(c, seed, card)
        print(json.dumps({'control': seed, 'checks': checks}))
        assert any(not v['value'] <= v['limit'] for v in checks.values()), \
            checks
