"""The YOLOv4 detection cell (`yolov4_detect_b8`, `drivers/detect.py`)
run by `run_cell` on the CPU at full widths on 96x96 frames, two streams:
`correct`, with every traced per-layer metric read where the CPU has it;
and each planted fault makes it not correct, by the number it should
move:

- the program decoding with `scale_x_y` ignored: `answers`;
- half the batch left out (the first half's frames served twice): `heads`;
- a Mish replaced by a leaky ReLU: `heads`;
- one head returned as NaN (both decodes then find nothing there): `heads`;
- the control, the reference in TF32 in the program's place (on the card
  only: TF32 does not exist on the CPU): `heads`.

The same faults at the cell's own size, and the control, run on the card
(`card` marker), printing what the check read:

    python -m pytest portbench/tests/test_portbench_yolov4.py -q -s -m card
"""

import json
import time

import pytest
import torch

from portbench import cells, traffic
from portbench.drivers.common import Context
from portbench.drivers.detect import _same_frame
from portbench.models import yolov4
from portbench.run import run_cell

SEED = 2**31 + 29


def small():
    c = cells.cell('yolov4_detect_b8')
    c.config.update(image=96)
    c.traffic.update(streams=2, pool=3, check_span=6, check_calls=2,
                     live_candidates=8, warmup=1, trace_calls=2)
    return c


def run(trace=False, program=None):
    torch.set_num_threads(2)
    return run_cell(small(), SEED, 0.0, trace, torch.device('cpu'),
                    time.perf_counter(), program=program,
                    min_units=6)['result']


def test_cell_is_correct():
    result = run()
    assert result['correct'], result['checks']
    assert result['attempted'] == 6 and result['failed'] == 0
    assert set(result['checks']) == {'heads', 'answers'}
    assert set(result['metrics']) == {'frames_per_s', 'setup_s'}


def test_traced_run_holds_the_spans_and_notes_the_metrics_read():
    """The CPU launches no device kernel, so the readers find no device
    time; the spans they read and the Mish notes are there."""
    c = small()
    torch.set_num_threads(2)
    out = c.driver().run(Context(
        config=c.config, traffic=c.traffic, seed=SEED, seconds=0.0,
        trace=True, device=torch.device('cpu'), t0=time.perf_counter(),
        min_units=6))
    reading = out.reading
    assert reading['units'] == reading['host']['units'] == 2
    for span in ('model', 'mish', 'decode_nms', 'batch_norm', 'call'):
        assert reading['span_host_s'][span] > 0, span
    # 72 Mish layers a call, each over its output's elements
    mish = reading['notes']['mish']
    assert len(mish) == 2 * 72 and min(mish) > 0
    assert reading['host']['flops'] == 2 * 2 * sum(
        f for _, f, _ in yolov4.conv_table(c.config))
    assert all(cells.reader(m['name'])(reading) is None
               for m in c.per_layer)


def _scale_ignored(monkeypatch):
    from object_tracking_tpu_torch.models import darknet_cfg
    decode = darknet_cfg.decode_yolo3_netout

    def unscaled(netout, anchors, net_size, obj_threshold=0.5,
                 scale_x_y=1.0):
        return decode(netout, anchors, net_size, obj_threshold)
    monkeypatch.setattr(darknet_cfg, 'decode_yolo3_netout', unscaled)


def _half_batch(monkeypatch):
    from object_tracking_tpu_torch.models.darknet_cfg import DarknetCfgNet
    forward = DarknetCfgNet.forward

    def half(self, images, train=False):
        keep = max(images.shape[0] // 2, 1)
        return forward(self, images[:keep].repeat(
            -(-images.shape[0] // keep), 1, 1, 1)[:images.shape[0]], train)
    monkeypatch.setattr(DarknetCfgNet, 'forward', half)


def _mish_as_leaky(monkeypatch):
    from object_tracking_tpu_torch.models import darknet_cfg
    activate = darknet_cfg._activate
    monkeypatch.setattr(darknet_cfg, '_activate', lambda x, kind: activate(
        x, 'leaky' if kind == 'mish' else kind))


def _nan_head(monkeypatch):
    from object_tracking_tpu_torch.models.darknet_cfg import DarknetCfgNet
    forward = DarknetCfgNet.forward

    def nan(self, images, train=False):
        out = forward(self, images, train)
        out['heads'][1] = torch.full_like(out['heads'][1], float('nan'))
        return out
    monkeypatch.setattr(DarknetCfgNet, 'forward', nan)


FAULTS = [(_scale_ignored, 'answers'), (_half_batch, 'heads'),
          (_mish_as_leaky, 'heads'), (_nan_head, 'heads')]


@pytest.mark.parametrize('plant,number', FAULTS)
def test_fault_is_not_correct(monkeypatch, plant, number):
    plant(monkeypatch)
    result = run()
    assert not result['correct']
    check = result['checks'][number]
    assert check['value'] > check['limit'], result['checks']


def test_answers_differ_on_nan_and_agree_on_the_same_infinity():
    names = ['a', 'b']
    box = [0.5, 0.5, 0.1, 0.1]
    assert _same_frame([('b', 0.7, box)], [(1, 0.7, box)], names)
    assert not _same_frame([('b', float('nan'), box)], [(1, 0.7, box)],
                           names)
    assert not _same_frame([('b', 0.7, [float('nan')] * 4)],
                           [(1, 0.7, [float('nan')] * 4)], names)
    inf = [0.5, 0.5, float('inf'), float('inf')]
    assert _same_frame([('b', 0.7, inf)], [(1, 0.7, inf)], names)
    assert not _same_frame([('b', 0.7, inf)], [(1, 0.7, box)], names)


def _until_checked(seed):
    mix = cells.cell('yolov4_detect_b8').traffic
    return max(traffic.sample_calls(seed, mix['check_calls'],
                                    mix['check_span'])) + 1


@pytest.mark.card
@pytest.mark.parametrize('plant,number', FAULTS)
def test_fault_is_not_correct_at_size(card, monkeypatch, plant, number):
    """At 608x608, B=8, every checked call inside the window."""
    plant(monkeypatch)
    c = cells.cell('yolov4_detect_b8')
    for seed in (2**31 + 211, 2**31 + 212, 2**31 + 213):
        result = run_cell(c, seed, 0.0, False, card, time.perf_counter(),
                          min_units=_until_checked(seed))['result']
        print(json.dumps({'fault': plant.__name__, 'seed': seed,
                          'checks': result['checks']}))
        check = result['checks'][number]
        assert not result['correct'], (seed, result['checks'])
        assert not check['value'] <= check['limit'], (seed, result['checks'])


@pytest.mark.card
def test_control_is_not_correct_by_heads(card):
    from portbench.detect_control import control
    c = cells.cell('yolov4_detect_b8')
    for seed in (101, 102, 103):
        checks = control(c, seed, card)
        print(json.dumps({'control': seed, 'checks': checks}))
        assert checks['heads']['value'] > checks['heads']['limit'], checks
