"""The plain reference against the port at a tiny width on the CPU: the
same weights and inputs give the same answers, layer by layer, and every
cell cut small runs correct end to end."""

import numpy as np
import pytest
import torch

from portbench import traffic, weights
from portbench.drivers.common import program_model
from portbench.reference import model as ref_model
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.tests import tiny

torch.set_num_threads(2)


def close(a, b, tol=1e-4):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12)) < tol


@pytest.fixture(scope='module')
def joint():
    cfg = tiny.cell('joint_serve_b8').config
    w = weights.make(cfg, 5, 'cpu')
    return cfg, w, program_model(cfg, w, 'cpu').eval()


def test_joint_forward(joint):
    cfg, w, model = joint
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 4, 64, 64, 3), generator=g)
    state = tuple(torch.randn((2, 2, 2, 32), generator=g) for _ in range(2))
    with torch.no_grad():
        got = model(images, train=True, initial_state=state,
                    return_state=True)
        want = ref_model.joint_forward(w, cfg, images, state)
    for key in ('track', 'detect'):
        assert close(got[key], want[key])
    for g_s, w_s in zip(got['state'], want['state']):
        assert close(g_s, w_s)


def test_detector_forward():
    cfg = tiny.cell('yolov2_train_b32').config
    w = weights.make(cfg, 6, 'cpu')
    model = program_model(cfg, w, 'cpu').eval()
    images = torch.rand((3, 64, 64, 3), generator=torch.Generator()
                        .manual_seed(1))
    with torch.no_grad():
        got = model(images, train=True)['netout']
    assert close(got, ref_model.detector_forward(w, cfg, images)['netout'])


@pytest.mark.parametrize('n_side', [2, 13])
def test_decode_and_nms(n_side):
    from object_tracking_tpu_torch.ops.decode import decode_and_nms
    cfg = tiny.cell('joint_serve_b8').config
    g = torch.Generator().manual_seed(n_side)
    net = torch.randn((2, 4, n_side, n_side, 5, 17), generator=g) * 2
    got = decode_and_nms(net, torch.tensor(cfg['anchors']), 0.05, 0.45, 128,
                         nms_impl='op')
    want = ref_serve.detections(net, cfg['anchors'], 0.05, 0.45, 128)
    assert np.array_equal(got[0].numpy(), want[0])
    for g_a, w_a in zip(got[1:], want[1:]):
        assert np.array_equal(g_a.numpy(), w_a)


def test_assign_tracks():
    from object_tracking_tpu_torch.ops.matching import (
        assign_tracks, init_track_state)
    rng = np.random.default_rng(0)
    b, s, m = 3, 6, 10
    state = init_track_state(s, b, 'cpu')
    tables = [ref_serve.empty_tracks(s) for _ in range(b)]
    for _ in range(40):
        boxes = rng.uniform(0.2, 0.4, (b, m, 4)).astype(np.float32)
        labels = rng.integers(0, 2, (b, m))
        valid = rng.uniform(size=(b, m)) < 0.6
        state, ids = assign_tracks(state, torch.tensor(boxes),
                                   torch.tensor(labels), torch.tensor(valid),
                                   0.3, 3)
        for i in range(b):
            tables[i], want = ref_serve.assign(tables[i], boxes[i],
                                               labels[i], valid[i], 0.3, 3)
            assert np.array_equal(ids[i].numpy(), want)
            assert np.array_equal(state.ids[i].numpy(), tables[i]['ids'])
            assert np.allclose(state.boxes[i].numpy(), tables[i]['boxes'])


def test_augmentation_and_targets():
    from object_tracking_tpu_torch.data.augment import augment_sequences_batch
    from object_tracking_tpu_torch.ops.targets import encode_targets_batch
    cfg = tiny.cell('joint_train_b4').config
    raw = traffic.train_pool({'batch': 4, 'window': 2, 'pool': 1,
                              'objects': 5}, cfg, 3)[0]
    images = torch.as_tensor(raw['images_u8']).float() / 255.0
    boxes = torch.as_tensor(raw['boxes'])
    got_i, got_b = augment_sequences_batch(raw['aug_seeds'], images, boxes)
    for i, seed in enumerate(raw['aug_seeds']):
        want_i, want_b = ref_train.augment_window(int(seed), images[i],
                                                  boxes[i])
        assert close(got_i[i], want_i, 1e-5)
        assert close(got_b[i], want_b, 1e-5)
    flat = got_b.reshape(8, -1, 4)
    y, tb = encode_targets_batch(
        flat, torch.as_tensor(raw['cls']).reshape(8, -1),
        torch.as_tensor(raw['valid']).reshape(8, -1), cfg['anchors'],
        image_h=64, image_w=64, grid_h=2, grid_w=2, num_classes=12)
    want_y, want_tb = ref_train.encode_targets(
        flat.numpy(), raw['cls'].reshape(8, -1), raw['valid'].reshape(8, -1),
        cfg)
    assert np.allclose(y.numpy(), want_y, atol=1e-5)
    assert np.allclose(tb.numpy(), want_tb, atol=1e-5)


def test_yolo_loss():
    from object_tracking_tpu_torch.models.losses import yolo_loss
    cfg = tiny.cell('yolov2_train_b32').config
    raw = traffic.train_pool({'batch': 6, 'window': 1, 'pool': 1,
                              'objects': 6}, cfg, 4)[0]
    y, tb = ref_train.encode_targets(raw['boxes'][:, 0], raw['cls'][:, 0],
                                     raw['valid'][:, 0], cfg)
    pred = torch.randn((6, 2, 2, 5, 85), generator=torch.Generator()
                       .manual_seed(2))
    got, _ = yolo_loss(pred, torch.as_tensor(y), torch.as_tensor(tb),
                       cfg['anchors'])
    want = ref_train.yolo_loss(pred, torch.as_tensor(y), torch.as_tensor(tb),
                               cfg['anchors'], cfg['loss'])
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize('workload', ['joint_serve_b8', 'joint_live_b1',
                                      'joint_train_b4', 'yolov2_train_b32'])
def test_cut_cell_runs_correct(workload):
    result = tiny.run(workload)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 6 and result['failed'] == 0
