"""Golden end-to-end detection through the port, on the CPU.

The committed fixtures are the repo's only trained weights: the
yolov2-micro cfg + darknet weights (golden_boxes.json) and the VGG16
micro npz (golden_vgg16.json), on the four scene images. The port's
CfgDetector and VGG16PriorSource must meet the JAX golden tests' criteria
(tests/test_golden_detect.py:85-105, tests/test_golden_vgg16.py:57-80):
same label, score within 0.05, IoU >= 0.8 with the golden box, and a top
box with IoU > 0.5 against the ground truth.

golden_scenes_160.npz holds the four scenes decoded as `detect` decodes
them (cv2 BGR → RGB, uint8, resized to 160²), so that a machine without
cv2 (chip_smoke.py on the card) detects on the same pixels.
"""

import json
import os

import numpy as np
import pytest

from object_tracking_tpu_torch.evaluation import evaluate_detection
from object_tracking_tpu_torch.models import CfgDetector, VGG16PriorSource
from object_tracking_tpu_torch.ops.weights import DarknetWeightReader

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
CFG = os.path.join(FIXTURES, 'yolov2-micro.cfg')
WEIGHTS = os.path.join(FIXTURES, 'yolov2-micro.weights')
NPZ = os.path.join(FIXTURES, 'vgg16-micro.npz')
SCENES = os.path.join(FIXTURES, 'golden_scenes_160.npz')


def _golden(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def detector():
    golden = _golden('golden_boxes.json')
    return CfgDetector(CFG, weights_path=WEIGHTS,
                       labels=tuple(golden['labels']), device='cpu')


@pytest.fixture(scope='module')
def source():
    golden = _golden('golden_vgg16.json')
    return VGG16PriorSource(
        image_h=golden['net'], image_w=golden['net'],
        det_labels=tuple(golden['labels']),
        fc_features=golden['fc_features'], width_div=golden['width_div'],
        weights_path=NPZ, device='cpu')


def _iou_center(a, b):
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax1, ay1 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx1, by1 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    return inter / max(a[2] * a[3] + b[2] * b[3] - inter, 1e-9)


def _meets_golden(scene, dets, net, min_score):
    gold = scene['detections']
    assert len(dets) == len(gold), (scene['file'], dets, gold)
    for (label, score, box), g in zip(dets, gold):
        assert label == g['label']
        assert abs(score - g['score']) < 0.05
        assert _iou_center(box, g['box_cxcywh']) >= 0.8
    x0, y0, x1, y1 = scene['gt_box_xyxy']
    gt = ((x0 + x1) / 2 / net, (y0 + y1) / 2 / net,
          (x1 - x0) / net, (y1 - y0) / net)
    label, score, box = dets[0]
    assert label == scene['gt_label'] and score >= min_score
    assert _iou_center(box, gt) > 0.5


def _map(golden, per_scene, net):
    labels = list(golden['labels'])
    gts, preds = [], []
    for scene, dets in zip(golden['images'], per_scene):
        gts.append({'boxes': np.asarray([scene['gt_box_xyxy']], np.float32),
                    'labels': np.asarray([labels.index(scene['gt_label'])])})
        preds.append({
            'boxes': np.asarray([[(cx - w / 2) * net, (cy - h / 2) * net,
                                  (cx + w / 2) * net, (cy + h / 2) * net]
                                 for _, _, (cx, cy, w, h) in dets],
                                np.float32).reshape(-1, 4),
            'scores': np.asarray([d[1] for d in dets], np.float32),
            'labels': np.asarray([labels.index(d[0]) for d in dets])})
    return evaluate_detection(gts, preds)['map']


def test_scene_array_equals_cv2_decode():
    import cv2
    data = np.load(SCENES)
    files = [s['file'] for s in _golden('golden_boxes.json')['images']]
    assert list(data['files']) == files
    assert data['images'].dtype == np.uint8
    for image, name in zip(data['images'], files):
        img = cv2.imread(os.path.join(FIXTURES, name))[:, :, ::-1]
        np.testing.assert_array_equal(image, cv2.resize(img, (160, 160)))


def test_header_is_modern_5_slot():
    raw = np.fromfile(WEIGHTS, dtype=np.int32, count=3)
    assert int(raw[0]) * 10 + int(raw[1]) >= 2
    assert DarknetWeightReader(WEIGHTS)._header_floats == 5


def test_cfg_detector_meets_golden(detector):
    golden = _golden('golden_boxes.json')
    per_scene = [detector.detect(os.path.join(FIXTURES, s['file']))
                 for s in golden['images']]
    for scene, dets in zip(golden['images'], per_scene):
        _meets_golden(scene, dets, 160, 0.0)
    assert _map(golden, per_scene, 160) == 1.0
    # the array path chip_smoke.py takes: all four scenes in one call
    images = np.load(SCENES)['images'].astype(np.float32) / 255.0
    for scene, dets in zip(golden['images'], detector.detect_images(images)):
        _meets_golden(scene, dets, 160, 0.0)


def test_vgg16_meets_golden(source):
    golden = _golden('golden_vgg16.json')
    net = golden['net']
    per_scene = [source.detect(os.path.join(FIXTURES, s['file']))
                 for s in golden['images']]
    for scene, dets in zip(golden['images'], per_scene):
        _meets_golden(scene, dets, net, 0.8)
    assert _map(golden, per_scene, net) == 1.0
    images = np.load(SCENES)['images'].astype(np.float32) / 255.0
    for scene, dets in zip(golden['images'], source.detect_images(images)):
        _meets_golden(scene, dets, net, 0.8)


def test_vgg16_extract_spatio_info_one_model(source):
    golden = _golden('golden_vgg16.json')
    scene = golden['images'][0]
    named, feats = source.extract_spatio_info(
        os.path.join(FIXTURES, scene['file']))
    assert named and named[0][0] == scene['gt_label']
    assert feats.shape == (1, 1, golden['fc_features'])
    assert np.isfinite(feats).all() and np.abs(feats).sum() > 0


def test_vgg16_forward_batch_prior_source(source):
    images = np.load(SCENES)['images'][:2].astype(np.float32) / 255.0
    feats, boxes, labels, scores, valid = source.forward_batch(images)
    assert feats.shape[0] == 2
    assert valid.any(axis=1).all(), 'a scene produced no detection'
