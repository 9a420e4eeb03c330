"""Port parity: evaluation.py (the port's numpy copy) vs the JAX package.

On the same seeded inputs every metric must equal the JAX module's
exactly: IoU, overlap and success curves, CLEAR-MOT, VOC AP and mAP, and
the dataset harness over stub predictors. The harness over the two
JointPredictors (converted weights, the same image files) must give the
same counts, with MOTA, MOTP and mAP to 1e-5 (the predicted boxes agree
to 1e-5).
"""

import numpy as np
import pytest

from object_tracking_tpu import evaluation as jeval
from object_tracking_tpu.data.voc import Annotation, ObjectAnnotation
from object_tracking_tpu_torch import evaluation as teval
from test_torch_inference import _pair
from tests.test_eval_dataset import (EmptyPredictor, PerfectPredictor,
                                     _make_annotations)


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(size * 0.05, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_overlap_and_success_equal_jax(rng):
    preds, gts = _boxes(rng, 50), _boxes(rng, 50)
    gts[::3] = preds[::3] + rng.uniform(-4, 4, (17, 4))
    for fn in ('average_overlap_score', 'success_auc'):
        assert getattr(teval, fn)(preds, gts) == getattr(jeval, fn)(
            preds, gts)
    for p, g in zip(preds[:10], gts[:10]):
        assert teval.overlap_score(p, g) == jeval.overlap_score(p, g)
    for a, b in zip(teval.success_curve(preds, gts),
                    jeval.success_curve(preds, gts)):
        np.testing.assert_array_equal(a, b)
    assert teval.average_overlap_score([], []) == 0.0


def test_hand_computed_cases():
    assert teval.overlap_score([0, 0, 10, 10], [0, 0, 10, 10]) == 1.0
    assert teval.overlap_score([0, 0, 10, 10], [20, 20, 30, 30]) == 0.0
    np.testing.assert_allclose(
        teval.overlap_score([0, 0, 10, 10], [5, 0, 15, 10]), 50 / 150)
    np.testing.assert_allclose(
        teval.average_precision(np.asarray([0.5, 0.5, 1.0]),
                                np.asarray([1.0, 0.5, 2.0 / 3.0])),
        0.5 * 1.0 + 0.5 * (2.0 / 3.0))
    gt = [{1: np.array([0, 0, 10, 10])} for _ in range(4)]
    pred = [{}, {7: np.array([0, 0, 10, 10]), 8: np.array([50, 50, 60, 60])},
            {9: np.array([0, 0, 10, 10])}, {9: np.array([0, 0, 10, 10])}]
    m = teval.evaluate_mot(gt, pred)
    assert m['fn'] == 1 and m['fp'] == 1 and m['id_switches'] == 1
    np.testing.assert_allclose(m['mota'], 1.0 - 3 / 4)


_GT2 = [{'boxes': np.asarray([[0, 0, 10, 10], [20, 20, 40, 40]], np.float32),
         'labels': np.asarray([0, 0])}]
_GT1 = [{'boxes': np.asarray([[0, 0, 10, 10]], np.float32),
         'labels': np.asarray([0])}]
DETECTION_CASES = {
    # ranks TP, FP, TP over 2 GT → recall [.5, .5, 1], precision [1, .5, 2/3]
    'hand': (_GT2, [{'boxes': np.asarray([[0, 0, 10, 10], [60, 60, 70, 70],
                                          [21, 20, 40, 40]], np.float32),
                     'scores': np.asarray([0.9, 0.8, 0.7]),
                     'labels': np.asarray([0, 0, 0])}],
             0.5 * 1.0 + 0.5 * (2.0 / 3.0)),
    'perfect': ([{**_GT2[0], 'labels': np.asarray([0, 1])}],
                [{'boxes': _GT2[0]['boxes'], 'scores': np.asarray([0.9, 0.8]),
                  'labels': np.asarray([0, 1])}], 1.0),
    # class 0: no detections → AP 0; class 1: FP only, no GT → not in mAP
    'wrong_class': (_GT1, [{'boxes': _GT1[0]['boxes'],
                            'scores': np.asarray([0.9]),
                            'labels': np.asarray([1])}], 0.0),
    # a second hit on a used GT is an FP → AP 1.0 (envelope at r=1)
    'duplicate': (_GT1, [{'boxes': np.asarray([[0, 0, 10, 10]] * 2,
                                              np.float32),
                          'scores': np.asarray([0.9, 0.8]),
                          'labels': np.asarray([0, 0])}], 1.0),
}


@pytest.mark.parametrize('case', DETECTION_CASES)
def test_evaluate_detection_hand_computed(case):
    gts, preds, expected = DETECTION_CASES[case]
    out = teval.evaluate_detection(gts, preds)
    np.testing.assert_allclose(out['map'], expected)
    assert out == jeval.evaluate_detection(gts, preds)


def _mot_frames(rng, frames=12, ids=5):
    gt, pred = [], []
    base = _boxes(rng, ids)
    for t in range(frames):
        boxes = base + t * rng.uniform(-1, 2, (ids, 4)).astype(np.float32)
        gt.append({i + 1: boxes[i] for i in range(ids)})
        frame = {}
        for i in range(ids):
            if rng.rand() < 0.15:
                continue                               # a miss
            tid = 100 + i if rng.rand() > 0.1 else 200 + t   # a switch
            frame[tid] = boxes[i] + rng.uniform(-3, 3, 4).astype(np.float32)
        if rng.rand() < 0.3:
            frame[999 + t] = _boxes(rng, 1)[0]         # a false positive
        pred.append(frame)
    return gt, pred


def test_evaluate_mot_equals_jax(rng):
    gt, pred = _mot_frames(rng)
    out = teval.evaluate_mot(gt, pred)
    assert out == jeval.evaluate_mot(gt, pred)
    assert out['fp'] and out['fn'] and out['id_switches']
    assert teval.evaluate_mot([{}], [{1: np.array([0, 0, 5, 5])}]) == \
        jeval.evaluate_mot([{}], [{1: np.array([0, 0, 5, 5])}])


def test_evaluate_detection_equals_jax(rng):
    gts, preds = [], []
    for _ in range(6):
        boxes = _boxes(rng, 4)
        labels = rng.randint(-1, 3, 4)                # -1: not evaluated
        gts.append({'boxes': boxes, 'labels': labels})
        n = 6
        pb = np.concatenate([boxes + rng.uniform(-5, 5, (4, 4)),
                             _boxes(rng, n - 4)]).astype(np.float32)
        preds.append({'boxes': pb, 'scores': rng.rand(n).astype(np.float32),
                      'labels': rng.randint(0, 4, n)})
    out = teval.evaluate_detection(gts, preds)
    assert out == jeval.evaluate_detection(gts, preds)
    assert 0.0 < out['map'] < 1.0 and out['pred_only_classes']


@pytest.mark.parametrize('predictor', ['perfect', 'empty'])
def test_tracking_dataset_harness_equals_jax(predictor):
    anns = _make_annotations(n_frames=7)
    pred = PerfectPredictor(anns) if predictor == 'perfect' \
        else EmptyPredictor()
    out = teval.evaluate_tracking_dataset(pred, anns, window=4)
    assert out == jeval.evaluate_tracking_dataset(pred, anns, window=4)
    assert out['overall']['num_gt'] == 2 * 2 * 7
    assert out['overall']['mota'] == (1.0 if predictor == 'perfect' else 0.0)


def test_tracking_dataset_on_the_port_predictor(rng, tmp_path):
    """The port's JointPredictor and the JAX one, on the same converted
    weights and the same image files (read with cv2, in windows of 4 with
    a padded partial last window)."""
    import cv2
    jpred, pred = _pair(rng, 'running', 'greedy')
    anns = []
    for v in range(2):
        for f in range(6):
            path = str(tmp_path / f'v{v}_{f:02d}.jpg')
            cv2.imwrite(path, rng.randint(0, 255, (64, 64, 3)).astype(
                np.uint8))
            anns.append(Annotation(
                filename=path, folder=f'v{v}', width=64, height=64,
                objects=[ObjectAnnotation('a', 8 + f, 10, 30 + f, 40, 1),
                         ObjectAnnotation('b', 30, 28, 60, 58, 2)]))
    out = teval.evaluate_tracking_dataset(pred, anns, window=4)
    ref = jeval.evaluate_tracking_dataset(jpred, anns, window=4)
    assert out.keys() == ref.keys() == {'v0', 'v1', 'detection', 'overall'}
    assert out['overall']['num_gt'] == 24
    assert out['overall']['fp'] > 0               # the model predicted boxes
    for key in ('v0', 'v1', 'overall'):
        for metric, value in ref[key].items():
            if isinstance(value, float):
                np.testing.assert_allclose(out[key][metric], value,
                                           rtol=0, atol=1e-5)
            else:
                assert out[key][metric] == value, (key, metric)
    assert out['detection'].keys() == ref['detection'].keys()
    for k, v in ref['detection'].items():
        np.testing.assert_allclose(out['detection'][k], v, rtol=0, atol=1e-5)
