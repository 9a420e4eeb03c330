"""The port's serving edge, each part written once.

- `ops/decode.py::boxes_to_list` is the one code that orders a frame's
  detections: held to the formula it replaced (a filter, then a stable
  sort by score) without ids, and, with ids, to the joint surfaces' former
  second argsort, on seeded padded frames full of tied scores;
- `utils/frames.py::read_frame` equals, bit for bit on the fixture JPEGs,
  each of the four readers it replaced (two resized then flipped to RGB,
  two flipped then resized);
- no module under `models/` or `ops/` imports the serving layer
  (`inference`, `serving`, `trainer`, `evaluation`).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch.ops.decode import boxes_to_list, named_boxes
from object_tracking_tpu_torch.utils.frames import read_frame, to_device

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / 'object_tracking_tpu_torch'
SCENES = [str(REPO / 'tests' / 'fixtures' / f'scene_{i}.jpg')
          for i in range(4)]
SEEDS = [0, 1, 2, 3, 4, 5]
K = 128


def _frame(seed: int):
    """One padded frame: scores from four values (ties everywhere), about
    half the rows valid, and distinct ids (row + 100)."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(K, 4).astype(np.float32)
    labels = rng.randint(0, 12, K).astype(np.int64)
    scores = rng.choice(np.float32([0.55, 0.6, 0.75, 0.9]), K)
    valid = rng.rand(K) < 0.5
    ids = (np.arange(K) + 100).astype(np.int32)
    return boxes, labels, scores, valid, ids


def _old_boxes_to_list(boxes, labels, scores, valid):
    """The formula `boxes_to_list` had before it took ids."""
    boxes, labels, scores, valid = (
        np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        for a in (boxes, labels, scores, valid))
    out = [(int(l), float(s), tuple(map(float, b)))
           for b, l, s, v in zip(boxes, labels, scores, valid) if v]
    return sorted(out, key=lambda r: -r[1])


def _old_ids(scores, valid, ids):
    """The joint surfaces' former second sort, aligning ids to rows."""
    order = np.argsort(-scores[valid], kind='stable')
    return [int(i) for i in ids[valid][order]]


@pytest.mark.parametrize('seed', SEEDS)
def test_rows_without_ids_are_the_old_formula(seed):
    boxes, labels, scores, valid, _ = _frame(seed)
    want = _old_boxes_to_list(boxes, labels, scores, valid)
    for args in ((boxes, labels, scores, valid),
                 tuple(torch.from_numpy(a) for a in
                       (boxes, labels, scores, valid))):
        got = boxes_to_list(*args)
        assert got == want
        for (l, s, b), (wl, ws, wb) in zip(got, want):
            assert (type(l), type(s), type(b)) == (int, float, tuple)
            assert all(type(v) is float for v in b)


@pytest.mark.parametrize('seed', SEEDS)
def test_rows_with_ids_keep_each_id_on_its_box(seed):
    boxes, labels, scores, valid, ids = _frame(seed)
    got = boxes_to_list(boxes, labels, scores, valid, ids)
    assert [r[:3] for r in got] == _old_boxes_to_list(
        boxes, labels, scores, valid)
    assert [r[3] for r in got] == _old_ids(scores, valid, ids)
    rows = [i - 100 for _, _, _, i in got]
    assert sorted(rows) == list(np.flatnonzero(valid))     # invalid drop
    for (l, s, b, i), r in zip(got, rows):
        assert type(i) is int
        assert (l, s, b) == (int(labels[r]), float(scores[r]),
                             tuple(map(float, boxes[r])))
    for a, b in zip(got, got[1:]):                  # ties keep row order
        assert a[1] > b[1] or (a[1] == b[1] and a[3] < b[3])
    assert len({s for _, s, _, _ in got}) < len(got)   # ties were there


def test_named_boxes_is_boxes_to_list_per_image():
    frames = [_frame(seed)[:4] for seed in SEEDS[:3]]
    dets = [torch.from_numpy(np.stack(a)) for a in zip(*frames)]
    names = [f'class_{i}' for i in range(12)]
    got = named_boxes(dets, names)
    assert len(got) == 3
    for per_image, frame in zip(got, frames):
        assert per_image == [(names[l], s, b)
                             for l, s, b in _old_boxes_to_list(*frame)]


def _resize_then_flip(path, h, w):
    """`JointPredictor`'s window reader, one frame."""
    import cv2
    img = cv2.imread(path)
    img = cv2.resize(img, (w, h))[:, :, ::-1]
    return np.asarray(img, np.float32) / 255.0


def _yolov2_prep(path, h, w):
    """`YOLOv2Detector._prep` with `read_image_rgb`: (image, x[None])."""
    import cv2
    image = cv2.imread(path)[:, :, ::-1]
    resized = cv2.resize(image, (w, h))
    return image, np.asarray(resized, np.float32)[None] / 255.0


def _vgg16_read(path, h, w):
    """`VGG16PriorSource.extract_spatio_info`'s reader: x[None]."""
    import cv2
    img = cv2.imread(path)
    img = cv2.resize(img, (w, h))[:, :, ::-1]
    return np.asarray(img, np.float32)[None] / 255.0


def _cfg_detect_read(path, h, w):
    """`CfgDetector.detect`'s reader: x[None]."""
    import cv2
    image = cv2.imread(path)[:, :, ::-1]
    return np.asarray(cv2.resize(image, (w, h)), np.float32)[None] / 255.0


@pytest.mark.parametrize('size', [(416, 416), (96, 128)])
@pytest.mark.parametrize('path', SCENES, ids=lambda p: Path(p).stem)
def test_read_frame_is_each_old_reader_bit_for_bit(path, size):
    h, w = size
    image, frame = read_frame(path, size)
    assert frame.dtype == np.float32 and frame.shape == (h, w, 3)
    np.testing.assert_array_equal(frame, _resize_then_flip(path, h, w))
    np.testing.assert_array_equal(frame[None], _vgg16_read(path, h, w))
    np.testing.assert_array_equal(frame[None], _cfg_detect_read(path, h, w))
    old_image, old_x = _yolov2_prep(path, h, w)
    np.testing.assert_array_equal(image, old_image)
    np.testing.assert_array_equal(frame[None], old_x)


def test_read_frame_refuses_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_frame(str(tmp_path / 'absent.jpg'), (32, 32))


def test_to_device_is_one_float32_copy():
    x = np.random.RandomState(0).rand(2, 8, 8, 3)
    out = to_device(x, torch.device('cpu'))
    assert out.dtype == torch.float32 and out.device.type == 'cpu'
    np.testing.assert_array_equal(out.numpy(), x.astype(np.float32))


PKG = 'object_tracking_tpu_torch'
SERVING = {f'{PKG}.{m}' for m in ('inference', 'serving', 'trainer',
                                   'evaluation')}


def _below_serving():
    return sorted((PACKAGE / 'models').rglob('*.py')) + sorted(
        (PACKAGE / 'ops').rglob('*.py'))


def _serving_imports(path: Path):
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module == PKG:
            names = [f'{PKG}.{a.name}' for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        found += [n for n in names
                  if '.'.join(n.split('.')[:2]) in SERVING]
    return found


@pytest.mark.parametrize('path', _below_serving(),
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_models_and_ops_import_no_serving_module(path):
    assert _serving_imports(path) == []


def test_the_layering_check_sees_an_upward_import(tmp_path):
    path = tmp_path / 'upward.py'
    path.write_text('def f():\n'
                    '    from object_tracking_tpu_torch.inference import x\n'
                    '    from object_tracking_tpu_torch import serving\n')
    assert _serving_imports(path) == [
        'object_tracking_tpu_torch.inference',
        'object_tracking_tpu_torch.serving']
