"""Port parity of `TrackerSequenceBatches` and `DetectionBatches` against
the JAX generators on the same synthetic folder, on the CPU.

Both sides decode with the port's default loader (the native decoder
where its library builds, else cv2). With augmentation off, the same seed
gives the same batches, epoch after epoch:
- over `FakeDetector`: 'det' and 'target' exactly, 'feats' rtol 1e-4
  (the mean pixel, summed in another order);
- over a width_div-8 `YOLOv2Detector` with the JAX weights carried by
  `convert.from_flax`: 'target' exactly, the same frames with and without
  a detection, their boxes within 1e-5 and 'feats' rtol 1e-4, atol 1e-5
  (the two networks' float32 convolutions round otherwise);
- `DetectionBatches`, single grid and multi-scale heads: exactly.
Augment mode draws its parameters from the port's own generators, so it
is held to the port's determinism, not to JAX's draws.
"""

import numpy as np
import pytest
import torch

from object_tracking_tpu.config import DetectorConfig as JDetectorConfig
from object_tracking_tpu.data import DetectionBatches as JDetBatches
from object_tracking_tpu.data import TrackerSequenceBatches as JTracker
from object_tracking_tpu.data import make_sequence_windows as jwindows
from object_tracking_tpu.data import parse_annotation_dir as jparse
from object_tracking_tpu.models import FakeDetector as JFake
from object_tracking_tpu.models import YOLOv2Detector as JYOLO
from object_tracking_tpu_torch.config import DetectorConfig
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.data import (DetectionBatches,
                                            TrackerSequenceBatches,
                                            make_sequence_windows,
                                            parse_annotation_dir)
from object_tracking_tpu_torch.data.generators import _default_loader
from object_tracking_tpu_torch.data.synthetic import make_synthetic_dataset
from object_tracking_tpu_torch.models import FakeDetector, YOLOv2Detector
from torch_parity import numpy_tree

NET = 64
LABELS = ('1', '2')
T = 3


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp('synth')
    return make_synthetic_dataset(str(root), num_videos=2,
                                  frames_per_video=6, image_size=(NET, NET),
                                  labels=LABELS, objects_per_video=2)


@pytest.fixture(scope='module')
def windows(folder):
    img_dir, ann_dir = folder
    anns, _ = parse_annotation_dir(ann_dir, img_dir, LABELS)
    ref, _ = jparse(ann_dir, img_dir, LABELS)
    return make_sequence_windows(anns, T), jwindows(ref, T)


def pair(windows, detector, ref_detector, **kw):
    kw = dict(dict(net_h=NET, net_w=NET, batch_size=2, augment=False,
                   seed=4, drop_last=False,
                   loader=_default_loader(NET, NET)), **kw)
    return (TrackerSequenceBatches(windows[0], LABELS, detector, **kw),
            JTracker(windows[1], LABELS, ref_detector, **kw))


def epochs(gen, n=2):
    return [list(gen()) for _ in range(n)]


@pytest.mark.parametrize('target_mode', ['bbox', 'heatmap'])
@pytest.mark.parametrize('det_dropout', [0.0, 0.4])
def test_tracker_batches_over_fake_match_jax(windows, target_mode,
                                             det_dropout):
    """Two epochs, batch by batch. With det_dropout the per-batch `rand`
    draws follow each epoch's permutation on one RandomState, as in JAX."""
    fake = dict(feat_shape=(2, 2, 4), num_labels=2, label_id=0)
    gen, ref = pair(windows, FakeDetector(**fake), JFake(**fake),
                    target_mode=target_mode, heatmap_size=8,
                    det_dropout=det_dropout)
    mine, theirs = epochs(gen), epochs(ref)
    assert len(mine[0]) == len(theirs[0]) == len(gen) > 1
    dropped = 0
    for got_epoch, want_epoch in zip(mine, theirs):
        for got, want in zip(got_epoch, want_epoch):
            assert set(got) == set(want) == {'feats', 'det', 'target'}
            np.testing.assert_array_equal(got['det'], want['det'])
            np.testing.assert_array_equal(got['target'], want['target'])
            np.testing.assert_allclose(got['feats'], want['feats'],
                                       rtol=1e-4)
            assert got['det'].dtype == got['target'].dtype == np.float32
            dropped += int((np.abs(got['det']).sum(-1) == 0).sum())
    if target_mode == 'bbox':      # a zero box's heatmap paints cell (0, 0)
        assert (dropped > 0) == (det_dropout > 0)


@pytest.fixture(scope='module')
def yolo_pair():
    """A width_div-8 YOLOv2 at 64² over the two labels, JAX weights in
    both, a low threshold so that frames have detections."""
    kw = dict(labels=LABELS, image_h=NET, image_w=NET, grid_h=2, grid_w=2,
              width_div=8, obj_threshold=0.2)
    ref = JYOLO(JDetectorConfig(**kw))
    mine = YOLOv2Detector(DetectorConfig(**kw), device='cpu')
    mine.model.load_state_dict(from_flax(numpy_tree(dict(ref.variables))),
                               strict=True)
    return mine, ref


def test_tracker_batches_over_yolov2_match_jax(windows, yolo_pair):
    gen, ref = pair(windows, *yolo_pair)
    seen = 0
    for got_epoch, want_epoch in zip(epochs(gen), epochs(ref)):
        for got, want in zip(got_epoch, want_epoch):
            np.testing.assert_array_equal(got['target'], want['target'])
            present = np.abs(want['det']).sum(-1) > 0
            np.testing.assert_array_equal(np.abs(got['det']).sum(-1) > 0,
                                          present)
            np.testing.assert_allclose(got['det'], want['det'], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(got['feats'], want['feats'],
                                       rtol=1e-4, atol=1e-5)
            seen += int(present.sum())
    assert seen > 0                     # the prior found the class somewhere


def test_precompute_runs_once_in_chunks(windows):
    calls = []

    class Counting(FakeDetector):
        def forward_batch(self, images, layer='conv_feat', top_k=None):
            calls.append(images.shape[0])
            return super().forward_batch(images, layer, top_k)

    gen = TrackerSequenceBatches(windows[0], LABELS, Counting((2, 2, 4)),
                                 net_h=NET, net_w=NET, batch_size=2,
                                 augment=False,
                                 loader=_default_loader(NET, NET))
    list(gen())
    list(gen())
    assert calls == [12]                 # 12 unique frames, one chunk


def test_augment_mode_deterministic_per_seed_and_varies(windows, yolo_pair):
    """Augment mode on a CPU YOLOv2 prior: the frames reach the detector as
    tensors on its device; the same seed gives the same batches; a second
    epoch augments anew."""
    seen = []

    class Watch(YOLOv2Detector):
        def forward_batch(self, images, layer='conv_feat', top_k=16):
            seen.append((type(images), images.device, images.shape))
            return super().forward_batch(images, layer, top_k)

    det = Watch(yolo_pair[0].config, device='cpu')
    det.model.load_state_dict(yolo_pair[0].model.state_dict())
    kw = dict(net_h=NET, net_w=NET, batch_size=2, augment=True, seed=1,
              loader=_default_loader(NET, NET))
    a = TrackerSequenceBatches(windows[0], LABELS, det, **kw)
    b = TrackerSequenceBatches(windows[0], LABELS, det, **kw)
    first, again = next(iter(a())), next(iter(b()))
    for key in first:
        np.testing.assert_array_equal(first[key], again[key])
    assert seen[0] == (torch.Tensor, torch.device('cpu'), (2 * T, NET, NET, 3))
    assert first['feats'].shape == (2, T, 2, 2, 128)
    second = next(iter(a()))
    assert not np.array_equal(first['feats'], second['feats'])


def test_missed_detection_is_exact_float32_zero(windows):
    """A prior whose only detection has another class: every 'det' is
    exactly 0.0 float32 (the residual head's presence gate)."""
    gen = TrackerSequenceBatches(
        windows[0], LABELS, FakeDetector((2, 2, 4), num_labels=2,
                                         label_id=1),
        net_h=NET, net_w=NET, batch_size=2, augment=False,
        tracked_classes=('1',), loader=_default_loader(NET, NET))
    for batch in gen():
        assert batch['det'].dtype == np.float32
        assert np.array_equal(batch['det'], np.zeros_like(batch['det']))
        assert not np.signbit(batch['det']).any()


def test_select_detection_keeps_first_of_equal_scores(windows):
    gen = TrackerSequenceBatches(windows[0], LABELS, FakeDetector((1, 1, 1)),
                                 net_h=NET, net_w=NET, augment=False)
    boxes = np.array([[0.1] * 4, [0.2] * 4, [0.3] * 4], np.float32)
    labels = np.array([0, 0, 1], np.int32)
    scores = np.array([0.7, 0.7, 0.9], np.float32)
    valid = np.ones(3, bool)
    got = gen._select_detection('1', boxes, labels, scores, valid)
    np.testing.assert_array_equal(got, boxes[0])
    valid[0] = False
    np.testing.assert_array_equal(
        gen._select_detection('1', boxes, labels, scores, valid), boxes[1])


def det_pair(folder, **kw):
    img_dir, ann_dir = folder
    anns, _ = parse_annotation_dir(ann_dir, img_dir, LABELS)
    ref, _ = jparse(ann_dir, img_dir, LABELS)
    kw = dict(dict(net_h=NET, net_w=NET, grid_h=2, grid_w=2,
                   anchors=(1.0, 1.0, 2.5, 2.0), batch_size=5, max_boxes=6,
                   augment=False, seed=2, drop_last=False,
                   loader=_default_loader(NET, NET)), **kw)
    return (DetectionBatches(anns, LABELS, **kw),
            JDetBatches(ref, LABELS, **kw))


HEADS = (((10.0, 14.0, 23.0, 27.0), 2, 2, 2),
         ((37.0, 58.0, 81.0, 82.0, 60.0, 40.0), 4, 4, 2))


@pytest.mark.parametrize('heads', [None, HEADS], ids=['grid', 'heads'])
def test_detection_batches_match_jax(folder, heads):
    gen, ref = det_pair(folder, heads=heads)
    assert len(gen) == len(ref) == 3                 # 12 frames, B=5, last 2
    for got_epoch, want_epoch in zip(epochs(gen), epochs(ref)):
        for got, want in zip(got_epoch, want_epoch):
            np.testing.assert_array_equal(got['images'], want['images'])
            for key in ('y_true', 'true_boxes'):
                if heads is None:
                    np.testing.assert_array_equal(got[key], want[key])
                else:
                    assert len(got[key]) == len(want[key]) == 2
                    for g, w in zip(got[key], want[key]):
                        np.testing.assert_array_equal(g, np.asarray(w))
    assert got_epoch[-1]['images'].shape[0] == 2


def test_detection_batches_augment_shapes_and_seed(folder):
    gen, _ = det_pair(folder, augment=True, batch_size=4, drop_last=True)
    again, _ = det_pair(folder, augment=True, batch_size=4, drop_last=True)
    batches = list(gen())
    assert len(batches) == 3
    b = batches[0]
    assert b['images'].shape == (4, NET, NET, 3)
    assert b['y_true'].shape == (4, 2, 2, 2, 5 + 2)
    assert b['true_boxes'].shape == (4, 1, 1, 1, 6, 4)
    assert 0.0 <= b['images'].min() and b['images'].max() <= 1.0
    np.testing.assert_array_equal(next(iter(again()))['images'], b['images'])
