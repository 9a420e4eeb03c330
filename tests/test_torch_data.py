"""Port parity of the data layer: the VOC parser, sequence windows, the
synthetic dataset and `SequenceBatches` in both modes, against the JAX
package on the same synthetic folder.

Decoders: both packages decode with the native C++ loader when its library
builds (raw mode always prefers it) and with cv2 otherwise. The JAX
binding is handed the port's library (`torch_parity.share_native_library`),
in every test, so both sides decode with one decoder (and no test here
builds into native/): every field, the raw-mode images included, is
compared exactly; the legacy-mode comparison hands both generators the
port's default loader.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from object_tracking_tpu.data import SequenceBatches as JBatches
from object_tracking_tpu.data import make_sequence_windows as jwindows
from object_tracking_tpu.data import parse_annotation_dir as jparse
from object_tracking_tpu.data.generators import _pad_boxes as jpad
from object_tracking_tpu.data.synthetic import (
    make_synthetic_annotations as jannotations)
from object_tracking_tpu.data.synthetic import make_synthetic_dataset as jmake
from object_tracking_tpu_torch.data import (SequenceBatches,
                                            make_sequence_windows,
                                            parse_annotation_dir)
from object_tracking_tpu_torch.data.generators import (_default_loader,
                                                       _pad_boxes)
from object_tracking_tpu_torch.data.synthetic import (
    make_synthetic_annotations, make_synthetic_dataset)

from torch_parity import share_native_library

LABELS = ('1', '2')
NET = 64
KW = dict(net_h=NET, net_w=NET, grid_h=2, grid_w=2,
          anchors=(1.0, 1.0, 2.5, 2.0), batch_size=2, max_boxes=5, seed=3)


@pytest.fixture(autouse=True)
def one_decoder(monkeypatch):
    share_native_library(monkeypatch)


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp('synth')
    return make_synthetic_dataset(str(root), num_videos=2,
                                  frames_per_video=5, image_size=(NET, NET),
                                  labels=LABELS, objects_per_video=3,
                                  crossing=True, clutter=1)


def test_synthetic_dataset_equals_jax(folder, tmp_path):
    img_dir, ann_dir = folder
    j_img, j_ann = jmake(str(tmp_path), num_videos=2, frames_per_video=5,
                         image_size=(NET, NET), labels=LABELS,
                         objects_per_video=3, crossing=True, clutter=1)
    for mine, ref in ((img_dir, j_img), (ann_dir, j_ann)):
        files = sorted(os.path.relpath(os.path.join(d, f), mine)
                       for d, _, fs in os.walk(mine) for f in fs)
        assert files == sorted(os.path.relpath(os.path.join(d, f), ref)
                               for d, _, fs in os.walk(ref) for f in fs)
        for f in files:
            with open(os.path.join(mine, f), 'rb') as a, \
                    open(os.path.join(ref, f), 'rb') as b:
                assert a.read() == b.read(), f
    assert [dataclasses.asdict(a) for a in make_synthetic_annotations(
        labels=LABELS)] == [dataclasses.asdict(a) for a in jannotations(
            labels=LABELS)]


def test_annotations_windows_and_padding_equal_jax(folder, tmp_path):
    img_dir, ann_dir = folder
    anns, seen = parse_annotation_dir(ann_dir, img_dir, ['1'],
                                      cache_dir=str(tmp_path))
    ref, ref_seen = jparse(ann_dir, img_dir, ['1'])
    assert seen == ref_seen and len(anns) == len(ref) > 0
    assert [dataclasses.asdict(a) for a in anns] == \
        [dataclasses.asdict(r) for r in ref]
    # the pickle cache serves the same parse
    assert parse_annotation_dir(ann_dir, img_dir, ['1'],
                                cache_dir=str(tmp_path))[0] == anns
    assert [[a.filename for a in w] for w in make_sequence_windows(anns, 3)] \
        == [[a.filename for a in w] for w in jwindows(ref, 3)]
    for a in anns[:4]:
        for got, want in zip(_pad_boxes(a, LABELS, 4, 32, 48),
                             jpad(a, LABELS, 4, 32, 48)):
            np.testing.assert_array_equal(got, want)


def _generators(folder, **kw):
    img_dir, ann_dir = folder
    port = make_sequence_windows(parse_annotation_dir(ann_dir, img_dir,
                                                      LABELS)[0], 3)
    ref = jwindows(jparse(ann_dir, img_dir, LABELS)[0], 3)
    return (SequenceBatches(port, LABELS, **KW, **kw),
            JBatches(ref, LABELS, **KW, **kw))


def test_raw_mode_equals_jax_field_for_field(folder):
    port, ref = _generators(folder, raw_mode=True)
    assert len(port) == len(ref) > 1
    for _ in range(2):                                    # two epochs
        for got, want in zip(port(), ref()):
            assert set(got) == set(want)
            for k in ('boxes', 'cls', 'valid', 'aug_seeds', 'images_u8'):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_legacy_mode_equals_jax_field_for_field(folder):
    """augment=False, and both generators given the port's default
    loader: images, targets and true-box buffers equal."""
    port, ref = _generators(folder, augment=False,
                            loader=_default_loader(NET, NET))
    for got, want in zip(port(), ref()):
        assert set(got) == set(want) == {'images', 'y_true', 'true_boxes'}
        for k in got:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


def test_legacy_mode_augments_on_the_host(folder):
    port, _ = _generators(folder, augment=True)
    batch = next(iter(port()))
    assert batch['images'].shape == (2, 3, NET, NET, 3)
    assert 0.0 <= batch['images'].min() and batch['images'].max() <= 1.0
    assert batch['y_true'].shape == (2, 3, 2, 2, 2, 7)
    again, _ = _generators(folder, augment=True)
    np.testing.assert_array_equal(next(iter(again()))['images'],
                                  batch['images'])
    assert isinstance(torch.from_numpy(batch['images']), torch.Tensor)
