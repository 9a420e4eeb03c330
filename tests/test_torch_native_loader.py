"""The port's binding of the native C++ data runtime (native/ott_dataio.cpp),
`object_tracking_tpu_torch/data/native_loader.py`, and the generators'
choice of decoder, against the JAX package on the CPU.

- The 8 tests of tests/test_native_loader.py, on the port's binding:
  decode and resize against cv2 (PNG mean < 0.01, max < 0.05; JPEG mean
  < 0.02: the IDCTs differ by a few LSBs), a batch equal to its single
  loads, uint8 within one level of the float32 path, missing files raise;
  NMS against the port's device op and its plain twin (atol 1e-6).
- The build: into build/native/ (never native/), keyed on the source, the
  flags, the compiler and its target; two processes building at once
  both load a working library.
- The generators: with no `loader=`, the port's SequenceBatches (raw uint8
  and float mode) and DetectionBatches give the JAX generators' pixels
  exactly, over annotations written for tests/fixtures/scene_*.jpg. The
  JAX binding is handed the port's library (`torch_parity.
  share_native_library`), so that no test here builds into native/; where
  the JAX binding's own build of native/ is already there, the same
  comparison runs once more against it (`jax_own_native_library`).

Every test skips, with the compiler's words, only where the port's
library cannot build.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from object_tracking_tpu.data import DetectionBatches as JDetection
from object_tracking_tpu.data import SequenceBatches as JSequences
from object_tracking_tpu.data.voc import Annotation as JAnnotation
from object_tracking_tpu.data.voc import ObjectAnnotation as JObject
from object_tracking_tpu_torch.data import (Annotation, DetectionBatches,
                                            ObjectAnnotation,
                                            SequenceBatches, native_loader)
from object_tracking_tpu_torch.data.generators import _default_loader
from object_tracking_tpu_torch.ops.cuda.nms import nms_scores_plain
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores
from torch_parity import jax_own_native_library, share_native_library

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / 'tests' / 'fixtures'


@pytest.fixture(autouse=True)
def library():
    if not native_loader.available():
        pytest.skip(f'libottdata.so unavailable: {native_loader.build_error}')


@pytest.fixture(scope='module')
def image_files(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp('imgs')
    rng = np.random.RandomState(0)
    # smooth content, so that JPEG decode differences stay tiny
    base = cv2.GaussianBlur(
        rng.randint(0, 255, (96, 128, 3), np.uint8), (15, 15), 5)
    jpg = str(root / 'a.jpg')
    png = str(root / 'b.png')
    cv2.imwrite(jpg, base, [cv2.IMWRITE_JPEG_QUALITY, 98])
    cv2.imwrite(png, base)
    return jpg, png, base


def _cv2_load(path, net_h, net_w):
    import cv2
    img = cv2.imread(path)
    img = cv2.resize(img, (net_w, net_h))[:, :, ::-1]
    return np.asarray(img, np.float32) / 255.0


def test_image_size(image_files):
    jpg, png, base = image_files
    assert native_loader.image_size(jpg) == base.shape[:2]
    assert native_loader.image_size(png) == base.shape[:2]


def test_png_decode_resize_matches_cv2(image_files):
    _, png, _ = image_files
    ours = native_loader.load_image(png, 64, 64)
    ref = _cv2_load(png, 64, 64)
    assert ours.shape == (64, 64, 3)
    assert np.abs(ours - ref).mean() < 0.01
    assert np.abs(ours - ref).max() < 0.05


def test_jpeg_decode_close_to_cv2(image_files):
    jpg, _, _ = image_files
    ours = native_loader.load_image(jpg, 96, 128)  # no resize
    ref = _cv2_load(jpg, 96, 128)
    assert np.abs(ours - ref).mean() < 0.02


def test_load_batch_matches_single(image_files):
    jpg, png, _ = image_files
    batch = native_loader.load_batch([jpg, png, jpg], 64, 48, n_threads=2)
    assert batch.shape == (3, 64, 48, 3)
    np.testing.assert_array_equal(batch[0],
                                  native_loader.load_image(jpg, 64, 48))
    np.testing.assert_array_equal(batch[1],
                                  native_loader.load_image(png, 64, 48))
    np.testing.assert_array_equal(batch[0], batch[2])


def test_load_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native_loader.load_image(str(tmp_path / 'nope.jpg'), 32, 32)
    with pytest.raises(FileNotFoundError):
        native_loader.load_batch([str(tmp_path / 'nope.jpg')], 32, 32)
    with pytest.raises(FileNotFoundError):
        native_loader.image_size(str(tmp_path / 'nope.jpg'))


def _candidates(rng, n=40, c=3):
    boxes = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n),
                      rng.uniform(0.05, 0.4, n),
                      rng.uniform(0.05, 0.4, n)], -1).astype(np.float32)
    scores = rng.rand(n, c).astype(np.float32)
    scores[scores < 0.5] = 0.0
    return boxes, scores


def test_nms_matches_device_op(rng):
    boxes, scores = _candidates(rng)
    native = native_loader.nms_scores(boxes, scores, 0.45)
    dev_boxes, dev_scores = greedy_nms_scores(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, top_k=0)
    np.testing.assert_array_equal(dev_boxes.numpy(), boxes)
    np.testing.assert_allclose(dev_scores.numpy(), native, atol=1e-6)


@pytest.mark.parametrize('seed', range(3))
def test_nms_matches_the_kernels_plain_twin(seed):
    """The host NMS against `nms_scores_plain`, kernel 1's plain version,
    on frames of candidates that overlap heavily (both keep the same
    boxes: suppression is by IoU > threshold, in descending score)."""
    rng = np.random.RandomState(seed)
    boxes, scores = _candidates(rng, n=64, c=5)
    native = native_loader.nms_scores(boxes, scores, 0.45)
    plain = nms_scores_plain(torch.from_numpy(boxes)[None],
                             torch.from_numpy(scores)[None], 0.45)[0]
    np.testing.assert_allclose(plain.numpy(), native, atol=1e-6)
    assert (native == 0).sum() > (scores == 0).sum()      # it suppressed


def test_nms_rejects_mismatched_boxes():
    with pytest.raises(ValueError, match='do not match'):
        native_loader.nms_scores(np.zeros((3, 4)), np.zeros((4, 2)))


def test_load_batch_u8_matches_f32(image_files):
    """uint8 == round(f32 * 255) within 1 LSB (same decode, same separable
    bilinear geometry)."""
    jpg, png, _ = image_files
    u8 = native_loader.load_batch_u8([jpg, png], 64, 48, n_threads=2)
    f32 = native_loader.load_batch([jpg, png], 64, 48, n_threads=2)
    assert u8.shape == (2, 64, 48, 3) and u8.dtype == np.uint8
    assert np.abs(u8.astype(np.float32) - f32 * 255.0).max() <= 1.0


def test_load_batch_u8_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native_loader.load_batch_u8([str(tmp_path / 'nope.jpg')], 32, 32)


# ------------------------------------------------------------------ build
def test_builds_into_the_ports_build_directory():
    path = native_loader.library_path()
    assert path.parent == REPO / 'build' / 'native' == native_loader.BUILD_DIR
    assert path.is_file() and path.name.startswith('libottdata-')
    assert native_loader.SOURCE == REPO / 'native' / 'ott_dataio.cpp'


_BUILD = '''
import os, sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
from object_tracking_tpu_torch.data import native_loader
native_loader.BUILD_DIR = Path({build!r})
while not os.path.exists({go!r}):
    time.sleep(0.001)
lib = native_loader.load_library()
assert lib is not None, native_loader.build_error
img = native_loader.load_image({image!r}, 32, 32)
print(native_loader.library_path().name, float(img.mean()))
'''


def test_two_processes_building_at_once_both_load_it(tmp_path):
    """Two interpreters start compiling into one empty build directory at
    the same moment: each writes its own temp file and renames it into
    place, so both load a library that decodes, and native/ is not
    touched."""
    native = sorted(os.listdir(REPO / 'native'))
    build, go = tmp_path / 'build', tmp_path / 'go'
    code = _BUILD.format(repo=str(REPO), build=str(build), go=str(go),
                         image=str(FIXTURES / 'scene_0.jpg'))
    procs = [subprocess.Popen([sys.executable, '-c', code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    time.sleep(1.0)             # both interpreters are up and waiting
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    assert sorted(os.listdir(build)) == [outs[0][0].split()[0]]
    assert sorted(os.listdir(REPO / 'native')) == native


# ------------------------------------------------------------- generators
LABELS = ('a', 'b')


def _annotations(annotation, obj):
    """One annotation a fixture scene (160x160), two boxes each."""
    out = []
    for i in range(4):
        out.append(annotation(
            filename=str(FIXTURES / f'scene_{i}.jpg'), folder='scenes',
            width=160, height=160,
            objects=[obj('a', 10 + 5 * i, 20, 90, 100 + 3 * i),
                     obj('b', 60, 40 + 4 * i, 150, 140)]))
    return out


KW = dict(net_h=96, net_w=128, grid_h=3, grid_w=4,
          anchors=(1.0, 1.0, 2.5, 2.0), batch_size=2, max_boxes=4, seed=5)


@pytest.fixture
def generators(monkeypatch):
    assert share_native_library(monkeypatch)
    port = _annotations(Annotation, ObjectAnnotation)
    ref = _annotations(JAnnotation, JObject)
    return port, ref


def _same_batches(port, ref):
    got, want = list(port()), list(ref())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
    return got


@pytest.mark.parametrize('raw_mode', [True, False])
def test_default_sequence_batches_decode_as_jax(generators, raw_mode):
    """No `loader=`: the port's SequenceBatches decode with the native
    library as JAX's do (raw mode: `load_batch_u8`; float mode: one
    `load_batch` per batch), pixel for pixel. cv2 would not: its decode
    and resize differ."""
    port, ref = generators
    kw = dict(KW, raw_mode=raw_mode, augment=False)
    got = _same_batches(SequenceBatches([port[:2], port[2:]], LABELS, **kw),
                        JSequences([ref[:2], ref[2:]], LABELS, **kw))
    key = 'images_u8' if raw_mode else 'images'
    frames = got[0][key].reshape((-1, 1, 96, 128, 3)).astype(np.float32)
    cv2 = np.stack([_cv2_load(str(FIXTURES / f'scene_{i}.jpg'), 96, 128)
                    for i in range(4)])
    gaps = np.abs(frames / (255.0 if raw_mode else 1.0) - cv2).sum(
        axis=(2, 3, 4))
    assert gaps.min() > 0           # no frame holds cv2's pixels


def test_default_detection_batches_decode_as_jax(generators):
    port, ref = generators
    kw = dict(KW, augment=False)
    _same_batches(DetectionBatches(port, LABELS, **kw),
                  JDetection(ref, LABELS, **kw))


@pytest.mark.parametrize('kind', ['raw', 'float', 'detection'])
def test_default_generators_decode_as_jaxs_own_build(monkeypatch, kind):
    """As above, with the JAX binding on its own build of native/ (the
    Makefile's) instead of the port's library, so that a drift between
    the two builds (flags, compiler) shows. Skips where no current build
    is there: none is made here."""
    if not jax_own_native_library(monkeypatch):
        pytest.skip('no current native/libottdata.so of the JAX binding')
    port = _annotations(Annotation, ObjectAnnotation)
    ref = _annotations(JAnnotation, JObject)
    if kind == 'detection':
        kw = dict(KW, augment=False)
        _same_batches(DetectionBatches(port, LABELS, **kw),
                      JDetection(ref, LABELS, **kw))
        return
    kw = dict(KW, raw_mode=kind == 'raw', augment=False)
    _same_batches(SequenceBatches([port[:2], port[2:]], LABELS, **kw),
                  JSequences([ref[:2], ref[2:]], LABELS, **kw))


def test_default_loader_is_the_native_one():
    load = _default_loader(96, 128)
    path = str(FIXTURES / 'scene_1.jpg')
    np.testing.assert_array_equal(load(path),
                                  native_loader.load_image(path, 96, 128))
