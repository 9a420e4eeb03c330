"""The NMS kernels' algorithm on the CPU: the sorted scan over a bitmask,
the launch plans and the build key.

`csrc/nms_common.cuh` replaces the Pallas round-by-round argmax walk with
a sorted scan: compact a class's positive scores into keys (score bits
<< 32 | ~index), sort them descending, and keep each candidate whose
`removed` bit is clear, ORing its bitmask row into `removed`; out = s *
(kept or not removed). `_scan` below does that in numpy, on the kernel's
bit layout, and is held EXACTLY equal (values, NaN places and signs of
zero) to `greedy_walk`, the plain twin's walk, on the same
`pallas_iou >= thr` relation. The kernels themselves run only on a card
(chip_smoke.py holds them to their twins there).
"""

import re

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch.ops.cuda import _build
from object_tracking_tpu_torch.ops.cuda import decode_nms as cuda_dn
from object_tracking_tpu_torch.ops.cuda import nms as cuda_nms

THR = 0.45


def _pack(ge: np.ndarray) -> np.ndarray:
    """(F, K, K) bool → (F, K, ⌈K/32⌉) uint32: bit j % 32 of word j // 32
    of row i is ge[i, j], the kernel's mask layout."""
    f, k, _ = ge.shape
    w = -(-k // 32)
    padded = np.zeros((f, k, w * 32), bool)
    padded[..., :k] = ge
    bits = padded.reshape(f, k, w, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _bit(words: np.ndarray, j: int) -> bool:
    return bool((int(words[j >> 5]) >> (j & 31)) & 1)


def _scan(scores: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The kernel's walk pass in numpy: (F, K, C) float32 scores and the
    packed IoU >= thr mask → (F, K, C) float32."""
    f, k, c = scores.shape
    out = np.empty_like(scores)
    for fi in range(f):
        for ci in range(c):
            col = scores[fi, :, ci]
            removed = np.zeros(mask.shape[-1], np.uint32)
            kept = np.zeros(mask.shape[-1], np.uint32)
            if not np.isnan(col).any():      # a NaN column never picks
                pos = np.flatnonzero(col > 0)
                keys = (col[pos].view(np.uint32).astype(np.uint64) << 32) | \
                    (~pos.astype(np.uint32)).astype(np.uint64)
                for key in np.sort(keys)[::-1]:
                    i = int(~np.uint32(key & np.uint64(0xffffffff)))
                    if not _bit(removed, i):
                        kept[i >> 5] |= np.uint32(1 << (i & 31))
                        removed |= mask[fi, i]
            keep = np.array([_bit(kept, j) or not _bit(removed, j)
                             for j in range(k)], np.float32)
            out[fi, :, ci] = col * keep
    return out


def _boxes(rng, frames, k):
    return np.stack([rng.uniform(0.2, 0.8, (frames, k)),
                     rng.uniform(0.2, 0.8, (frames, k)),
                     rng.uniform(0.05, 0.4, (frames, k)),
                     rng.uniform(0.05, 0.4, (frames, k))],
                    -1).astype(np.float32)


def _case(name, rng):
    """(boxes (F, K, 4), scores (F, K, C)) for each named case."""
    frames, k, c = {'random': (2, 64, 4), 'ties': (1, 48, 3),
                    'zero_negative': (2, 40, 3), 'zero_area': (1, 50, 2),
                    'all_dead': (2, 33, 3), 'k1': (3, 1, 2),
                    'k45': (2, 45, 5), 'k1805': (1, 1805, 2),
                    'nan_inf': (2, 70, 3)}[name]
    boxes = _boxes(rng, frames, k)
    scores = rng.rand(frames, k, c).astype(np.float32)
    scores[scores < 0.4] = 0.0
    if name == 'ties':
        scores = np.round(scores * 4) / 4        # {0, .25, .5, .75, 1}
        boxes[:, 1::2] = boxes[:, 0::2]          # identical pairs
    elif name == 'zero_negative':
        scores[scores < 0.6] = -scores[scores < 0.6]
        scores[:, ::5] = 0.0
    elif name == 'zero_area':
        boxes[:, ::3, 2] = 0.0                   # w = 0
        boxes[:, 1::3, 3] = 0.0                  # h = 0
    elif name == 'all_dead':
        scores[1] = 0.0
    elif name == 'k1805':
        scores[scores < 0.9] = 0.0               # ~180 live per class
    elif name == 'nan_inf':
        scores[0, 5, 1] = np.nan                 # class 1 of frame 0
        boxes[:, 7, 2] = np.inf                  # exp(tw) overflowed
        boxes[1, 9, 3] = np.inf
        scores[:, 7] = 0.9
        scores[1, 11, 0] = np.inf
    return boxes, scores.astype(np.float32)


CASES = ['random', 'ties', 'zero_negative', 'zero_area', 'all_dead', 'k1',
         'k45', 'k1805', 'nan_inf']


@pytest.mark.parametrize('name', CASES)
def test_sorted_scan_equals_greedy_walk_exactly(rng, name):
    boxes, scores = _case(name, rng)
    iou = cuda_nms.pallas_iou(torch.from_numpy(boxes))
    ref = cuda_nms.greedy_walk(torch.from_numpy(scores), iou, THR).numpy()
    out = _scan(scores, _pack((iou >= THR).numpy()))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(np.signbit(out), np.signbit(ref))
    live = scores > 0
    if name not in ('all_dead', 'k1'):
        assert ((out == 0) & live).any()          # something suppressed
    if name == 'nan_inf':
        assert np.isnan(out[0, :, 1]).sum() == 1  # the NaN class kept all
        np.testing.assert_array_equal(out[0, :, 1][live[0, :, 1]],
                                      scores[0, :, 1][live[0, :, 1]])


def test_keys_sort_by_score_then_first_index():
    scores = np.array([0.5, 1.0, 0.5, 1.0, 0.25, 3e-39], np.float32)
    idx = np.arange(6)
    keys = (scores.view(np.uint32).astype(np.uint64) << 32) | \
        (~idx.astype(np.uint32)).astype(np.uint64)
    order = [int(~np.uint32(key & np.uint64(0xffffffff)))
             for key in np.sort(keys)[::-1]]
    assert order == [1, 3, 0, 2, 4, 5]
    assert order == list(np.lexsort((idx, -scores)))


def test_pack_layout():
    ge = np.zeros((1, 40, 40), bool)
    ge[0, 3, 0] = ge[0, 3, 33] = ge[0, 39, 31] = True
    words = _pack(ge)
    assert words.shape == (1, 40, 2)
    assert words[0, 3].tolist() == [1, 2] and words[0, 39].tolist() == [
        1 << 31, 0]


# ------------------------------------------- the mask pass's division rule
def _iou_ge(inter, uni, thr):
    """csrc/nms_common.cuh::iou_ge in float32: decide fl(inter / d) >= thr
    by the product t = fl(thr·d) with a 2^-21 margin, dividing only in
    the margin or where t or inter is not finite."""
    f32 = np.float32
    d = uni if (np.isnan(uni) or uni > f32(1e-12)) else f32(1e-12)
    t = f32(thr) * d
    if t >= f32(1e-30) and t <= f32(3.0e38) and inter <= f32(3.0e38):
        if inter >= t * f32(1.0 + 2.0 ** -21):
            return True, False
        if inter <= t * f32(1.0 - 2.0 ** -21):
            return False, False
    return bool(inter / d >= f32(thr)), True


@pytest.mark.parametrize('thr', [0.3, 0.45, 0.5, 0.6, 0.7, 2.0 ** -3,
                                 1e-30, 1.0])
def test_division_rule_equals_ieee_division(rng, thr):
    """Pairs within a few ulps of inter = thr·d, over six decades of d,
    and the edges (inter 0, d at the 1e-12 floor, inf, NaN): the rule
    gives IEEE float32 division's answer, and divides only near the
    threshold."""
    f32 = np.float32
    with np.errstate(all='ignore'):
        unions = np.concatenate([
            (10.0 ** rng.uniform(-12, 6, 400)).astype(f32),
            np.array([1e-12, 1e-13, 0.0, -1.0, 1.0, 3e38, np.inf, np.nan],
                     f32)])
        divided = agree = 0
        for uni in unions:
            d = uni if (np.isnan(uni) or uni > f32(1e-12)) else f32(1e-12)
            base = f32(thr) * d
            near = [base]
            for _ in range(12):
                near = ([np.nextafter(near[0], f32(-np.inf), dtype=f32)]
                        + near
                        + [np.nextafter(near[-1], f32(np.inf), dtype=f32)])
            for inter in near + [f32(0.0), base * f32(0.5), base * f32(2),
                                 f32(np.inf), f32(np.nan)]:
                got, div = _iou_ge(f32(inter), uni, thr)
                assert got == bool(f32(inter) / d >= f32(thr)), (inter, uni)
                divided += div
                agree += 1
    if thr > 1e-6:                      # t = thr·d is a normal float
        assert divided < agree / 2      # most decided without a division


# ------------------------------------------------------------ launch plans
PATH_SHAPES = [
    (32, 128, 12),    # joint predict_batch, B=8, T=4
    (4, 128, 12),     # joint predict_window, T=4
    (8, 16, 80),      # YOLOv2Detector.forward_batch, top-16
    (1, 128, 80),     # YOLOv2Detector.predict, top-128
    (2, 128, 2),      # golden detectors
    (8, 845, 80),     # the full 13x13x5 lattice
    (1, 845, 80),
    (8, 1805, 80),    # 19x19x5, 608^2
    (1, 4096, 80),
    (64, 4096, 1),
    (3, 4096, 7),
    (8, 6000, 1),     # Faster R-CNN's proposal NMS, B=8
    (160, 300, 1),    # its per-class NMS: 8 images x 20 classes
    (1, 8192, 80),    # the cap
    (8, 8192, 1),
]


def _check_common(plan, frames, n, c):
    mask, walk = plan['mask'], plan['walk']
    assert mask['grid'][1] == frames
    assert mask['grid'][0] * mask['rows'] >= n > (mask['grid'][0] - 1) * \
        mask['rows']
    assert mask['smem'] == 5 * n * 4
    groups = walk['grid'][0] // frames
    assert walk['grid'][0] == frames * groups
    assert groups * walk['classes'] >= c > (groups - 1) * walk['classes']
    assert walk['threads'] == 32 * walk['classes'] <= 256
    assert 32 <= walk['tile_rows'] <= 1024 and walk['tile_rows'] % 32 == 0
    assert walk['smem'] == cuda_nms.walk_smem(
        n, walk['classes'], walk['tile_rows'], walk['frame_mask'])
    # the frame's whole mask goes to shared memory only as one load a thread
    assert walk['frame_mask'] == (n * (-(-n // 32)) <= 16 * walk['threads'])
    assert plan['scratch_bytes'] == frames * n * (-(-n // 32)) * 4
    for name in plan:
        if name != 'scratch_bytes':
            assert plan[name]['smem'] <= cuda_nms.SMEM_LIMIT == 227 * 1024


@pytest.mark.parametrize('shape', PATH_SHAPES)
def test_launch_plans_cover_and_fit(shape):
    frames, n, c = shape
    _check_common(cuda_nms.launch_plan(frames, n, c), frames, n, c)
    plan = cuda_dn.launch_plan(frames, n, c)
    _check_common(plan, frames, n, c)
    dec = plan['decode']
    assert dec['grid'][1] == frames
    assert dec['grid'][0] * dec['tile'] >= n > (dec['grid'][0] - 1) * \
        dec['tile']
    assert dec['smem'] == 4 * (dec['tile'] * (5 + c) + 3 * dec['tile'])


def test_walk_smem_layout():
    """Keys padded to a power of two (8 B); per warp 34 row-widths of
    32-bit words (32 staged rows, removed, kept) and 32 row indices; the
    tile at an odd stride; the frame's mask where it is copied whole."""
    assert cuda_nms.walk_smem(845, 4, 864, False) == (
        8 * 4 * 1024 + 4 * 4 * (34 * 27 + 32) + 4 * 864 * 5)
    assert cuda_nms.walk_smem(128, 2, 128, True) == (
        8 * 2 * 128 + 4 * 2 * (34 * 4 + 32) + 4 * 128 * 3 + 4 * 128 * 4)


def test_walk_plan_fills_the_card_then_shrinks_to_fit():
    assert cuda_nms.walk_plan(32, 128, 12)['classes'] == 2    # 192 blocks
    assert cuda_nms.walk_plan(8, 845, 80)['classes'] == 4     # 160 blocks
    assert cuda_nms.walk_plan(1, 845, 80)['classes'] == 1
    big = cuda_nms.walk_plan(64, 4096, 80)                    # fit wins
    assert big['classes'] == 4 and big['smem'] <= cuda_nms.SMEM_LIMIT


def _constants(name: str) -> dict:
    """{name: value} of the `constexpr int|size_t kName = value;` lines
    of csrc/<name>."""
    text = (_build.CSRC / name).read_text()
    return {key: int(value) for key, value in re.findall(
        r'constexpr (?:int|size_t) (k\w+) = (\d+);', text)}


def test_python_constants_equal_the_kernels():
    """The launch plans choose with copies of the kernels' constants."""
    cuh = _constants('nms_common.cuh')
    assert cuh['kMaxN'] == cuda_nms.MAX_K
    assert cuh['kMaxSmem'] == cuda_nms.SMEM_LIMIT
    assert cuh['kMaskThreads'] == cuda_nms.MASK_THREADS
    assert cuh['kMaxWalkWarps'] == cuda_nms.MAX_WALK_CLASSES
    assert cuh['kBatch'] == cuda_nms.BATCH
    assert _constants('decode_nms.cu')['kDecodeThreads'] == \
        cuda_dn.DECODE_THREADS


def test_launch_plan_is_cached_per_shape():
    assert cuda_nms.launch_plan(32, 128, 12) is \
        cuda_nms.launch_plan(32, 128, 12)
    assert cuda_dn.launch_plan(8, 845, 80) is cuda_dn.launch_plan(8, 845, 80)


def test_plans_raise_above_the_cap():
    assert cuda_nms.MAX_K == cuda_dn.MAX_N == 8192
    with pytest.raises(ValueError, match='at most 8192'):
        cuda_nms.launch_plan(1, 8193, 3)
    with pytest.raises(ValueError, match='at most 8192'):
        cuda_dn.launch_plan(1, 8193, 3)


def test_mask_rows_shrink_for_few_frames():
    assert cuda_nms.mask_plan(1, 845)['rows'] == 8
    assert cuda_nms.mask_plan(8, 1805)['rows'] == 32
    assert cuda_nms.mask_plan(8, 845)['rows'] == 16


# --------------------------------------------------------------- build key
def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    (tmp_path / 'k.cu').write_text('#include "common.cuh"\n')
    (tmp_path / 'common.cuh').write_text('// v1\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    first = _build._library_path('k')
    assert _build._library_path('k') == first
    (tmp_path / 'common.cuh').write_text('// v2\n')
    second = _build._library_path('k')
    assert second != first
    (tmp_path / 'k.cu').write_text('#include "common.cuh"\n// edit\n')
    assert _build._library_path('k') not in (first, second)
    assert _build.sources() == ['k']
