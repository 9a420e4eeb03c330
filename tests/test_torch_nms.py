"""Port parity: greedy NMS and the CUDA kernel's plain twin vs JAX.

The port's 'sort' and 'matmul' walks and the kernel's plain twin
(`nms_scores_plain`, which CPU tensors run in place of the kernel) take the
same seeded candidates as JAX `greedy_nms_scores(impl='sort')` and the
Pallas kernel in interpret mode. Tolerance: exact (atol=0) for the twin
against the Pallas kernel (same IoU formula, same walk); 1e-6 otherwise
(the two IoU formulas differ in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.ops.nms import greedy_nms_scores as jax_nms
from object_tracking_tpu.ops.pallas import nms_scores_pallas
from object_tracking_tpu_torch.ops.cuda import nms as cuda_nms
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores

THRESHOLDS = [0.3, 0.45, 0.6]


def _random_candidates(rng, n=64, c=6, frac_dead=0.5):
    boxes = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n),
                      rng.uniform(0.05, 0.4, n),
                      rng.uniform(0.05, 0.4, n)], -1).astype(np.float32)
    scores = rng.rand(n, c).astype(np.float32)
    scores[scores < frac_dead] = 0.0
    return boxes, scores


def _jax_sort(boxes, scores, thresh, top_k=0):
    b, s = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                   top_k=top_k, impl='sort')
    return np.asarray(b), np.asarray(s)


def _pallas(boxes, scores, thresh):
    return np.asarray(nms_scores_pallas(jnp.asarray(boxes),
                                        jnp.asarray(scores), thresh,
                                        interpret=True))


def _port(boxes, scores, thresh, impl, top_k=0):
    b, s = greedy_nms_scores(torch.from_numpy(boxes),
                             torch.from_numpy(scores), thresh, top_k=top_k,
                             impl=impl)
    return b.numpy(), s.numpy()


@pytest.mark.parametrize('impl', ['sort', 'matmul'])
@pytest.mark.parametrize('thresh', THRESHOLDS)
def test_port_impls_match_jax_sort(rng, impl, thresh):
    boxes, scores = _random_candidates(rng)
    _, ref = _jax_sort(boxes, scores, thresh)
    _, out = _port(boxes, scores, thresh, impl)
    assert (ref > 0).sum() < (scores > 0).sum()      # something suppressed
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize('thresh', THRESHOLDS)
def test_plain_twin_equals_pallas_kernel_exactly(rng, thresh):
    boxes, scores = _random_candidates(rng, n=64, c=6)
    ref = _pallas(boxes, scores, thresh)
    out = cuda_nms.nms_scores_plain(torch.from_numpy(boxes[None]),
                                    torch.from_numpy(scores[None]), thresh)
    np.testing.assert_array_equal(out[0].numpy(), ref)
    np.testing.assert_allclose(ref, _jax_sort(boxes, scores, thresh)[1],
                               atol=1e-6, rtol=0)


def test_plain_twin_equals_pallas_kernel_at_1805(rng):
    """The 19x19x5 lattice (608² input): K = 1805 candidates, above the
    1024 the CUDA kernels once took; the twin still equals the Pallas
    kernel exactly, and the kernels' launch plan takes it."""
    boxes, scores = _random_candidates(rng, n=1805, c=4)
    scores[scores < 0.95] = 0.0              # ~90 live per class
    ref = _pallas(boxes, scores, 0.45)
    out = cuda_nms.nms_scores_plain(torch.from_numpy(boxes[None]),
                                    torch.from_numpy(scores[None]), 0.45)
    np.testing.assert_array_equal(out[0].numpy(), ref)
    assert 0 < (ref > 0).sum() < (scores > 0).sum()
    assert cuda_nms.launch_plan(1, 1805, 4)['walk']['smem'] <= \
        cuda_nms.SMEM_LIMIT


def _twin(boxes, scores, thresh=0.45):
    return cuda_nms.nms_scores_plain(torch.from_numpy(boxes[None]),
                                     torch.from_numpy(scores[None]),
                                     thresh)[0].numpy()


def _first_round(boxes, scores, thresh):
    """The Pallas walk stopped after its first round: each class with a
    positive score keeps its best candidate (first index on ties) and
    kills the others whose IoU with it is >= thresh."""
    ge = (cuda_nms.pallas_iou(torch.from_numpy(boxes[None]))[0]
          >= thresh).numpy()
    alive = np.ones_like(scores)
    for c in range(scores.shape[1]):
        if scores[:, c].max() > 0:
            best = scores[:, c].argmax()
            alive[ge[best], c] = 0.0
            alive[best, c] = 1.0
    return scores * alive


@pytest.mark.parametrize('bad', ['nan', 'inf'])
def test_non_finite_score_known_difference_from_pallas(rng, bad):
    """A known difference, kept (ROADMAP queue 3). The Pallas loop runs
    while the max of scores·alive·(1 − done) over the whole frame is > 0.
    A NaN score makes that max NaN at once, so Pallas suppresses nothing
    in any class. An inf score is picked first, and then inf·0 = NaN ends
    the loop after that one round, in every class. The twin (like the
    CUDA kernels, held to it on the card) skips only a NaN's class and
    walks an inf's class to its end; its other classes come out as on
    finite input."""
    boxes, scores = _random_candidates(rng, n=48, c=4)
    bad_scores = scores.copy()
    bad_scores[5, 1] = np.nan if bad == 'nan' else np.inf
    ref = _pallas(boxes, bad_scores, 0.45)
    out = _twin(boxes, bad_scores)
    others = [0, 2, 3]
    finite = _twin(boxes, scores)
    np.testing.assert_array_equal(out[:, others], finite[:, others])
    if bad == 'nan':
        np.testing.assert_array_equal(ref, bad_scores)
        np.testing.assert_array_equal(out[:, 1], bad_scores[:, 1])
    else:
        np.testing.assert_array_equal(ref, _first_round(boxes, bad_scores,
                                                        0.45))
        assert out[5, 1] == np.inf and ref[5, 1] == np.inf
    # the difference: Pallas suppresses less in the finite classes
    assert ((out[:, others] == 0) & (ref[:, others] > 0)).any()
    assert not ((ref[:, others] == 0) & (out[:, others] > 0)).any()


@pytest.mark.parametrize('impl', ['sort', 'matmul', 'twin'])
def test_all_dead(rng, impl):
    boxes, scores = _random_candidates(rng, n=16, c=3)
    scores[:] = 0.0
    if impl == 'twin':
        out = cuda_nms.nms_scores_plain(torch.from_numpy(boxes[None]),
                                        torch.from_numpy(scores[None]),
                                        0.45)[0].numpy()
    else:
        out = _port(boxes, scores, 0.45, impl)[1]
    assert (out == 0).all()
    assert (_pallas(boxes, scores, 0.45) == 0).all()


@pytest.mark.parametrize('impl', ['sort', 'matmul', 'twin'])
def test_exact_score_ties(rng, impl):
    """Equal scores on overlapping boxes: the lower index wins, in every
    formulation (stable sort / first-index argmax)."""
    boxes, scores = _random_candidates(rng, n=32, c=4, frac_dead=0.0)
    scores = np.round(scores * 4) / 4        # values in {0, .25, .5, .75, 1}
    boxes[1::2] = boxes[0::2]                # pairs of identical boxes
    if impl == 'twin':
        out = cuda_nms.nms_scores_plain(torch.from_numpy(boxes[None]),
                                        torch.from_numpy(scores[None]),
                                        0.45)[0].numpy()
        np.testing.assert_array_equal(out, _pallas(boxes, scores, 0.45))
    else:
        out = _port(boxes, scores, 0.45, impl)[1]
    np.testing.assert_allclose(out, _jax_sort(boxes, scores, 0.45)[1],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize('impl', ['sort', 'matmul', 'twin'])
def test_batched_frames(rng, impl):
    frames = [_random_candidates(rng, n=48, c=5) for _ in range(4)]
    frames[2][1][:] = 0.0                    # one all-dead frame
    boxes = np.stack([f[0] for f in frames])
    scores = np.stack([f[1] for f in frames])
    if impl == 'twin':
        out = cuda_nms.nms_scores_plain(torch.from_numpy(boxes),
                                        torch.from_numpy(scores),
                                        0.45).numpy()
    else:
        out = _port(boxes, scores, 0.45, impl)[1]
    for f in range(4):
        ref = (_pallas(boxes[f], scores[f], 0.45) if impl == 'twin'
               else _jax_sort(boxes[f], scores[f], 0.45)[1])
        if impl == 'twin':
            np.testing.assert_array_equal(out[f], ref)
        else:
            np.testing.assert_allclose(out[f], ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize('impl', ['sort', 'matmul'])
def test_top_k_cap_matches_lax_top_k(rng, impl):
    """N = 845 (13x13x5) > K = 128, with most candidates tied at 0: the
    kept (K, 4) boxes and (K, C) scores equal JAX's, order included."""
    boxes, scores = _random_candidates(rng, n=845, c=12)
    scores[scores < 0.97] = 0.0              # ~300 live rows, ties at 0
    ref_b, ref_s = _jax_sort(boxes, scores, 0.45, top_k=128)
    out_b, out_s = _port(boxes, scores, 0.45, impl, top_k=128)
    assert out_b.shape == (128, 4) and out_s.shape == (128, 12)
    np.testing.assert_array_equal(out_b, ref_b)
    np.testing.assert_allclose(out_s, ref_s, atol=1e-6, rtol=0)


def test_top_k_tie_order():
    """The case torch.topk gets wrong: [0, 1, 0, 1, .5, 0], k=4 →
    lax.top_k's [1, 3, 4, 0]."""
    best = np.array([0, 1, 0, 1, .5, 0], np.float32)
    boxes = np.arange(24, dtype=np.float32).reshape(6, 4)
    b, _ = greedy_nms_scores(torch.from_numpy(boxes),
                             torch.from_numpy(best[:, None]), 0.45,
                             top_k=4, impl='sort')
    np.testing.assert_array_equal(b.numpy()[:, 0] // 4, [1, 3, 4, 0])


def test_kernel_impl_on_cpu_raises(rng):
    boxes, scores = _random_candidates(rng, n=8, c=2)
    with pytest.raises(ValueError, match='CUDA'):
        greedy_nms_scores(torch.from_numpy(boxes), torch.from_numpy(scores),
                          impl='kernel')


def test_auto_on_cpu_is_sort_and_launches_nothing(rng):
    boxes, scores = _random_candidates(rng)
    before = cuda_nms.nms_scores.launches
    _, out = _port(boxes, scores, 0.45, 'auto')
    np.testing.assert_array_equal(out, _port(boxes, scores, 0.45, 'sort')[1])
    assert cuda_nms.nms_scores.launches == before


def test_wrapper_runs_twin_on_cpu_and_checks_inputs(rng):
    boxes, scores = _random_candidates(rng, n=16, c=3)
    b, s = torch.from_numpy(boxes[None]), torch.from_numpy(scores[None])
    np.testing.assert_array_equal(
        cuda_nms.nms_scores(b, s, 0.45).numpy(),
        cuda_nms.nms_scores_plain(b, s, 0.45).numpy())
    with pytest.raises(ValueError):
        cuda_nms.nms_scores(b[0], s[0])                  # no frame dim
    with pytest.raises(TypeError):
        cuda_nms.nms_scores(b.double(), s.double())
    with pytest.raises(ValueError):
        cuda_nms.nms_scores(b, s.transpose(1, 2).contiguous())
    with pytest.raises(ValueError):
        cuda_nms.nms_scores(torch.cat([b, b]).transpose(0, 1)[:1],
                            torch.cat([s, s]).transpose(0, 1)[:1])
