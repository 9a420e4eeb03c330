"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA card, `nvcc` (the NMS kernel builds from
object_tracking_tpu_torch/ops/cuda/csrc/ at first use) and `nvidia-smi`.
Without a card, or outside a checkout, it exits non-zero and prints no
result. Each phase prints one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, both TF32 flags (set off, so float32 is float32), the
   kernel build time and ptxas' resource line;
2. kernel: the NMS kernel against its plain PyTorch twin at the main
   path's shape (F=32 frames = B·T at B=8, T=4; K=128; C=12) and at the
   uncapped K=845; the two must agree exactly (max_abs_diff == 0) and
   suppress something; kernel and plain times by CUDA events;
3. path: a JointPredictor at bench.py's model (416², T=4, 12 classes,
   5 anchors, ConvLSTM-512, full width, random weights from a seed)
   serves three streamed predict_batch calls at B=8 and three
   predict_window calls at B=1. The kernel's launch count must rise by
   one per call, and the same calls with impl='sort' must give identical
   detections and ids. Then frames/s at B=1 and B=8, float32 and
   bfloat16;
4. profile: per predict call, device time by kernel category under
   torch.profiler, the device's busy and idle share of the call's wall
   time, and the costliest kernels;
5. the kernels line (each kernel's launches on the path, error, times and
   bound), the nvidia-smi line, and last
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from object_tracking_tpu_torch.config import LABELS_MOT17, YOLOV2_ANCHORS
from object_tracking_tpu_torch.inference import JointPredictor
from object_tracking_tpu_torch.models import MultiObjDetTracker
from object_tracking_tpu_torch.ops.cuda import _build
from object_tracking_tpu_torch.ops.cuda import nms as cuda_nms
from object_tracking_tpu_torch.ops.decode import decode_netout
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
IOU_OPS_PER_PAIR = 14      # 4 min/max + 2 sub + 2 clamp + mul, add, sub,
                           # max, div, compare
WALK_OPS_PER_CANDIDATE = 3  # select, compare, suppress per round and class

NET = 416
T = 4
NUM_CLASSES = 12
NMS_THRESHOLD = 0.45


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int) -> dict:
    """Device time of fn() by kernel name under torch.profiler:
    {name: [launches per call, device ms per call]}; empty when the
    profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {evt.key: [evt.count / iters, evt.device_time_total / 1e3 / iters]
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.device_time_total > 0}


# kernel-name fragments → category of the path's device time
# (first match wins: cuDNN's batch-norm kernels also say 'cudnn')
CATEGORIES = (
    ('nms_scores', ('nms_scores',)),
    ('batch_norm', ('batch_norm', 'batchnorm', 'bn_fw', 'welford')),
    ('convolution', ('conv', 'cudnn', 'gemm', 'xmma', 'cutlass', 'sm90_',
                     'winograd', 'fft', 'pointwise_mult_and_sum')),
    ('memcpy', ('memcpy', 'memset')),
)


def breakdown(kernels: dict, wall_ms: float) -> dict:
    """Device time of one call by category, its busy and idle share of
    the call's wall time, and the six costliest kernels."""
    if not kernels:
        return {'device_time': 'not measured (profiler saw no device '
                               'activity)'}
    cats: dict = {}
    for name, (n, ms) in kernels.items():
        low = name.lower()
        cat = next((c for c, keys in CATEGORIES
                    if any(k in low for k in keys)), 'other')
        acc = cats.setdefault(cat, [0.0, 0.0])
        acc[0] += n
        acc[1] += ms
    busy = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    return {'wall_ms': wall_ms, 'device_busy_ms': busy,
            'idle_share': 1.0 - busy / wall_ms,
            'launches': sum(n for n, _ in kernels.values()),
            'by_category': {c: {'launches': n, 'ms': ms}
                            for c, (n, ms) in cats.items()},
            'top': [[name[:90], n, ms] for name, (n, ms) in top]}


def candidates(rng, frames: int, k: int, c: int):
    """Seeded candidate sets as tests/test_pallas.py makes them: boxes in
    the middle of the image, live scores in half or more of the entries;
    frame 0 all dead."""
    boxes = np.stack([rng.uniform(0.2, 0.8, (frames, k)),
                      rng.uniform(0.2, 0.8, (frames, k)),
                      rng.uniform(0.05, 0.4, (frames, k)),
                      rng.uniform(0.05, 0.4, (frames, k))],
                     -1).astype(np.float32)
    scores = rng.rand(frames, k, c).astype(np.float32)
    dead = rng.uniform(0.3, 0.9, (frames, 1, 1))
    scores[scores < dead] = 0.0
    scores[0] = 0.0
    return boxes, scores


def nms_bound(out: torch.Tensor, k: int, c: int, frames: int) -> dict:
    """Least time for the NMS of these inputs: bytes (boxes and scores read
    once, out written once) over HBM rate, operations (the K² IoU and,
    per kept box, one walk round over K candidates) over the float32
    rate. Each kept box took exactly one round of its class."""
    nbytes = frames * k * (4 + c) * 4 + frames * k * c * 4
    rounds = int((out > 0).sum())
    ops = frames * k * k * IOU_OPS_PER_PAIR + \
        rounds * k * WALK_OPS_PER_CANDIDATE
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'bytes': nbytes, 'operations': ops, 'rounds': rounds}


def kernel_phase(device) -> dict:
    """NMS kernel vs its plain twin on the card, exact; timings."""
    rng = np.random.RandomState(0)
    checks = []
    for frames, k in ((32, 128), (4, 845)):
        boxes, scores = candidates(rng, frames, k, NUM_CLASSES)
        b = torch.from_numpy(boxes).to(device)
        s = torch.from_numpy(scores).to(device)
        out = cuda_nms.nms_scores(b, s, NMS_THRESHOLD)
        plain = cuda_nms.nms_scores_plain(b, s, NMS_THRESHOLD)
        torch.cuda.synchronize()
        diff = (out - plain).abs().max().item()
        suppressed = int(((s > 0) & (out == 0)).sum())
        if diff != 0 or suppressed == 0 or out[0].any():
            raise AssertionError(f'nms_scores F={frames} K={k}: '
                                 f'max_abs_diff={diff}, '
                                 f'suppressed={suppressed}')
        checks.append({'frames': frames, 'k': k, 'max_abs_diff': diff,
                       'live': int((s > 0).sum()), 'suppressed': suppressed})
    # time at the main path's shape: F = B·T = 32, K = 128, C = 12
    boxes, scores = candidates(rng, 32, 128, NUM_CLASSES)
    b = torch.from_numpy(boxes).to(device)
    s = torch.from_numpy(scores).to(device)
    out = cuda_nms.nms_scores(b, s, NMS_THRESHOLD)
    kernel_ms = cuda_ms(lambda: cuda_nms.nms_scores(b, s, NMS_THRESHOLD),
                        iters=200, warmup=10)
    plain_ms = cuda_ms(lambda: cuda_nms.nms_scores_plain(b, s,
                                                         NMS_THRESHOLD),
                       iters=10)
    kernel_ms_2 = cuda_ms(lambda: cuda_nms.nms_scores(b, s, NMS_THRESHOLD),
                          iters=200, warmup=10)
    # the kernel's own device time; the event times above span 200
    # back-to-back wrapper calls and include any host launch gap
    device = [ms for name, (_, ms) in device_times(
        lambda: cuda_nms.nms_scores(b, s, NMS_THRESHOLD), 50).items()
        if 'nms_scores' in name]
    return {'checks': checks,
            'kernel_device_ms': device[0] if device else None,
            'kernel_call_ms': [kernel_ms, kernel_ms_2],
            'plain_ms': plain_ms, **nms_bound(out, 128, NUM_CLASSES, 32)}


def requests(rng, batch: int, count: int):
    return [rng.rand(batch, T, NET, NET, 3).astype(np.float32)
            for _ in range(count)]


def pick_obj_threshold(model, clips, device) -> float:
    """A threshold that leaves at least 64 of 845 candidates live in every
    frame of the first request: the 64th best class score of the worst
    frame, nudged down."""
    with torch.no_grad():
        out = model(torch.from_numpy(clips).to(device), train=True)
    anchors = torch.tensor(YOLOV2_ANCHORS, device=device)
    _, scores = decode_netout(out['track'], anchors, 0.0)
    best = scores.amax(-1).flatten(0, 1)                     # (B·T, 845)
    kth = best.sort(dim=-1, descending=True).values[
        :, min(63, best.shape[1] - 1)]
    return float(kth.min()) * 0.999


def probe_nms(model, clips, obj_threshold, device) -> dict:
    """Candidates and suppressions of the first request's B·T frames."""
    with torch.no_grad():
        out = model(torch.from_numpy(clips).to(device), train=True)
    anchors = torch.tensor(YOLOV2_ANCHORS, device=device)
    boxes, scores = decode_netout(out['track'], anchors, obj_threshold)
    n, c = scores.shape[-2:]
    _, kept = greedy_nms_scores(boxes.reshape(-1, n, 4),
                                scores.reshape(-1, n, c), NMS_THRESHOLD,
                                impl='kernel')
    live = (scores.reshape(-1, n, c).amax(-1) > 0).sum(-1)   # per frame
    capped = torch.clamp(live, max=kept.shape[1])
    survivors = (kept.amax(-1) > obj_threshold).sum(-1)
    if not bool((live > 0).all()):
        raise AssertionError('a frame reached NMS with no live candidate')
    return {'frames': int(live.numel()),
            'live_candidates_min': int(live.min()),
            'live_candidates_max': int(live.max()),
            'candidates_into_nms': int(capped.sum()),
            'suppressed': int((capped - survivors).sum())}


def serve(pred, batch_reqs, window_reqs):
    """The served requests: streamed predict_batch calls, then a stream of
    predict_window calls. Returns the per-frame detection lists of every
    call, flattened, and the number of predict calls."""
    pred.reset_batch_state()
    pred.reset_state()
    frames = []
    for clips in batch_reqs:
        for clip in pred.predict_batch(clips):
            frames.extend(clip)
    for clip in window_reqs:
        frames.extend(pred.predict_window(clip[0]))
    return frames, len(batch_reqs) + len(window_reqs)


def check_results(frames, obj_threshold) -> dict:
    """Every frame has a detection; every box is finite; every score lies
    in (obj_threshold, 1]."""
    for frame in frames:
        if not frame:
            raise AssertionError('a served frame has no detection')
        for d in frame:
            if not (np.isfinite(d['box']).all()
                    and obj_threshold < d['score'] <= 1.0):
                raise AssertionError(f'bad detection {d}')
    return {'frames': len(frames),
            'detections': sum(map(len, frames)),
            'track_ids': len({d['track_id'] for f in frames for d in f})}


def fps(pred, clips, iters: int, batch_call: bool) -> float:
    """Frames/s of the public call, host clock; every call ends with its
    results on the host, so it is synchronised."""
    call = pred.predict_batch if batch_call else (
        lambda c: pred.predict_window(c[0]))
    for _ in range(2):
        call(clips)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        call(clips)
    torch.cuda.synchronize()
    return iters * clips.shape[0] * clips.shape[1] / (
        time.perf_counter() - start)


def path_phase(device, smi: str) -> dict:
    torch.manual_seed(0)
    model = MultiObjDetTracker(num_classes=NUM_CLASSES, num_anchors=5,
                               convlstm_features=512, width_div=1)
    model = model.to(device)
    rng = np.random.RandomState(1)
    batch_reqs = requests(rng, 8, 3)
    window_reqs = requests(rng, 1, 3)
    obj_threshold = pick_obj_threshold(model, batch_reqs[0], device)
    probe = probe_nms(model, batch_reqs[0], obj_threshold, device)
    kwargs = dict(labels=LABELS_MOT17, obj_threshold=obj_threshold,
                  nms_threshold=NMS_THRESHOLD, net_size=(NET, NET),
                  device=device)

    torch.backends.cudnn.deterministic = True    # both runs: same netouts
    kernel_pred = JointPredictor(model, YOLOV2_ANCHORS, **kwargs)
    cuda_nms.nms_scores.launches = 0
    results, calls = serve(kernel_pred, batch_reqs, window_reqs)
    launches = cuda_nms.nms_scores.launches
    if launches != calls:
        raise AssertionError(f'nms_scores launched {launches} times in '
                             f'{calls} predict calls')
    sort_pred = JointPredictor(model, YOLOV2_ANCHORS, nms_impl='sort',
                               **kwargs)
    sort_results, _ = serve(sort_pred, batch_reqs, window_reqs)
    if sort_results != results:
        raise AssertionError("impl='kernel' and impl='sort' disagree")
    torch.backends.cudnn.deterministic = False
    summary = check_results(results, obj_threshold)

    rates, profiles = {}, {}
    bf16 = MultiObjDetTracker(num_classes=NUM_CLASSES, num_anchors=5,
                              convlstm_features=512, width_div=1,
                              dtype=torch.bfloat16).to(device)
    bf16.load_state_dict(model.state_dict())
    for name, m in (('float32', model), ('bfloat16', bf16)):
        pred = JointPredictor(m, YOLOV2_ANCHORS, **kwargs)
        for batch, clips in ((8, batch_reqs[0]), (1, window_reqs[0])):
            key = f'b{batch}_{name}'
            rates[f'fps_{key}'] = fps(pred, clips, 5 if batch > 1 else 10,
                                      batch > 1)
            call = (lambda c=clips, p=pred: p.predict_batch(c)) \
                if batch > 1 else \
                (lambda c=clips, p=pred: p.predict_window(c[0]))
            profiles[key] = breakdown(device_times(call, 2),
                                      1e3 * batch * T / rates[f'fps_{key}'])
    return {'phase': 'path', 'net': NET, 'T': T, 'classes': NUM_CLASSES,
            'anchors': 5, 'convlstm_features': 512, 'width_div': 1,
            'obj_threshold': obj_threshold, 'nms_probe': probe,
            'predict_calls': calls, 'nms_launches': launches,
            'kernel_equals_sort': True, **summary, **rates,
            'card': smi}, profiles


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script needs one GPU',
              file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    start = time.perf_counter()
    _build.build(_build.sources())
    build_s = time.perf_counter() - start
    ptxas = [line.strip() for log in _build.build_logs.values()
             for line in log.splitlines() if 'registers' in line]
    emit({'phase': 'device', 'nvidia_smi': smi,
          'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda,
          'tf32': {'cuda.matmul.allow_tf32':
                   torch.backends.cuda.matmul.allow_tf32,
                   'cudnn.allow_tf32': torch.backends.cudnn.allow_tf32},
          'kernel_build_s': build_s, 'ptxas': ptxas})

    kern = kernel_phase(device)
    emit({'phase': 'kernel', **kern, 'card': smi})
    path, profiles = path_phase(device, smi)
    emit(path)
    emit({'phase': 'profile', 'per_call': profiles, 'card': smi})
    emit({'kernels': [{
        'name': 'nms_scores',
        'route': 'cuda',
        'source': 'object_tracking_tpu_torch/ops/cuda/csrc/nms_scores.cu',
        'replaces': 'object_tracking_tpu/ops/pallas/nms_pallas.py:83',
        'shapes': {'boxes': [32, 128, 4], 'scores': [32, 128, NUM_CLASSES]},
        'launches': path['nms_launches'],
        'max_abs_err': max(c['max_abs_diff'] for c in kern['checks']),
        'max_abs_diff': max(c['max_abs_diff'] for c in kern['checks']),
        'ms': kern['kernel_device_ms'] or min(kern['kernel_call_ms']),
        'kernel_ms': kern['kernel_device_ms'] or min(kern['kernel_call_ms']),
        'call_ms': min(kern['kernel_call_ms']),
        'plain_ms': kern['plain_ms'],
        'bound_ms': kern['bound_ms'], 'bound_by': kern['bound_by'],
        # no installed PyTorch call computes per-class greedy NMS over a
        # score matrix (torchvision's batched_nms is not installed, and it
        # is single-label hard NMS)
        'library_ms': None}]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
