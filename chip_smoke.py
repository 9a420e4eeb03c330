"""Drive the PyTorch port's serving, detector, training, single-object,
deep-head, exported-serving, parallel, native-data, tensor-parallel and
data-parallel training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA card, `nvcc` (the kernels build from
object_tracking_tpu_torch/ops/cuda/csrc/ at first use, one nvcc process
per source, all at once) and `nvidia-smi`. Without a card, or outside a
checkout, it exits non-zero and prints no result. Each phase prints one
JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, both TF32 flags (set off, so float32 is float32), the
   kernel build time and ptxas' resource lines;
2. kernel: the NMS kernel against its plain PyTorch twin at the main
   path's shape (F=32 frames = B·T at B=8, T=4; K=128; C=12), at the
   full 13x13x5 lattice K=845, at the 19x19x5 lattice K=1805 and at
   each shape the paths give it ((32,128,12), (4,128,12), (8,16,80),
   (1,128,80), (16,16,80)) and Faster R-CNN's two ((8,6000,1) with ranked
   scores at IoU 0.7, (160,300,1) at 0.3); the two must agree exactly
   (max_abs_diff == 0) and suppress something. At each path shape, its
   device time under
   torch.profiler, summed over its two passes (mask, walk) and split by
   pass, its call time by CUDA events, the wrapper's host cost per call
   (host_us, beside torch_launch_us, the host cost of one plain torch
   launch), the plain twin's time and the bound. Then assign: the
   identity-assignment kernel against its plain twin on a seeded 40-frame
   sequence at B=8 and B=1 (T=4, S=64, M=128, the table filled), and on
   dense, tied frames that take each of its sort branches up to S=1024,
   M=4096: ids and integer fields equal, boxes and vel bit for bit, one
   launch a window; its device time, call time, host cost, the twin's
   time and the bound. Then mish: the Mish kernel inside YOLOv4
   (portbench/configs/yolov4_coco_608.cfg, seeded weights, BatchNorm
   statistics set from the frames) at B=8, 608²: each of the forward's 72
   Mish calls against the eager chain x·tanh(softplus(x)) on the same
   input, bit for bit (NaNs in the same places), one launch a call, the
   counters' engaged share 1; the kernel against the chain on special
   values (±0, ±inf, NaN, around 20, ±88–90, subnormals) and normals,
   whole, with a tail and off 16 bytes, in float32 and bfloat16; at each
   distinct Mish shape its device time under torch.profiler (repeated on
   one input, so the smaller maps stay in L2) beside its bound, the
   chain's and F.mish's (library_ms: a yardstick the port never calls),
   those times summed over the 72 layers, its call time by CUDA events and
   the wrapper's host cost a call. Then batch_norm: full-width Darknet-19
   at B=32, 416², one batch-statistics forward and backward, each of its
   22 BatchNorms through the kernels (two launcher calls a layer, the
   counters' engaged share 1) and the layout each input comes in; at each
   of those 22 inputs the kernels' y, dx, dweight and dbias no further
   from a float64 reference than max(2 × the plain path's, 1e-6) in
   relative L2 (F.batch_norm's distance beside), the kernels' forward and
   backward device time beside the plain path's and F.batch_norm's (a
   yardstick the port never calls), each with autograd's backward, and
   the bound (32 B an element), and the forward alone (serving's call)
   beside its bound (12 B) and its host cost a call. Then rcnn: Faster
   R-CNN VGG16 (21 VOC classes, the benchmark cell's draw: trunk and
   fc6/fc7 sqrt(1 / fan_in), the RPN and cls_score 0.01, bbox_pred 0.001)
   serves one detect_images call of 8 seeded 562x1000 scenes with a
   recorder attached: kernel 1 launches twice (the proposal NMS, the
   per-class NMS) and the RoI-pooling kernel once, counted from that
   call, and the counters' engaged share is 1; each of those three
   launches' own inputs through the kernel and its plain twin on the
   card, bit for bit (NaNs in the same places); on those inputs each
   kernel's device time under torch.profiler, its call time, host cost,
   the twin's time and the bound (RoI pooling: the output written and
   conv5_3 read once, at 3.35 TB/s);
3. path: a JointPredictor at bench.py's model (416², T=4, 12 classes,
   5 anchors, ConvLSTM-512, full width, random weights from a seed)
   serves three streamed predict_batch calls at B=8 and three
   predict_window calls at B=1. The NMS and assignment kernels' launch
   counts must each rise by one per call, the BatchNorm kernels' by one
   per BatchNorm call (bn_mode='batch', the counters' engaged share 1),
   and the same calls with
   impl='sort' must give identical detections and ids. Then frames/s at
   B=1 and B=8, float32 and bfloat16, each the median of three samples
   (all three kept: these calls are host-bound and spread widely);
4. profile: per predict call, device time by kernel category under
   torch.profiler, the device's busy and idle share of the call's wall
   time, and the costliest kernels;
5. detector: the full-width YOLOv2Detector at DetectorConfig() defaults
   (Darknet-19, 416², COCO's 80 classes, 5 anchors; random weights from
   seed 0, BatchNorm statistics set from the first batch) runs
   forward_batch on 8 images and the body of predict on 1; the NMS
   kernel launches once per call, and nms_impl='sort' gives identical
   results. Images/s at N=8 and N=1, float32 and bfloat16 (median of
   three samples, as above), and the profile of each call;
6. golden: CfgDetector on tests/fixtures/yolov2-micro.cfg/.weights and
   VGG16PriorSource on vgg16-micro.npz detect the four committed scenes
   (read from golden_scenes_160.npz: the card's machine has no cv2) as
   golden_boxes.json / golden_vgg16.json pin them, with their mAP@0.5;
7. decode_nms: the fused decode+NMS kernel against its twin on the
   detector phase's netouts, on seeded 13x13x5x25 (with one planted
   overflowing width), 4x4x3x9 and 19x19x5x85 (N=1805) heads and on an
   all-dead frame, and against the staged path (decode_netout →
   greedy_nms_scores(top_k=0) on the NMS kernel at K=N); a probe of its
   sigmoid and exp against torch's; device times at F=8 and F=1, summed
   over its three passes (decode, mask, walk) and split by pass, its host
   cost per call, the twin's and the staged path's times, and the bound;
8. train: the joint trainer's fused step (make_joint_train_step_fused:
   /255, augmentation, target encoding, forward, backward and Adam on the
   card) at bench.py's model, flax-like init from seed 0, on seeded raw
   uint8 windows of filled rectangles (max_boxes 50). A reduced model
   (width_div=8, 128², T=4, B=2, no augmentation) takes one float32 step
   on the card and on the CPU from the same weights and batch: metrics,
   gradients, updated parameters and BatchNorm statistics agree within
   the CPU parity tests' tolerances; a checkpoint saved after step 2 and
   restored into a fresh state gives step 3 equal to 1e-6 (cuDNN
   deterministic for that check only). At full width: one step under
   torch.cuda.set_sync_debug_mode('error'), and one whose BatchNorm
   launches and engaged share (1) are counted; 30 steps on one fixed batch
   (B=1, float32, lr 1e-4) with a finite, falling loss; the trained
   model serves three predict_window calls through JointPredictor, kernel
   1 launching once per call, identical to nms_impl='sort'; then, from
   those weights at lr 0 over 4 unseen batches, each configuration alone
   on the card, steps/s at B=1 and B=4 in float32 and bfloat16 (median of
   three samples, all kept), the first step's time, peak memory, every
   step's loss (finite), and each step's device time by category under
   torch.profiler;
9. tracker: the single-object pipeline at TrackerConfig() defaults over
   the full-width YOLOv2 prior of the detector phase (seed 0, BatchNorm
   statistics from the first batch). Two seeded videos of 16 frames at
   416² (drifting filled rectangles, fed through `loader=`: no cv2), each
   frame's object labelled with the class of the prior's best detection,
   go through TrackerSequenceBatches (T=4, B=4) precomputed and
   augmented: kernel 1 launches once per 16-frame precompute chunk and
   once per augmented batch, and nms_impl='sort' gives identical 'det',
   'target' and 'feats'. TinyTracker (LSTM-512, Global pool over
   13x13x1024) with the bbox head and bce, the bbox head with huber and
   the residual head, and the heatmap head (32² outputs): each takes one
   float32 step on the card and on the CPU from the same weights and
   batch (metrics, gradients, parameters within the CPU tests'
   tolerances), a step under sync-debug mode 'error', 30 steps on one
   batch at lr 1e-3 with a finite, falling loss, and steps/s (median of
   three samples, all kept), device time, idle share and launches in
   float32 and bfloat16. Then one epoch of `fit` with the tiny train and
   eval steps over the precomputed batches;
10. detector_train: make_detector_train_step on Darknet-19 at
   DetectorConfig() (416², 80 classes). A reduced cut (width_div=8,
   128², B=2) takes one float32 step on the card and on the CPU
   (metrics, gradients, parameters and BatchNorm statistics). At full
   width, flax-like init: a step under sync-debug mode 'error', 20 steps
   on one B=8 batch with a finite, falling loss, and from those weights
   at lr 0 steps/s, device time by category and peak memory at B=8 and
   B=32 (DetectorConfig.batch_size) in float32 and bfloat16. Then
   make_multihead_detector_train_step on a two-[yolo]-head cfg at 416²:
   one step on the card and on the CPU;
11. deep: the deep ConvLSTM head (convlstm_layers=2, `StackedConvLSTM`).
   One float32 fused train step at the train phase's reduced cut on the
   card and on the CPU (the same checks); at bench.py's model three
   streamed predict_window calls, kernel 1 once per call, identical to
   nms_impl='sort'; frames/s at B=1 against the single-layer head's in the
   same process (median of three samples, all kept) and both profiles;
12. serve: the train phase's trained weights exported with torch.export
   (`serving.export_joint`, kernel 1 as the custom op
   `ott_torch::nms_scores`) at B=8, T=4, 416², with the export's seconds
   and the artifact's MB. The artifact serves three streamed calls,
   kernel 1 once per call: labels and ids equal to JointPredictor's on the
   same weights and frames, boxes and scores within 1e-5. The B=1
   artifact is a deep head's (convlstm_layers=2) at the reduced cut
   (width_div=8, 128²): it round-trips its 4-leaf state, equals
   JointPredictor, and a fresh interpreter that never imports the port's
   models reloads it and serves the same. Frames/s served and through
   JointPredictor at B=8 in float32 (median of two samples, all kept);
13. parallel: the MoE head (moe_experts=4, moe_hidden=256) at bench.py's
   model: three B=8 and three B=1 predict calls beside the dense head
   (kernel 1 once per call, identical to nms_impl='sort'), the head's
   device time and frames/s (median of two samples, all kept); the MoE
   fused step at B=4 beside the dense one; the MoE step on the card
   against the CPU at the reduced cut; a world of one NCCL rank (tcp to
   localhost): the data-parallel step against the plain step,
   expert_parallel_moe with one expert and a one-stage pipeline against
   the dense forms; and a profile_trace of two reduced-cut steps holding
   CUDA kernel events and the spans' ranges;
14. native_data: the native data runtime's binding (data/native_loader.py)
   builds its library from native/ott_dataio.cpp with g++ into
   build/native/ (build seconds), or the phase reports the compiler's
   words and checks nothing more (the library needs libjpeg and libpng).
   Where it builds: the four golden scenes decoded by load_batch_u8 at
   160² against golden_scenes_160.npz (cv2's decode; mean |diff| < 0.02),
   load_batch equal to load_image per file, CfgDetector on the micro
   fixture detecting the natively decoded scenes as golden_boxes.json
   pins them (mAP@0.5; kernel 1 once), and the host NMS equal to kernel 1
   and its plain twin on seeded candidates at (32, 128, 12);
15. tensor_parallel: two spawned ranks, both on cuda:0, in a gloo world
   (NCCL refuses two ranks on one device; gloo takes the CUDA tensors of
   all_reduce and all_gather itself), mesh dp x tp = 1 x 2. At the train
   phase's reduced cut (width_div=8, 128², T=4, B=2, no augmentation,
   min_params 1 << 8) two fused steps under tensor parallelism against the
   dense step on the card from the same weights and batch: the first
   step's metrics (rtol 1e-4), every gathered gradient and parameter
   (relative L2 <= 1e-3), the two-step update (cosine >= 0.999, norm ratio
   within 5 %, loss within 1e-2), tp_sharding_summary, and each rank's
   parameter bytes against the dense model's; every sharded leaf is held
   as 1/2 of its planned axis. Then, in the same world at full width,
   tconv_lstm's input projection through the port's conv, sharded by
   shard_variables (each rank holds 1024 of the 2048 output channels,
   computes them and gathers the rest) against the same conv dense (max
   |diff| <= 1e-4 of the output's scale on every rank; both timed, host
   clock). Then the gathered TP-trained weights serve three
   predict_window calls through JointPredictor: kernel 1 once per call,
   identical to nms_impl='sort';
16. data_parallel_flows: the standalone detector step (Darknet-19 at
   DetectorConfig(): 416², 80 classes, B=8, random BatchNorm scales and
   biases) and the tiny step (TinyTracker LSTM-512 over (B=4, T=4,
   13x13x1024) features, bbox and heatmap heads, bce) with a mesh: at
   world size 1 over NCCL against the plain steps (metrics, gradients,
   parameters) with the steps/s of each in this process; then over two
   gloo ranks on cuda:0, each holding half of each global batch, two
   steps against the one-rank step on the card (the first step's metrics
   rtol 1e-4, gradients relative L2 <= 1e-3, the two-step update's cosine
   > 0.999 and norm ratio within 5 %, every rank on the same weights; the
   detector in float64, since at 416² float32 BatchNorm lies up to 6e-3
   from float64 in either layout, and in float32 reported);
   the MoE joint model at the reduced cut on a ragged batch (B=3, which
   shard_batch replicates: each rank runs the one-rank step) at the same
   bars; and single_object_tracking(synthetic=True) over the same ranks,
   one epoch on one 11-frame 416² video fed as arrays (no cv2 here), its
   frozen full-width YOLOv2 prior running kernel 1 on each rank's global
   batch: each rank's step sees half of each batch, the ranks end on the
   same weights, within the same bars of the one-rank flow's update, and
   only rank 0 writes;
17. each phase's seconds, the kernels line (each kernel's launches on the
   driven paths, error, times and bound), the nvidia-smi line, and last
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from object_tracking_tpu_torch.config import (
    LABELS_COCO, LABELS_MOT17, TRACK_GATE_IOU, YOLOV2_ANCHORS, DetectorConfig)
from object_tracking_tpu_torch.data import (
    Annotation, ObjectAnnotation, TrackerSequenceBatches,
    make_sequence_windows)
from object_tracking_tpu_torch.evaluation import evaluate_detection
from object_tracking_tpu_torch.inference import JointPredictor
from object_tracking_tpu_torch.models import (
    CfgDetector, Darknet19, MultiObjDetTracker, TinyTracker,
    VGG16PriorSource, YOLOv2Detector)
from object_tracking_tpu_torch.models.darknet19 import (
    BatchNorm, init_like_flax, plain_batch_norm)
from object_tracking_tpu_torch.models import darknet_cfg
from object_tracking_tpu_torch.models.darknet_cfg import (
    build_from_cfg, head_grids, head_specs)
from object_tracking_tpu_torch.models.faster_rcnn import (
    FasterRCNN, FasterRCNNDetector)
from object_tracking_tpu_torch.ops import matching
from object_tracking_tpu_torch.ops import nms as ops_nms
from object_tracking_tpu_torch.ops.boxes import (iou_center,
                                                pairwise_iou_center)
from object_tracking_tpu_torch.ops.cuda import _build
from object_tracking_tpu_torch.ops.cuda import assign as cuda_assign
from object_tracking_tpu_torch.ops.cuda import batch_norm as cuda_bn
from object_tracking_tpu_torch.ops.cuda import decode_nms as cuda_dn
from object_tracking_tpu_torch.ops.cuda import mish as cuda_mish
from object_tracking_tpu_torch.ops.cuda import nms as cuda_nms
from object_tracking_tpu_torch.ops.cuda import roi_pool as cuda_roi
from object_tracking_tpu_torch.ops.decode import decode_and_nms, decode_netout
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores
from object_tracking_tpu_torch.ops.targets import (
    encode_targets_batch, encode_targets_multiscale)
from object_tracking_tpu_torch.parallel import moe_capacity
from object_tracking_tpu_torch.serving import (
    ServedJointPredictor, export_joint, save_artifact)
from object_tracking_tpu_torch.training import (
    CheckpointManager, TrainState, fit, make_detector_train_step,
    make_joint_train_step_fused, make_multihead_detector_train_step,
    make_optimizer, make_tiny_eval_step, make_tiny_train_step)
from object_tracking_tpu_torch.utils.profiling import Recorder, recording

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
FIXTURES = Path(__file__).resolve().parent / 'tests' / 'fixtures'


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


def host_us(fn, iters: int) -> float:
    """Mean host time of fn() in µs: the calls are queued back to back
    and the host clock stops before the closing synchronisation, so this
    is what the host spends to launch them, not what the card spends."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return took / iters * 1e6


def device_times(fn, iters: int, model=None) -> dict:
    """Device time of fn() by kernel name under torch.profiler:
    {name: [launches per call, device ms per call]}, user annotations
    left out; empty when the profiler recorded no device activity (one
    retry). With `model`, the kernels that its BatchNorm layers launch,
    in forward and in backward, are keyed 'batch_norm: <name>', whatever
    the kernels' names (the plain path's do not say BatchNorm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        ranges = (batch_norm_ranges(model) if model is not None
                  else contextlib.nullcontext())
        with ranges, profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # a user annotation (the optimizer's 'Optimizer.step#Adam.step',
        # the BatchNorm ranges) spans kernels that are counted on their own
        kernels = {evt.key: [evt.count / iters,
                             evt.device_time_total / 1e3 / iters]
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and evt.device_time_total > 0
                   and not getattr(evt, 'is_user_annotation', False)}
        if kernels:
            if model is not None:
                for name, (n, ms) in batch_norm_kernels(
                        prof.events()).items():
                    if name in kernels:
                        rest = kernels[name]
                        rest[0] -= n / iters
                        rest[1] -= ms / iters
                        kernels['batch_norm: ' + name] = [n / iters,
                                                          ms / iters]
            return kernels
    return {}


BN_RANGE = 'BatchNorm'


@contextlib.contextmanager
def batch_norm_ranges(model):
    """Every BatchNorm forward of `model` inside a profiler range named
    BN_RANGE, by module hooks (the package itself records no range)."""
    from torch.profiler import record_function
    open_ranges = []

    def enter(module, args):
        open_ranges.append(record_function(BN_RANGE))
        open_ranges[-1].__enter__()

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)
    hooks = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            hooks += [m.register_forward_pre_hook(enter),
                      m.register_forward_hook(leave)]
    try:
        yield
    finally:
        for hook in hooks:
            hook.remove()


def batch_norm_kernels(events) -> dict:
    """{kernel name: [launches, device ms]} over the profiled calls, of
    the kernels launched by ops inside BN_RANGE ranges and by the
    backward nodes of those ops (matched by autograd sequence number)."""
    def chain(evt):
        while evt is not None:
            yield evt
            evt = evt.cpu_parent
    forward = {e.sequence_nr for e in events
               if e.sequence_nr >= 0 and any(a.name == BN_RANGE
                                             for a in chain(e))}
    owned: dict = {}
    for e in events:
        if not e.kernels or not any(
                a.name == BN_RANGE
                or (a.name.startswith('autograd::engine::evaluate_function')
                    and a.sequence_nr in forward) for a in chain(e)):
            continue
        for k in e.kernels:
            acc = owned.setdefault(k.name, [0, 0.0])
            acc[0] += 1
            acc[1] += k.duration / 1e3
    return owned


def op_device_ms(fn, fragment: str, iters: int) -> dict:
    """An op's device time per call under torch.profiler, summed over
    every kernel whose name holds `fragment` (each pass of the op), and
    split by pass: {'ms': total or None, 'passes': {pass: ms}}."""
    passes: dict = {}
    for name, (_, ms) in device_times(fn, iters).items():
        if fragment in name:
            found = re.search(fragment + r'\w*', name)
            key = found.group(0)
            passes[key] = passes.get(key, 0.0) + ms
    return {'ms': sum(passes.values()) if passes else None,
            'passes': passes}


# kernel-name fragments → category of the path's device time
# (first match wins: cuDNN's batch-norm kernels also say 'cudnn')
CATEGORIES = (
    ('nms_scores', ('nms_scores',)),
    ('batch_norm', ('batch_norm', 'batchnorm', 'bn_fw', 'welford')),
    ('convolution', ('conv', 'cudnn', 'gemm', 'xmma', 'cutlass', 'sm90_',
                     'winograd', 'fft', 'pointwise_mult_and_sum')),
    ('memcpy', ('memcpy', 'memset')),
)


# the same for a training step; cuDNN names its backward kernels dgrad
# (input gradient) and wgrad (filter gradient)
TRAIN_CATEGORIES = (
    ('batch_norm', ('batch_norm', 'batchnorm', 'bn_fw', 'bn_bw', 'welford')),
    ('conv_backward', ('dgrad', 'wgrad', 'bprop', 'backward_data',
                       'backward_filter', 'bwd')),
    ('conv_forward', CATEGORIES[2][1] + ('fprop',)),
    ('optimizer', ('multi_tensor_apply', 'adam')),
    ('memcpy', ('memcpy', 'memset')),
)


def breakdown(kernels: dict, wall_ms: float,
              categories=CATEGORIES) -> dict:
    """Device time of one call by category, its busy and idle share of
    the call's wall time, and the six costliest kernels."""
    if not kernels:
        return {'device_time': 'not measured (profiler saw no device '
                               'activity)'}
    cats: dict = {}
    for name, (n, ms) in kernels.items():
        low = name.lower()
        cat = next((c for c, keys in categories
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


def candidates(rng, frames: int, k: int, c: int, dead_frame: bool = True):
    """Seeded candidate sets as tests/test_pallas.py makes them: boxes in
    the middle of the image, live scores in half or more of the entries;
    frame 0 all dead unless dead_frame is False."""
    boxes = np.stack([rng.uniform(0.2, 0.8, (frames, k)),
                      rng.uniform(0.2, 0.8, (frames, k)),
                      rng.uniform(0.05, 0.4, (frames, k)),
                      rng.uniform(0.05, 0.4, (frames, k))],
                     -1).astype(np.float32)
    scores = rng.rand(frames, k, c).astype(np.float32)
    dead = rng.uniform(0.3, 0.9, (frames, 1, 1))
    scores[scores < dead] = 0.0
    if dead_frame:
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


# (frames, K, C) of the NMS kernel on the driven paths: joint predict_batch
# (B·T = 32) and predict_window (T = 4), detector forward_batch (top-16 of
# 8 images) and predict (top-128 of 1), the tracker batches' prior (top-16
# of a 16-frame precompute chunk, or of an augmented batch's B·T = 4·4)
NMS_PATH_SHAPES = ((32, 128, NUM_CLASSES), (4, 128, NUM_CLASSES), (8, 16, 80),
                   (1, 128, 80), (16, 16, 80))


# (frames, K, C, IoU threshold) of kernel 1 in Faster R-CNN's call
# (models/faster_rcnn.py at B=8): the proposal NMS over each image's top
# 6,000 (its rank as the score) and the per-class NMS over 8 x 20 (image,
# class) pseudo-frames of 300 RoIs
RCNN_NMS_SHAPES = ((8, 6000, 1, 0.7), (160, 300, 1, 0.3))


def check_nms(b, s, dead_frame: bool, thr: float = NMS_THRESHOLD):
    """Kernel 1 against its plain twin on the same card tensors: exact,
    something suppressed, and frame 0 all zero where it was made dead.
    Returns the kernel's output and the check's record."""
    frames, k, c = s.shape
    out = cuda_nms.nms_scores(b, s, thr)
    plain = cuda_nms.nms_scores_plain(b, s, thr)
    torch.cuda.synchronize()
    diff = (out - plain).abs().max().item()
    suppressed = int(((s > 0) & (out == 0)).sum())
    if diff != 0 or suppressed == 0 or (dead_frame and out[0].any()):
        raise AssertionError(f'nms_scores F={frames} K={k} C={c}: '
                             f'max_abs_diff={diff}, suppressed={suppressed}')
    return out, {'frames': frames, 'k': k, 'classes': c, 'threshold': thr,
                 'max_abs_diff': diff, 'live': int((s > 0).sum()),
                 'suppressed': suppressed}


def nms_times(b, s, out, thr: float, plain_iters: int = 10) -> dict:
    """Kernel 1 on (b, s): its device time by pass, call time, host cost,
    the plain twin's time and the bound."""
    frames, k, c = s.shape

    def call():
        return cuda_nms.nms_scores(b, s, thr)
    return {
        # the kernel's own device time, summed over its passes; the event
        # times span back-to-back wrapper calls and include the host's
        # launch gaps
        'device': op_device_ms(call, 'nms_scores', 50),
        'call_ms': cuda_ms(call, iters=200, warmup=10),
        # the wrapper's host cost: plan, allocations, two launches
        'host_us': host_us(call, 500),
        'plain_ms': cuda_ms(lambda: cuda_nms.nms_scores_plain(b, s, thr),
                            iters=plain_iters, warmup=min(3, plain_iters)),
        **nms_bound(out, k, c, frames)}


def kernel_phase(device) -> dict:
    """NMS kernel vs its plain twin on the card, exact, at every path
    shape and up to the 19x19x5 lattice; device time by pass, call time,
    twin time and bound at each path shape."""
    rng = np.random.RandomState(0)
    checks = []
    for frames, k in ((32, 128), (4, 845), (2, 1805)):
        boxes, scores = candidates(rng, frames, k, NUM_CLASSES)
        checks.append(check_nms(torch.from_numpy(boxes).to(device),
                                torch.from_numpy(scores).to(device),
                                dead_frame=True)[1])
    times = {}
    for frames, k, c in NMS_PATH_SHAPES:
        boxes, scores = candidates(rng, frames, k, c, dead_frame=False)
        b = torch.from_numpy(boxes).to(device)
        s = torch.from_numpy(scores).to(device)
        out, check = check_nms(b, s, dead_frame=False)
        checks.append(check)
        times[f'{frames}x{k}x{c}'] = nms_times(b, s, out, NMS_THRESHOLD)
    for frames, k, c, thr in RCNN_NMS_SHAPES:
        boxes, scores = candidates(rng, frames, k, c, dead_frame=False)
        if k > 1000:        # the proposal NMS: ranked, its rank the score
            rank = np.arange(k, 0, -1, dtype=np.float32)[None, :, None]
            scores = np.where(scores > 0, rank, np.float32(0.0))
        b = torch.from_numpy(boxes).to(device)
        s = torch.from_numpy(scores).to(device)
        out, check = check_nms(b, s, dead_frame=False, thr=thr)
        checks.append(check)
        times[f'{frames}x{k}x{c}'] = nms_times(b, s, out, thr, plain_iters=2)
    # the yardstick for host_us: one launch of a one-op torch kernel
    x = torch.zeros(16, device=device)
    return {'checks': checks, 'times': times,
            'torch_launch_us': host_us(lambda: x.add_(1.0), 2000)}


ASSIGN_SLOTS = 64      # JointPredictor's max_tracks
ASSIGN_DETS = 128      # decode_and_nms's top-K cap
ASSIGN_FRAMES = 40


def track_sequence(seed: int, b: int, frames: int, m: int, objects: int,
                   classes: int = NUM_CLASSES, blank=()):
    """B clips of `frames` frames with M detection rows (as
    tests/test_torch_assign_kernel.py::sequence): `objects` boxes moving at
    constant velocity with noise, dropping out at random and now and then
    flipping class, clutter in the other rows, rows shuffled per frame, no
    valid row in the frames of `blank`."""
    rng = np.random.RandomState(seed)
    start = rng.uniform(0.1, 0.9, (b, 1, objects, 2))
    vel = rng.uniform(-0.02, 0.02, (b, 1, objects, 2))
    size = rng.uniform(0.05, 0.2, (b, 1, objects, 2))
    cls = rng.randint(0, classes, (b, 1, objects))
    boxes = rng.uniform(0.05, 0.95, (b, frames, m, 4)) * [1, 1, .2, .2]
    labels = rng.randint(0, classes, (b, frames, m))
    valid = rng.rand(b, frames, m) > 0.5
    t = np.arange(frames)[None, :, None, None]
    boxes[:, :, :objects, :2] = (start + vel * t + rng.normal(
        0, 0.003, (b, frames, objects, 2)))
    boxes[:, :, :objects, 2:] = size
    flip = rng.rand(b, frames, objects) < 0.05
    labels[:, :, :objects] = np.where(flip, (cls + 1) % classes, cls)
    valid[:, :, :objects] = rng.rand(b, frames, objects) > 0.2
    valid[:, list(blank)] = False
    order = np.argsort(rng.rand(b, frames, m), axis=-1)
    return (np.take_along_axis(boxes, order[..., None], 2).astype(np.float32),
            np.take_along_axis(labels, order, 2).astype(np.int32),
            np.take_along_axis(valid, order, 2))


def clustered_sequence(seed: int, b: int, frames: int, m: int,
                       objects: int, classes: int):
    """B clips of `frames` frames whose M detection rows are all valid
    copies of `objects` boxes on a 1/256 grid, each coordinate nudged by
    one step or none (as tests/test_torch_assign_kernel.py::clustered):
    many IoUs tie, and a track overlaps every copy of its object, so the
    gated pairs are dense."""
    rng = np.random.RandomState(seed)
    grid = 1 / 256
    centre = rng.randint(64, 192, (b, 1, objects, 2)) * grid
    size = rng.randint(24, 48, (b, 1, objects, 2)) * grid
    drift = rng.randint(-2, 3, (b, 1, objects, 2)) * grid
    t = np.arange(frames)[None, :, None, None]
    k = rng.randint(0, objects, (b, frames, m))
    clip, frame = np.arange(b)[:, None, None], np.arange(frames)[None, :, None]
    at = (centre + drift * t)[clip, frame, k]
    wh = np.broadcast_to(size, (b, frames, objects, 2))[clip, frame, k]
    boxes = np.concatenate([at, wh], -1) + rng.randint(
        -1, 2, (b, frames, m, 4)) * grid
    return (boxes.astype(np.float32), (k % classes).astype(np.int32),
            np.ones((b, frames, m), bool))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def assign_bound(b: int, t: int, s: int, m: int) -> dict:
    """Least time for one window's assignment: bytes (the table read and
    written once, each detection read once, its id written once) over HBM
    rate, operations (the masked IoU of every (slot, detection) pair of
    every frame) over the float32 rate."""
    table = b * s * (4 * 4 + 2 * 4 + 3 * 4 + 1) + 4 * b
    nbytes = 2 * table + b * t * m * (4 * 4 + 4 + 1 + 4) + 4 * b
    ops = b * t * s * m * IOU_OPS_PER_PAIR
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'bytes': nbytes, 'operations': ops}


def gated_pairs(state, boxes, labels, valid, gate: float) -> int:
    """The most pairs at or above the gate in one clip's frame: the keys
    the kernel sorts there (no IoU in these frames is NaN)."""
    pred = torch.cat([state.boxes[..., :2] + state.vel,
                      state.boxes[..., 2:]], dim=-1)
    iou = pairwise_iou_center(pred, boxes)
    ok = (state.active[:, :, None] & valid[:, None, :]
          & (state.labels[:, :, None] == labels[:, None, :]))
    return int(((iou >= gate) & ok).flatten(1).sum(dim=1).max())


def assign_against_plain(device, s: int, t: int, seq, name: str) -> dict:
    """The kernel over windows of T frames against the plain twin frame by
    frame, both from an empty table: ids and every integer field equal,
    boxes and vel bit for bit after each window, one launch a window.
    Returns what the frames exercised and the largest |kernel - twin| of
    boxes and vel."""
    boxes, labels, valid = (torch.from_numpy(a).to(device) for a in seq)
    b, frames, m = boxes.shape[:3]
    kernel = matching.init_track_state(s, b, device)
    plain = matching.init_track_state(s, b, device)
    launched = matching.assign_tracks.launches
    full = minus_one = retired = gated = 0
    diff = 0.0
    for w0 in range(0, frames, t):
        w = slice(w0, w0 + t)
        before = kernel
        kernel, kids = matching.assign_tracks(kernel, boxes[:, w],
                                              labels[:, w], valid[:, w])
        pids = []
        for f in range(w0, min(w0 + t, frames)):
            gated = max(gated, gated_pairs(plain, boxes[:, f], labels[:, f],
                                           valid[:, f], TRACK_GATE_IOU))
            plain, ids, _ = matching.assign_tracks_plain(
                plain, boxes[:, f:f + 1], labels[:, f:f + 1],
                valid[:, f:f + 1])
            pids.append(ids)
        torch.cuda.synchronize()
        same = [torch.equal(kids, torch.cat(pids, dim=1))] + [
            same_bits(x, y) for x, y in zip(kernel, plain)]
        diff = max([diff] + [float((x - y).abs().max())
                             for x, y in zip(kernel[:2], plain[:2])])
        if not all(same):
            raise AssertionError(
                f'assign_tracks {name} window {w0 // t}: kernel and plain '
                f'differ in ' + ', '.join(
                    n for n, ok in zip(('det_ids',) +
                                       matching.TrackState._fields, same)
                    if not ok))
        full += int(kernel.active.all(dim=1).sum())
        minus_one += int(((kids == -1) & valid[:, w]).sum())
        retired += int((before.active & ((kernel.ids != before.ids)
                                         | ~kernel.active)).sum())
    launched = matching.assign_tracks.launches - launched
    if launched != -(-frames // t):
        raise AssertionError(f'assign_tracks {name}: {launched} launches '
                             f'in {frames} frames at T={t}')
    return {'name': name, 'b': b, 't': t, 'slots': s, 'dets': m,
            'frames': frames, 'windows': launched, 'launches': launched,
            'bitwise_equal': True, 'max_abs_diff': diff,
            'full_table_frames': full, 'unplaced_detections': minus_one,
            'retired': retired, 'max_gated_pairs': gated}


# (S, M, B, frames, clustered objects and classes, or None for
# track_sequence, keys in shared memory, bitonic sort): each of the
# kernel's sort branches, up to the caps
ASSIGN_BRANCHES = {
    'smem-bitonic': (64, 128, 2, 8, (2, 1), True, True),
    'scratch-rank': (64, 512, 2, 8, None, False, False),
    'scratch-bitonic': (64, 512, 2, 8, (4, 1), False, True),
    'caps-bitonic': (1024, 4096, 1, 3, (256, 16), False, True),
}


def assign_phase(device) -> dict:
    """The assignment kernel against its plain twin on a seeded 40-frame
    sequence at B=8 and B=1 (T=4, S=64, M=128, 90 objects: the table
    fills and the excess detections get -1; frames 17 to 20 have no valid
    row, so every track retires), then on frames that take each of its
    sort branches (keys in shared memory or the device scratch, rank sort
    or bitonic network; dense, tied frames up to S=1024, M=4096):
    ids and every integer field equal, boxes and vel bit for bit, one
    launch a window. At each B of the serving shape, the kernel's device
    time under torch.profiler, its call time by CUDA events, the wrapper's
    host cost per call, the plain twin's time and the bound."""
    t, s, m = T, ASSIGN_SLOTS, ASSIGN_DETS
    checks, branches, times = [], [], {}
    for name, (bs, bm, bb, frames, dense, in_smem,
               bitonic) in ASSIGN_BRANCHES.items():
        plan = cuda_assign.launch_plan(bs, bm)
        seq = (clustered_sequence(17, bb, frames, bm, *dense) if dense else
               track_sequence(17, bb, frames, bm, objects=90))
        check = assign_against_plain(device, bs, t, seq, name)
        check.update(threads=plan['threads'],
                     keys_in_smem=plan['keys_in_smem'],
                     bitonic=check['max_gated_pairs'] > 4 * plan['threads'])
        if (check['keys_in_smem'], check['bitonic']) != (in_smem, bitonic) \
                or not check['max_gated_pairs'] or \
                not check['unplaced_detections']:
            raise AssertionError(f'assign_tracks {name}: not the branch '
                                 f'meant: {check}')
        branches.append(check)
    for b in (8, 1):
        seq = track_sequence(11 + b, b, ASSIGN_FRAMES, m, objects=90,
                             blank=range(17, 21))
        check = assign_against_plain(device, s, t, seq, f'b{b}')
        if not (check['full_table_frames'] and check['unplaced_detections']
                and check['retired']):
            raise AssertionError(f'assign_tracks B={b}: {check}')
        checks.append(check)
        boxes, labels, valid = (torch.from_numpy(a).to(device) for a in seq)

        state = matching.init_track_state(s, b, device)
        w = slice(0, t)

        def call(state=state, w=w, boxes=boxes, labels=labels, valid=valid):
            return matching.assign_tracks(state, boxes[:, w], labels[:, w],
                                          valid[:, w])

        def plain_call(state=state, w=w, boxes=boxes, labels=labels,
                       valid=valid):
            return matching.assign_tracks_plain(state, boxes[:, w],
                                                labels[:, w], valid[:, w])
        times[f'b{b}'] = {
            'shape': {'B': b, 'T': t, 'S': s, 'M': m},
            'plan': dict(cuda_assign.launch_plan(s, m)),
            'device': op_device_ms(call, 'assign_tracks', 50),
            'call_ms': cuda_ms(call, iters=200, warmup=10),
            'host_us': host_us(call, 500),
            'plain_ms': cuda_ms(plain_call, iters=5, warmup=1),
            **assign_bound(b, t, s, m)}
    return {'phase': 'assign', 'checks': checks, 'branches': branches,
            'times': times}


# ------------------------------------------------------------------- Mish
YOLOV4_CFG = Path(__file__).resolve().parent / 'portbench' / 'configs' / \
    'yolov4_coco_608.cfg'
MISH_BATCH = 8


def same_bits_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs in the same places (their payloads aside)."""
    nan = torch.isnan(b)
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (torch.equal(torch.isnan(a), nan) and torch.equal(
        a.view(as_int)[~nan], b.view(as_int)[~nan]))


def mish_specials(dtype, device) -> torch.Tensor:
    """±0, ±inf, NaN, 20 and its neighbours, where exp overflows (±88–90),
    subnormals, then seeded normals at scales 1, 6 and 40."""
    twenty = torch.tensor(20.0)
    values = torch.tensor(
        [0.0, -0.0, float('inf'), -float('inf'), float('nan'), 20.0,
         float(torch.nextafter(twenty, torch.tensor(0.0))),
         float(torch.nextafter(twenty, torch.tensor(99.0))), -20.0, 88.0,
         88.72, 88.73, 89.0, 90.0, -88.0, -89.0, -90.0, -104.0, 1e-40,
         -1e-40, 1.4e-45, -1.4e-45, 1.1754944e-38, 1e-30, -1e-30])
    rng = np.random.RandomState(31)
    normals = torch.from_numpy(
        (rng.randn(3, 100003) * np.array([[1.0], [6.0], [40.0]])).ravel())
    return torch.cat([values, normals.float()]).to(dtype).to(device)


def mish_in_forward(device) -> dict:
    """YOLOv4 at B=8, 608²: every Mish call of a forward checked against
    the eager chain on its own input; launches and counters."""
    model, hwc = build_from_cfg(YOLOV4_CFG.read_text())
    model = model.to(device).eval()
    g = torch.Generator(device='cpu').manual_seed(608)
    images = torch.rand((MISH_BATCH, *hwc), generator=g).to(device)
    calibrate_bn(model, images)
    seen = []
    activate = darknet_cfg._activate

    def checked(x, kind):
        out = activate(x, kind)
        if kind == 'mish':
            seen.append((tuple(x.shape),
                         same_bits_nan(out, cuda_mish.mish_plain(x)),
                         int(torch.isnan(out).sum())))
        return out
    before = cuda_mish.mish.launches
    darknet_cfg._activate = checked
    try:
        with torch.no_grad():
            model(images)
    finally:
        darknet_cfg._activate = activate
    launches = cuda_mish.mish.launches - before
    recorder = Recorder()
    with torch.no_grad(), recording(recorder):
        model(images)
    counters = recorder.reading()['counters']
    torch.cuda.synchronize()
    if len(seen) != 72 or launches != 72 or not all(ok for _, ok, _ in seen):
        raise AssertionError(f'mish in YOLOv4: {len(seen)} calls, '
                             f'{launches} launches, differing at '
                             f'{[s for s, ok, _ in seen if not ok]}')
    share = counters['mish.kernel_elements'] / counters['mish.elements']
    if share != 1.0:
        raise AssertionError(f'mish counters: {counters}')
    shapes: dict = {}
    for shape, _, _ in seen:
        shapes[shape] = shapes.get(shape, 0) + 1
    del model, images
    return {'calls': len(seen), 'launches_per_forward': launches,
            'bitwise_equal': True, 'nan_outputs': sum(n for *_, n in seen),
            'counters': counters, 'engaged_share': share,
            'shapes': shapes}


def device_ms(fn, iters: int) -> float:
    """Device ms of one fn() call, summed over every kernel it launches
    (torch.profiler)."""
    return sum(ms for _, ms in device_times(fn, iters).values())


def mish_phase(device) -> dict:
    """The Mish kernel against the eager chain inside YOLOv4's forward and
    on special values; its times at YOLOv4's Mish shapes (module
    docstring, phase 2)."""
    forward = mish_in_forward(device)
    gc.collect()
    torch.cuda.empty_cache()
    specials = []
    for dtype in (torch.float32, torch.bfloat16):
        x = mish_specials(dtype, device)
        for cut, part in (('whole', x), ('tail', x[:-3]),
                          ('misaligned', x[1:])):
            ok = same_bits_nan(cuda_mish.mish(part),
                               cuda_mish.mish_plain(part))
            specials.append({'dtype': str(dtype), 'cut': cut,
                             'numel': part.numel(), 'bitwise_equal': ok})
            if not ok:
                raise AssertionError(f'mish {dtype} {cut}: differs from '
                                     f'the eager chain')
    times, total = {}, {'kernel_ms': 0.0, 'plain_ms': 0.0,
                        'library_ms': 0.0, 'bound_ms': 0.0}
    g = torch.Generator(device=device).manual_seed(72)
    for shape, layers in forward['shapes'].items():
        x = torch.randn(shape, device=device, generator=g) * 3
        n = x.numel()
        row = {'layers': layers, 'elements': n,
               'kernel_ms': device_ms(lambda: cuda_mish.mish(x), 20),
               'plain_ms': device_ms(lambda: cuda_mish.mish_plain(x),
                                     20),
               'library_ms': device_ms(
                   lambda: torch.nn.functional.mish(x), 20),
               'bound_ms': n * 8 / HBM_BYTES_PER_S * 1e3,
               'call_ms': cuda_ms(lambda: cuda_mish.mish(x), 20),
               'host_us': host_us(lambda: cuda_mish.mish(x), 50)}
        row['roofline'] = row['bound_ms'] / row['kernel_ms']
        times['x'.join(map(str, shape))] = row
        for key in total:
            total[key] += layers * row[key]
        del x
    total['roofline'] = total['bound_ms'] / total['kernel_ms']
    forward['shapes'] = {'x'.join(map(str, s)): k
                         for s, k in forward['shapes'].items()}
    return {'phase': 'mish', 'forward': forward, 'specials': specials,
            'times': times, 'per_forward': total}


BN_BATCH = 32          # the detector step's batch (DetectorConfig)
BN_EPS = 1e-3


def bn_engagement(model, run):
    """run() with the BatchNorm kernels' launch count set to 0 and a
    recorder attached: (what run() returns, {'launches': launcher calls,
    'calls': `model`'s batch-statistics BatchNorm calls, 'engaged_share':
    `bn.kernel_elements` / `bn.elements`}); raises unless some call ran
    and the kernels took every element."""
    calls = [0]

    def note(module, args):
        calls[0] += bool(args[1])
    hooks = [m.register_forward_pre_hook(note) for m in model.modules()
             if isinstance(m, BatchNorm)]
    cuda_bn.batch_norm.launches = 0
    recorder = Recorder()
    try:
        with recording(recorder):
            out = run()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    counters = recorder.reading()['counters']
    reading = {'launches': cuda_bn.batch_norm.launches, 'calls': calls[0],
               'engaged_share': counters.get('bn.kernel_elements', 0)
               / max(counters.get('bn.elements', 0), 1)}
    if not calls[0] or reading['engaged_share'] != 1.0:
        raise AssertionError(f'batch_norm: {reading}, {counters}')
    return out, reading


def batch_norm_in_step(device) -> dict:
    """Full-width Darknet-19 at B=32, 416², one batch-statistics forward
    and backward: each BatchNorm input's shape and layout, the kernels'
    launches and the counters' engaged share."""
    model = Darknet19().to(device).train()
    seen = []

    def note(module, args):
        x = args[0]
        seen.append((tuple(x.shape), {cuda_bn.PLANES: 'planes',
                                      cuda_bn.ROWS: 'rows'}.get(
                                          cuda_bn.layout_of(x), 'strided')))
    hooks = [m.register_forward_pre_hook(note) for m in model.modules()
             if isinstance(m, BatchNorm)]
    g = torch.Generator(device='cpu').manual_seed(32)
    images = torch.rand((BN_BATCH, NET, NET, 3), generator=g).to(device)
    try:
        _, reading = bn_engagement(model, lambda: model(
            images, train=True)['netout'].square().mean().backward())
    finally:
        for h in hooks:
            h.remove()
    if len(seen) != 22 or reading['launches'] != 44:
        raise AssertionError(f'batch_norm in Darknet-19: {len(seen)} '
                             f'calls, {reading}')
    del model, images
    return {'launches_per_step': reading['launches'], **reading,
            'inputs': seen}


def bn_agreement(x, dy, w, b) -> dict:
    """The kernels', the plain path's and F.batch_norm's (y, dx, dweight,
    dbias) on x under dy, each as its relative L2 distance from the plain
    expression in float64 on the same inputs, and the kernels' largest
    absolute difference from it; raises where the kernels lie further than
    max(2 × the plain path's distance, 1e-6), as the card tests hold."""
    def run(fn, *args):
        args = [t.detach().clone().requires_grad_() for t in args]
        y = fn(*args)
        return (y.detach(), *torch.autograd.grad(y, args, dy.to(y.dtype)))
    want = run(lambda *a: plain_batch_norm(*a, BN_EPS)[0],
               x.double(), w.double(), b.double())
    got = {'kernels': run(lambda *a: cuda_bn.batch_norm(*a, BN_EPS)[0],
                          x, w, b),
           'plain': run(lambda *a: plain_batch_norm(*a, BN_EPS)[0],
                        x, w, b),
           'library': run(lambda t, u, v: torch.nn.functional.batch_norm(
               t, None, None, u, v, training=True, eps=BN_EPS), x, w, b)}
    names = ('y', 'dx', 'dweight', 'dbias')
    rel = {path: {n: float((a.double() - r).norm() / r.norm())
                  for n, a, r in zip(names, out, want)}
           for path, out in got.items()}
    diff = max(float((a.double() - r).abs().max())
               for a, r in zip(got['kernels'], want))
    far = [n for n in names
           if rel['kernels'][n] > max(2 * rel['plain'][n], 1e-6)]
    if far:
        raise AssertionError(f'batch_norm at {tuple(x.shape)}: {far} '
                             f'further from float64 than the plain path, '
                             f'{rel}')
    return {'rel_l2': rel, 'max_abs_diff': diff}


def batch_norm_phase(device) -> dict:
    """The BatchNorm kernels in a Darknet-19 B=32 step (layouts,
    launches, counters), then at each of its 22 BatchNorm inputs, in the
    layout the step gives it: the kernels' y, dx, dweight and dbias held
    to a float64 reference beside the plain path's and F.batch_norm's;
    device ms of the kernels' forward and backward beside the plain
    path's and F.batch_norm's (a yardstick the port never calls: the same
    biased batch variance, each with autograd's backward) and the bound
    (32 B an element at 3.35 TB/s, x and dy read twice from HBM); and of
    the kernels' forward alone (serving's call) beside its bound (12 B)
    and its host cost a call."""
    step = batch_norm_in_step(device)
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(22)
    rows, total = [], {'kernel_ms': 0.0, 'plain_ms': 0.0,
                       'library_ms': 0.0, 'bound_ms': 0.0,
                       'forward_ms': 0.0, 'forward_bound_ms': 0.0}
    for shape, layout in step['inputs']:
        fmt = (torch.channels_last if layout == 'rows'
               else torch.contiguous_format)
        c = shape[1]
        # per-channel offsets up to 3 and scales 0.1-2.1, as after a conv
        x = (torch.randn(shape, device=device, generator=g)
             * (torch.rand(c, 1, 1, device=device, generator=g) * 2 + 0.1)
             + torch.randn(c, 1, 1, device=device, generator=g)
             ).contiguous(memory_format=fmt)
        dy = torch.randn(shape, device=device, generator=g
                         ).contiguous(memory_format=fmt)
        w = torch.rand(c, device=device, generator=g) + 0.5
        b = torch.randn(c, device=device, generator=g) * 0.1
        agreement = bn_agreement(x, dy, w, b)
        gc.collect()
        torch.cuda.empty_cache()
        x.requires_grad_()
        w.requires_grad_()
        b.requires_grad_()

        def kernels():
            y = cuda_bn.batch_norm(x, w, b, BN_EPS)[0]
            torch.autograd.grad(y, (x, w, b), dy)

        def plain():
            y = plain_batch_norm(x, w, b, BN_EPS)[0]
            torch.autograd.grad(y, (x, w, b), dy)

        def library():
            y = torch.nn.functional.batch_norm(x, None, None, w, b,
                                               training=True, eps=BN_EPS)
            torch.autograd.grad(y, (x, w, b), dy)

        def forward():
            with torch.no_grad():
                cuda_bn.batch_norm(x, w, b, BN_EPS)
        n = x.numel()
        row = {'shape': 'x'.join(map(str, shape)), 'layout': layout,
               **agreement,
               'kernel_ms': device_ms(kernels, 10),
               'plain_ms': device_ms(plain, 10),
               'library_ms': device_ms(library, 10),
               'bound_ms': n * 32 / HBM_BYTES_PER_S * 1e3,
               'forward_ms': device_ms(forward, 10),
               'forward_bound_ms': n * 12 / HBM_BYTES_PER_S * 1e3,
               'host_us': host_us(forward, 50)}
        row['roofline'] = row['bound_ms'] / row['kernel_ms']
        rows.append(row)
        for key in total:
            total[key] += row[key]
        del x, dy
    total['roofline'] = total['bound_ms'] / total['kernel_ms']
    total['forward_roofline'] = (total['forward_bound_ms']
                                 / total['forward_ms'])
    total['max_abs_diff'] = max(r['max_abs_diff'] for r in rows)
    step['inputs'] = [f'{"x".join(map(str, s))} {lay}'
                      for s, lay in step['inputs']]
    return {'phase': 'batch_norm', 'step': step, 'times': rows,
            'per_step': total}


RCNN_BATCH = 8
RCNN_HW = (562, 1000)   # py-faster-rcnn's test scale of a 1920x1080 frame
RCNN_STD = {'rpn_conv': 0.01, 'rpn_cls_score': 0.01, 'rpn_bbox_pred': 0.01,
            'cls_score': 0.01, 'bbox_pred': 0.001}


def rcnn_module(device, seed: int) -> FasterRCNN:
    """Full-width Faster R-CNN VGG16 with the benchmark cell's draw: each
    weight a normal of std RCNN_STD[layer], else sqrt(1 / fan_in) (the
    trunk, fc6, fc7); biases 0."""
    module = FasterRCNN().to(device).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, layer in module.named_children():
            w = layer.weight
            std = RCNN_STD.get(name, (1.0 / w[0].numel()) ** 0.5)
            w.copy_(torch.randn(w.shape, generator=g, device=device) * std)
            layer.bias.zero_()
    return module


def rcnn_frames(seed: int) -> np.ndarray:
    """RCNN_BATCH frames (B, 562, 1000, 3) in [0, 1]: dark noise with 8
    filled rectangles each, as the benchmark cell's scenes."""
    rng = np.random.RandomState(seed)
    h, w = RCNN_HW
    frames = rng.randint(0, 60, (RCNN_BATCH, h, w, 3)).astype(np.uint8)
    for image in frames:
        for _ in range(8):
            bw, bh = rng.randint(w // 16, w // 3), rng.randint(h // 16, h // 3)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            image[y:y + bh, x:x + bw] = rng.randint(80, 256, 3)
    return frames.astype(np.float32) / np.float32(255.0)


def rcnn_call(det, frames) -> dict:
    """One detect_images call with a recorder attached: the inputs of
    each kernel-1 launch and of the RoI pooling, the launches of each
    kernel counted from this call, and the counters."""
    module = det.module
    seen = {'nms': [], 'pool': []}
    nms, pool = ops_nms.nms_scores, module.pool

    def nms_kept(boxes, scores, thr):
        seen['nms'].append((boxes, scores, thr))
        return nms(boxes, scores, thr)

    def pool_kept(conv5, rois):
        seen['pool'].append((conv5, rois))
        return pool(conv5, rois)
    launches = (cuda_nms.nms_scores.launches, cuda_roi.roi_pool.launches)
    recorder = Recorder()
    ops_nms.nms_scores, module.pool = nms_kept, pool_kept
    try:
        with recording(recorder):
            dets = det.detect_images(frames)
        torch.cuda.synchronize()
    finally:
        ops_nms.nms_scores = nms
        del module.pool
    return {'seen': seen, 'dets': dets,
            'counters': recorder.reading()['counters'],
            'nms_launches': cuda_nms.nms_scores.launches - launches[0],
            'roi_pool_launches': cuda_roi.roi_pool.launches - launches[1]}


def rcnn_phase(device) -> dict:
    """Faster R-CNN VGG16 at B=8, 562x1000: its call's launches and
    counters, and kernel 1 and the RoI-pooling kernel on that call's own
    inputs against their twins, with their times (module docstring,
    phase 2)."""
    det = FasterRCNNDetector(device=device, module=rcnn_module(device, 22))
    frames = rcnn_frames(22)
    det.detect_images(frames)       # cuDNN's choices, the kernels' builds
    call = rcnn_call(det, frames)
    counters = call['counters']
    share = (counters.get('roi_pool.kernel_rois', 0)
             / max(counters.get('roi_pool.rois', 0), 1))
    if (call['nms_launches'] != 2 or call['roi_pool_launches'] != 1
            or len(call['seen']['pool']) != 1 or share != 1.0):
        raise AssertionError(f'rcnn call: {call["nms_launches"]} kernel-1 '
                             f'and {call["roi_pool_launches"]} RoI-pooling '
                             f'launches, counters {counters}')
    nms_rows = {}
    for (b, s, thr), name in zip(call['seen']['nms'],
                                 ('proposal_nms', 'class_nms')):
        out, check = check_nms(b, s, dead_frame=False, thr=thr)
        nms_rows[name] = {**check, **nms_times(b, s, out, thr,
                                                plain_iters=2)}
    conv5, rois = call['seen']['pool'][0]
    got = cuda_roi.roi_pool(conv5, rois, 1 / 16)
    want = cuda_roi.roi_pool_plain(conv5, rois, 1 / 16)
    if not same_bits_nan(got, want):
        raise AssertionError('roi_pool: the kernel differs from its twin on '
                             'the call\'s conv5_3 and RoIs')
    n_rois, c = rois.shape[0] * rois.shape[1], conv5.shape[1]
    bins = got.shape[-2] * got.shape[-1]
    # the RoIs' mean size in map cells, which sets the window each reads
    edges = cuda_roi.c_round(rois / 16)
    size = (edges[..., 2:] - edges[..., :2] + 1).clamp_min(1)

    def pooled():
        return cuda_roi.roi_pool(conv5, rois, 1 / 16)
    roi = {'rois': n_rois, 'map': 'x'.join(map(str, conv5.shape)),
           'cells_wh_mean': size.reshape(-1, 2).mean(0).tolist(),
           'bitwise_equal': True,
           'kernel_ms': op_device_ms(pooled, 'roi_pool', 20)['ms'],
           'call_ms': cuda_ms(pooled, 20),
           'host_us': host_us(pooled, 50),
           'plain_ms': cuda_ms(lambda: cuda_roi.roi_pool_plain(
               conv5, rois, 1 / 16), iters=2, warmup=1),
           'bound_ms': (n_rois * c * bins + conv5.numel()) * 4
           / HBM_BYTES_PER_S * 1e3}
    roi['roofline'] = roi['bound_ms'] / roi['kernel_ms']
    detections = sum(len(d) for d in call['dets'])
    del det, call, conv5, rois, got, want, edges, size
    return {'phase': 'rcnn', 'batch': RCNN_BATCH, 'image_hw': RCNN_HW,
            'nms_launches': 2, 'roi_pool_launches': 1,
            'counters': counters, 'engaged_share': share,
            'detections': detections, 'roi_pool': roi, 'nms': nms_rows}


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
    return live_threshold(out['track'], anchors)


def live_threshold(netout, anchors, live: int = 64) -> float:
    """The `live`-th best candidate score of the worst frame of a
    ([B,] [T,] GH, GW, A, 5+C) netout, nudged down: a threshold that
    leaves at least `live` candidates in every frame."""
    _, scores = decode_netout(netout, anchors, 0.0)
    best = scores.amax(-1).reshape(-1, scores.shape[-2])     # (frames, N)
    kth = best.sort(dim=-1, descending=True).values[
        :, min(live - 1, best.shape[1] - 1)]
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


def fps(pred, clips, iters: int, batch_call: bool, samples: int = 3
        ) -> list:
    """Frames/s samples of the public call, host clock; every call ends
    with its results on the host, so it is synchronised."""
    call = pred.predict_batch if batch_call else (
        lambda c: pred.predict_window(c[0]))
    return rate(lambda: call(clips), clips.shape[0] * clips.shape[1], iters,
                samples)


# The serve and parallel phases' frames/s readings take two samples, not
# three, to keep the script near 600 s of command time since the
# native_data and tensor_parallel phases joined it; the path phase's
# keep three
SHORT_SAMPLES = 2


def rate(call, items: int, iters: int, samples: int = 3) -> list:
    """Items/s of call() in `samples` back-to-back samples of `iters`
    calls each, host clock after 2 warm-up calls, synchronised at both
    ends of each sample. Host-bound calls spread widely from one sample
    to the next, so every sample is kept."""
    for _ in range(2):
        call()
    out = []
    for _ in range(samples):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
        out.append(iters * items / (time.perf_counter() - start))
    return out


def put_rate(rates: dict, key: str, samples: list) -> float:
    """rates[key] = the samples' median, rates[key + '_samples'] = them."""
    rates[key] = float(np.median(samples))
    rates[key + '_samples'] = samples
    return rates[key]


def path_phase(device, smi: str) -> dict:
    torch.manual_seed(0)
    model = MultiObjDetTracker(num_classes=NUM_CLASSES, num_anchors=5,
                               convlstm_features=512, width_div=1)
    model = model.to(device).eval()       # serving: no statistic written
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
    matching.assign_tracks.launches = 0
    (results, calls), bn = bn_engagement(
        model, lambda: serve(kernel_pred, batch_reqs, window_reqs))
    launches = cuda_nms.nms_scores.launches
    assigned = matching.assign_tracks.launches
    if launches != calls or assigned != calls:
        raise AssertionError(f'nms_scores launched {launches} times and '
                             f'assign_tracks {assigned} times in {calls} '
                             f'predict calls')
    if bn['launches'] != bn['calls']:       # no gradient: one a BatchNorm
        raise AssertionError(f'batch_norm in {calls} predict calls: {bn}')
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
            median = put_rate(rates, f'fps_{key}',
                              fps(pred, clips, 5 if batch > 1 else 10,
                                  batch > 1))
            call = (lambda c=clips, p=pred: p.predict_batch(c)) \
                if batch > 1 else \
                (lambda c=clips, p=pred: p.predict_window(c[0]))
            profiles[key] = breakdown(device_times(call, 2, m),
                                      1e3 * batch * T / median)
    return {'phase': 'path', 'net': NET, 'T': T, 'classes': NUM_CLASSES,
            'anchors': 5, 'convlstm_features': 512, 'width_div': 1,
            'obj_threshold': obj_threshold, 'nms_probe': probe,
            'predict_calls': calls, 'nms_launches': launches,
            'assign_launches': assigned, 'bn_launches': bn,
            'kernel_equals_sort': True,
            **summary, **rates, 'card': smi}, profiles


# ------------------------------------------------------------- detector path
def calibrate_bn(model, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to the statistics of its
    input on `images` (one forward), so that random weights give
    unit-scale activations through the 22 layers instead of vanishing:
    the netout then has spread across cells, as a trained detector's has."""
    def take(norm, args):
        x = args[0].float()
        norm.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        norm.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take) for m in model.modules()
             if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(images, train=False)
    for hook in hooks:
        hook.remove()


def same_decode(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def detector_phase(device, smi: str):
    """The full-width YOLOv2Detector: launches, kernel == sort, rates."""
    cfg = DetectorConfig()
    det = YOLOv2Detector(cfg, seed=0, device=device)
    images = np.random.RandomState(2).rand(
        8, cfg.image_h, cfg.image_w, 3).astype(np.float32)
    calibrate_bn(det.model, torch.from_numpy(images).to(device))
    netout = det.forward(images)['netout']               # (8, 13, 13, 5, 85)
    cfg.obj_threshold = live_threshold(netout, det.anchors)

    cuda_nms.nms_scores.launches = 0
    _, boxes, labels, scores, valid = det.forward_batch(images)
    single = det.detect_images(images[:1])
    torch.cuda.synchronize()
    launches = cuda_nms.nms_scores.launches
    if launches != 2:
        raise AssertionError(f'nms_scores launched {launches} times in 2 '
                             'detector calls')
    if not bool(valid.any(dim=1).all()) or not single[0]:
        raise AssertionError('an image has no detection')
    kept = scores[valid]
    if not (bool(torch.isfinite(boxes[valid]).all())
            and bool((kept > cfg.obj_threshold).all())
            and bool((kept <= 1.0).all())):
        raise AssertionError('a detection is not finite or out of range')
    args = (det.anchors, cfg.obj_threshold, cfg.nms_threshold)
    for top_k, net in ((16, netout), (128, netout[:1])):
        if not same_decode(decode_and_nms(net, *args, top_k, 'kernel'),
                           decode_and_nms(net, *args, top_k, 'sort')):
            raise AssertionError(f"top_k={top_k}: nms_impl='kernel' and "
                                 "'sort' disagree")

    rates, profiles = {}, {}
    bf16 = YOLOv2Detector(cfg, dtype=torch.bfloat16, device=device)
    bf16.model.load_state_dict(det.model.state_dict())
    for name, d in (('float32', det), ('bfloat16', bf16)):
        for n, call in ((8, lambda d=d: d.forward_batch(images)),
                        (1, lambda d=d: d.detect_images(images[:1]))):
            key = f'n{n}_{name}'
            median = put_rate(rates, f'images_per_s_{key}',
                              rate(call, n, 10))
            profiles[key] = breakdown(device_times(call, 2, d.model),
                                      1e3 * n / median)
    return {'phase': 'detector', 'net': cfg.image_h,
            'classes': cfg.num_classes, 'anchors': cfg.num_anchors,
            'width_div': cfg.width_div, 'obj_threshold': cfg.obj_threshold,
            'detections_n8': int(valid.sum()),
            'detections_n1': len(single[0]),
            'nms_launches': launches, 'kernel_equals_sort': True, **rates,
            'profile': profiles, 'card': smi}, netout, cfg.obj_threshold


def iou(a, b) -> float:
    return float(iou_center(torch.tensor(a), torch.tensor(b)))


def check_golden(name: str, dets, golden, net: int, min_score: float):
    """tests/test_golden_*.py's criteria on every scene, and the scenes'
    mAP@0.5 by evaluate_detection."""
    labels = list(golden['labels'])
    gt_frames, pred_frames = [], []
    for found, scene in zip(dets, golden['images']):
        gold = scene['detections']
        if len(found) != len(gold):
            raise AssertionError(f'{name} {scene["file"]}: {found} != {gold}')
        for (label, score, box), g in zip(found, gold):
            if not (label == g['label'] and abs(score - g['score']) < 0.05
                    and iou(box, g['box_cxcywh']) >= 0.8):
                raise AssertionError(f'{name} {scene["file"]}: {found} '
                                     f'!= {gold}')
        x0, y0, x1, y1 = scene['gt_box_xyxy']
        gt = ((x0 + x1) / 2 / net, (y0 + y1) / 2 / net,
              (x1 - x0) / net, (y1 - y0) / net)
        label, score, box = found[0]
        if not (label == scene['gt_label'] and score >= min_score
                and iou(box, gt) > 0.5):
            raise AssertionError(f'{name} {scene["file"]}: top detection '
                                 f'{found[0]} misses the ground truth')
        gt_frames.append({'boxes': np.asarray([[x0, y0, x1, y1]],
                                              np.float32),
                          'labels': np.asarray([labels.index(
                              scene['gt_label'])])})
        pred_frames.append({
            'boxes': np.asarray([[(cx - w / 2) * net, (cy - h / 2) * net,
                                  (cx + w / 2) * net, (cy + h / 2) * net]
                                 for _, _, (cx, cy, w, h) in found],
                                np.float32).reshape(-1, 4),
            'scores': np.asarray([s for _, s, _ in found], np.float32),
            'labels': np.asarray([labels.index(l) for l, _, _ in found])})
    return {'scenes': len(dets), 'detections': sum(map(len, dets)),
            'map50': evaluate_detection(gt_frames, pred_frames)['map']}


def golden_phase(device, smi: str) -> dict:
    """The repo's trained fixtures on the card: CfgDetector and
    VGG16PriorSource reproduce their golden detections."""
    scenes = np.load(FIXTURES / 'golden_scenes_160.npz')
    images = scenes['images'].astype(np.float32) / 255.0
    golden = json.loads((FIXTURES / 'golden_boxes.json').read_text())
    vgolden = json.loads((FIXTURES / 'golden_vgg16.json').read_text())
    files = [str(f) for f in scenes['files']]
    for g in (golden, vgolden):
        if [s['file'] for s in g['images']] != files:
            raise AssertionError('golden scenes out of order')
    cfg_det = CfgDetector(str(FIXTURES / golden['cfg']),
                          weights_path=str(FIXTURES / golden['weights']),
                          labels=tuple(golden['labels']), device=device)
    vgg = VGG16PriorSource(
        image_h=vgolden['net'], image_w=vgolden['net'],
        det_labels=tuple(vgolden['labels']),
        fc_features=vgolden['fc_features'], width_div=vgolden['width_div'],
        weights_path=str(FIXTURES / vgolden['weights']), device=device)
    cuda_nms.nms_scores.launches = 0
    cfg_dets = cfg_det.detect_images(images)
    vgg_dets = vgg.detect_images(images)
    launches = cuda_nms.nms_scores.launches
    if launches != 2:
        raise AssertionError(f'nms_scores launched {launches} times in 2 '
                             'golden calls')
    return {'phase': 'golden',
            'cfg_detector': check_golden('CfgDetector', cfg_dets, golden,
                                         160, 0.0),
            'vgg16': check_golden('VGG16PriorSource', vgg_dets, vgolden,
                                  vgolden['net'], 0.8),
            'nms_launches': launches, 'card': smi}


# ------------------------------------------------------- decode+NMS kernel
def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the finite entries; the non-finite entries of
    a and b must be the same values (inf, -inf or NaN) at the same places."""
    fin = torch.isfinite(a)
    if not (torch.equal(fin, torch.isfinite(b))
            and torch.equal(a[~fin].nan_to_num(0.0), b[~fin].nan_to_num(0.0))
            and torch.equal(a[~fin].isnan(), b[~fin].isnan())):
        raise AssertionError('non-finite entries differ')
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def decode_cases(netout: torch.Tensor, obj: float, device):
    rng = np.random.RandomState(3)
    head25 = rng.randn(1, 13, 13, 5, 25).astype(np.float32)
    head25[..., 4] += 3.0
    head25[..., 5] += 3.0
    head25[0, 6, 6, 2, 2] = 100.0              # exp overflows: w = inf
    head25[0, 6, 6, 2, 4:6] = (5.0, 8.0)       # and the box lives
    head9 = rng.randn(1, 4, 4, 3, 9).astype(np.float32)
    head9[..., 4] += 1.5
    dead = rng.randn(1, 13, 13, 5, 25).astype(np.float32)
    dead[..., 4] = -30.0                        # conf ~ 0: nothing lives
    head85 = rng.randn(1, 19, 19, 5, 85).astype(np.float32)
    head85[..., 4] += 4.0                       # 608² input: N = 1805
    head85[..., 5] += 6.0                       # class 0 lives widely
    head85[..., 2:4] += 1.0                     # wider boxes: overlaps
    yolo = torch.tensor(YOLOV2_ANCHORS, device=device)
    small = torch.tensor([0.8, 0.8, 1.5, 1.5, 2.5, 2.0], device=device)
    # (name, netout, anchors, obj_threshold, must suppress something)
    return [('detector', netout, yolo, obj, True),
            ('head_13x13x5x25', torch.from_numpy(head25).to(device), yolo,
             0.5, True),
            ('head_4x4x3x9', torch.from_numpy(head9).to(device), small, 0.5,
             False),
            ('all_dead_13x13x5x25', torch.from_numpy(dead).to(device), yolo,
             0.5, False),
            ('head_19x19x5x85', torch.from_numpy(head85).to(device), yolo,
             0.5, True)]


def staged(netout, anchors, obj: float):
    """decode_netout → greedy_nms_scores(top_k=0) on the NMS kernel."""
    boxes, scores = decode_netout(netout, anchors, obj)
    n, c = scores.shape[-2:]
    return greedy_nms_scores(boxes.reshape(-1, n, 4).contiguous(),
                             scores.reshape(-1, n, c).contiguous(),
                             NMS_THRESHOLD, top_k=0, impl='kernel')


def math_probe(device) -> dict:
    """The kernel's sigmoid and exp against torch's on the card: with a
    1x1 grid, unit anchors and A = 1024, box x is sigmoid(tx) and box w is
    exp(tw), exactly."""
    t = torch.linspace(-30.0, 30.0, 1024, device=device)
    net = torch.zeros(1, 1, 1024, 6, device=device)
    net[..., 0] = t
    net[..., 2] = t
    boxes, _ = cuda_dn.decode_nms_fused(net, torch.ones(2048, device=device))
    ulps = {}
    for name, got, want in (('sigmoid', boxes[:, 0], torch.sigmoid(t)),
                            ('exp', boxes[:, 2], torch.exp(t))):
        gap = (got.view(torch.int32) - want.view(torch.int32)).abs()
        ulps[name] = {'values': int(t.numel()),
                      'differ': int((gap > 0).sum()),
                      'max_ulp': int(gap.max())}
    return ulps


def decode_nms_bound(scores: torch.Tensor, n: int, c: int,
                     frames: int) -> dict:
    """Least time for the fused decode+NMS of these inputs: bytes (netout
    read once, boxes and scores written once) over HBM rate; operations
    (the N² IoU and compare, ~5 per class score for the decode, one walk
    round over N per kept box) over the float32 rate."""
    nbytes = frames * n * (5 + c) * 4 + frames * n * (4 + c) * 4
    rounds = int((scores > 0).sum())
    ops = frames * n * n * IOU_OPS_PER_PAIR + 5 * frames * n * c + \
        rounds * n * WALK_OPS_PER_CANDIDATE
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'bytes': nbytes, 'operations': ops, 'rounds': rounds}


def decode_nms_phase(device, netout: torch.Tensor, obj: float) -> dict:
    """The fused kernel on the detector's netouts (one launch: the op has
    no entry point, so this is its driven path), against its twin and the
    staged path on those and on seeded heads; times and bound."""
    anchors = torch.tensor(YOLOV2_ANCHORS, device=device)
    cuda_dn.decode_nms_fused.launches = 0
    boxes, scores = cuda_dn.decode_nms_fused(netout, anchors, obj,
                                             NMS_THRESHOLD)
    torch.cuda.synchronize()
    launches = cuda_dn.decode_nms_fused.launches
    if launches != 1:
        raise AssertionError(f'decode_nms_fused launched {launches} times '
                             'in 1 call')
    if not (bool(torch.isfinite(boxes).all()) and bool((scores > 0).any())
            and bool((scores <= 1.0).all())):
        raise AssertionError('decode_nms_fused: bad output on the '
                             "detector's netouts")

    checks = []
    for name, net, anchors_c, thr, suppress in decode_cases(netout, obj,
                                                             device):
        kb, ks = cuda_dn.decode_nms_fused(net, anchors_c, thr,
                                          NMS_THRESHOLD)
        pb, ps = cuda_dn.decode_nms_fused_plain(
            net, anchors_c.reshape(-1, 2), thr, NMS_THRESHOLD)
        sb, ss = staged(net, anchors_c, thr)
        torch.cuda.synchronize()
        live = int((decode_netout(net, anchors_c, thr)[1] > 0).sum())
        check = {'case': name, 'shape': list(net.shape),
                 'boxes_max_abs_diff': max_abs_diff(kb, pb),
                 'scores_max_abs_diff': max_abs_diff(ks, ps),
                 'staged_boxes_max_abs_diff': max_abs_diff(kb, sb),
                 'staged_scores_max_abs_diff': max_abs_diff(ks, ss),
                 'live': live, 'kept': int((ks > 0).sum())}
        check['exact'] = (check['boxes_max_abs_diff'] == 0
                          and check['scores_max_abs_diff'] == 0)
        if not (torch.equal(ks > 0, ps > 0) and torch.equal(ks > 0, ss > 0)):
            raise AssertionError(f'decode_nms {name}: kept sets differ')
        # twin: the same operations in the same order (exact on the card
        # so far; 1e-6 allows one ulp of a transcendental). Staged path:
        # torch.softmax and divisions by a Python scalar round otherwise.
        if max(check['boxes_max_abs_diff'],
               check['scores_max_abs_diff']) > 1e-6 or max(
                   check['staged_boxes_max_abs_diff'],
                   check['staged_scores_max_abs_diff']) > 1e-5:
            raise AssertionError(f'decode_nms {name}: {check}')
        if name.startswith('all_dead') != (live == 0) or (
                suppress and check['kept'] >= live):
            raise AssertionError(f'decode_nms {name}: live {live}, '
                                 f'kept {check["kept"]}')
        checks.append(check)

    times = {}
    for frames in (8, 1):
        net = netout[:frames]
        fused = (lambda net=net: cuda_dn.decode_nms_fused(
            net, anchors, obj, NMS_THRESHOLD))
        times[f'f{frames}'] = {
            'device': op_device_ms(fused, 'decode_nms', 20),
            'kernel_call_ms': cuda_ms(fused, iters=50, warmup=5),
            'host_us': host_us(fused, 200),
            'plain_ms': cuda_ms(lambda net=net: cuda_dn.decode_nms_fused_plain(
                net, anchors.reshape(-1, 2), obj, NMS_THRESHOLD), iters=3),
            'staged_ms': cuda_ms(lambda net=net: staged(net, anchors, obj),
                                 iters=20)}
    n, c = scores.shape[-2:]
    return {'launches': launches, 'checks': checks,
            'math_probe': math_probe(device), 'times': times,
            **decode_nms_bound(scores, n, c, netout.shape[0])}


# ------------------------------------------------------------ training path
MAX_BOXES = 50
TRAIN_LR = 1e-4
# parity tolerances of the CPU tests against JAX (tests/test_torch_steps.py):
# metrics, per-leaf relative L2 (gradients and the parameters after the
# step), running statistics
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
LEAF_TOL = 1e-3
STATS_RTOL, STATS_ATOL = 1e-4, 1e-7


def train_batch(seed: int, batch: int, net: int = 0, objects: int = 8
                ) -> dict:
    """A seeded raw batch as SequenceBatches(raw_mode=True) gives it: dark
    noise frames with `objects` filled rectangles per window, each of a
    class colour, drifting from frame to frame; their boxes are the
    labels. `net` 0 is NET."""
    net, t = net or NET, T
    rng = np.random.RandomState(seed)
    colours = np.random.RandomState(123).randint(80, 256, (NUM_CLASSES, 3))
    images = rng.randint(0, 60, (batch, t, net, net, 3)).astype(np.uint8)
    boxes = np.zeros((batch, t, MAX_BOXES, 4), np.float32)
    cls = np.zeros((batch, t, MAX_BOXES), np.int32)
    valid = np.zeros((batch, t, MAX_BOXES), bool)
    lo, hi = net // 16, net // 3
    for b in range(batch):
        for k in range(objects):
            c = rng.randint(NUM_CLASSES)
            w, h = rng.randint(lo, hi, 2)
            x, y = rng.randint(0, net - w), rng.randint(0, net - h)
            vx, vy = rng.randint(-6, 7, 2)
            for f in range(t):
                x1 = int(np.clip(x + vx * f, 0, net - w))
                y1 = int(np.clip(y + vy * f, 0, net - h))
                images[b, f, y1:y1 + h, x1:x1 + w] = colours[c]
                boxes[b, f, k] = (x1, y1, x1 + w, y1 + h)
                cls[b, f, k] = c
                valid[b, f, k] = True
    return {'images_u8': images, 'boxes': boxes, 'cls': cls, 'valid': valid,
            'aug_seeds': rng.randint(0, 2**31 - 1, batch).astype(np.uint32)}


def train_step_fn(net: int, augment: bool):
    return make_joint_train_step_fused(
        YOLOV2_ANCHORS, augment=augment, net_h=net, net_w=net,
        grid_h=net // 32, grid_w=net // 32, num_classes=NUM_CLASSES,
        true_box_buffer=MAX_BOXES)


def train_state(device, width_div: int = 1, dtype=torch.float32,
                seed: int = 0, layers: int = 1, **model_kw) -> TrainState:
    model = init_like_flax(MultiObjDetTracker(
        num_classes=NUM_CLASSES, num_anchors=5,
        convlstm_features=512 // width_div, width_div=width_div,
        dtype=dtype, convlstm_layers=layers, **model_kw), seed)
    return TrainState.create(model.to(device), make_optimizer(TRAIN_LR))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))


def step_parity(cpu: TrainState, card: TrainState, step, batch,
                lr: float) -> dict:
    """One step of `step` on the CPU state and on its card copy (same
    weights) with the same batch: metrics, gradients, updated parameters
    and BatchNorm statistics within the CPU parity tests' tolerances, and
    every parameter with a gradient moved. Raises otherwise."""
    init = {n: p.detach().clone() for n, p in cpu.model.named_parameters()}
    _, m_cpu = step(cpu, batch)
    _, m_card = step(card, batch)
    torch.cuda.synchronize()
    metrics = {k: [float(m_card[k]), float(m_cpu[k])] for k in m_cpu}
    bad = [k for k, (a, b) in metrics.items()
           if abs(a - b) > METRIC_ATOL + METRIC_RTOL * abs(b)]
    card_p = dict(card.model.named_parameters())
    cpu_p = {n: p for n, p in cpu.model.named_parameters()
             if p.grad is not None}
    grads = {n: rel_l2(card_p[n].grad.cpu(), p.grad)
             for n, p in cpu_p.items()}
    params = {n: rel_l2(card_p[n].detach().cpu(), p.detach())
              for n, p in cpu_p.items()}
    updates = {n: float((card_p[n].detach().cpu() - p.detach()).norm())
               / (lr * p.numel() ** 0.5) for n, p in cpu_p.items()}
    card_b = dict(card.model.named_buffers())
    stats = {n: float(((card_b[n].cpu() - b).abs()
                       / (STATS_ATOL + STATS_RTOL * b.abs())).max())
             for n, b in cpu.model.named_buffers()}
    moved = sum(not torch.equal(init[n], p.detach())
                for n, p in cpu_p.items())
    stepped = sum(bool(p.grad.any()) for p in cpu_p.values())
    out = {'metrics_card_cpu': metrics, 'metrics_out_of_tol': bad,
           'grad_rel_l2_max': max(grads.values()),
           'grad_rel_l2_worst': max(grads, key=grads.get),
           'param_rel_l2_max': max(params.values()),
           'param_rel_l2_worst': max(params, key=params.get),
           'update_rms_err_over_lr_max': max(updates.values()),
           'stats_err_over_tol_max': max(stats.values(), default=0.0),
           'params_moved': moved, 'params_with_gradient': stepped,
           'params': len(init),
           'tolerance': {'metrics_rtol': METRIC_RTOL,
                         'metrics_atol': METRIC_ATOL,
                         'grad_rel_l2': LEAF_TOL, 'param_rel_l2': LEAF_TOL,
                         'stats_rtol': STATS_RTOL, 'stats_atol': STATS_ATOL}}
    if (bad or out['grad_rel_l2_max'] > LEAF_TOL
            or out['param_rel_l2_max'] > LEAF_TOL
            or out['stats_err_over_tol_max'] > 1.0 or moved != stepped):
        raise AssertionError(f'card and CPU steps disagree: {out}')
    return out


def card_matches_cpu(device, layers: int = 1, **model_kw) -> dict:
    """One fused float32 step without augmentation of a reduced model
    (width_div=8, 128², T=4, B=2, `layers` ConvLSTM layers, `model_kw`'s
    options) on the card and on the CPU, from the same weights and batch:
    metrics, gradients, updated parameters and BatchNorm statistics within
    the CPU parity tests' tolerances."""
    net = 128
    raw = train_batch(5, 2, net=net, objects=4)
    cpu = train_state('cpu', width_div=8, layers=layers, **model_kw)
    card = TrainState.create(copy.deepcopy(cpu.model).to(device),
                             make_optimizer(TRAIN_LR))
    out = step_parity(cpu, card, train_step_fn(net, augment=False), raw,
                      TRAIN_LR)
    if out['params_moved'] != out['params']:
        raise AssertionError(f'a parameter did not move: {out}')
    return {'shape': {'net': net, 'T': T, 'B': 2, 'width_div': 8,
                      'convlstm_layers': layers, **model_kw}, **out}


def checkpoint_round_trip(device) -> dict:
    """Save after step 2, restore into a fresh state; step 3 from each
    state must agree to 1e-6 (cuDNN deterministic for this check only)."""
    net = 128
    raws = [train_batch(10 + i, 2, net=net, objects=4) for i in range(3)]
    step = train_step_fn(net, augment=True)
    state = train_state(device, width_div=8)
    for raw in raws[:2]:
        state, _ = step(state, raw)
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp)
            mgr.save(2, state)
            fresh, at = mgr.restore(train_state(device, width_div=8, seed=1))
            _, m_a = step(state, raws[2])
            _, m_b = step(fresh, raws[2])
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    param_diff = max(float((a - b).abs().max()) for a, b in zip(
        state.model.state_dict().values(), fresh.model.state_dict().values()))
    metric_diff = max(abs(float(m_a[k]) - float(m_b[k])) for k in m_a)
    out = {'restored_at': at, 'steps': [state.step, fresh.step],
           'max_abs_diff_state': param_diff,
           'max_abs_diff_metrics': metric_diff, 'tolerance': 1e-6,
           'cudnn_deterministic': 'this check only'}
    if at != 2 or fresh.step != 3 or max(param_diff, metric_diff) > 1e-6:
        raise AssertionError(f'checkpoint round trip: {out}')
    return out


def timed(fn):
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - start) * 1e3


def train_readings(state, step, batches, key: str, readings: dict,
                   categories=TRAIN_CATEGORIES) -> None:
    """One configuration: the first step's time (host clock, synchronised),
    steps/s (median of three samples of 5 steps, all kept), the step's
    device profile, the peak memory, and the loss of every step taken,
    pulled once at the end. The steps cycle through `batches`, as a
    training run sees a new batch each step."""
    torch.cuda.reset_peak_memory_stats()
    losses, turn = [], [0]

    def call():
        raw = batches[turn[0] % len(batches)]
        turn[0] += 1
        losses.append(step(state, raw)[1]['loss'])
    _, first_ms = timed(call)
    out = {'first_step_ms': first_ms}
    median = put_rate(out, 'steps_per_s', rate(call, 1, 5))
    out['profile'] = breakdown(device_times(call, 2, state.model),
                               1e3 / median, categories)
    out['max_memory_allocated_bytes'] = torch.cuda.max_memory_allocated()
    out['losses'] = torch.stack(losses).cpu().tolist()
    readings[key] = out
    if not np.isfinite(out['losses']).all():
        raise AssertionError(f'non-finite loss at {key}: {out["losses"]}')


def train_phase(device, smi: str):
    """The joint trainer's fused step at bench.py's model on the card.
    Returns its reading and the weights of its 30 learning steps (on the
    host), which the serve phase exports."""
    parity = card_matches_cpu(device)
    round_trip = checkpoint_round_trip(device)

    state = train_state(device)
    step = train_step_fn(NET, augment=True)
    fixed = train_batch(0, 1)
    # it learns: 30 steps on one fixed batch, the second under sync-debug
    # mode 'error' (any host sync in the step raises)
    losses = []
    for i in range(30):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
        try:
            if i == 0:
                (_, metrics), first_ms = timed(lambda: step(state, fixed))
            elif i == 2:
                (_, metrics), bn = bn_engagement(
                    state.model, lambda: step(state, fixed))
            else:
                _, metrics = step(state, fixed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses.append(metrics['loss'])
    trajectory = torch.stack(losses).cpu().tolist()
    first5, last5 = np.mean(trajectory[:5]), np.mean(trajectory[-5:])
    if not (np.isfinite(trajectory).all() and last5 < first5):
        raise AssertionError(f'training did not learn: {trajectory}')

    serve_out = serve_trained(state.model, device)

    # readings: each configuration starts from the weights the 30 steps
    # left and cycles through 4 batches it has not seen, at lr 0: every
    # kernel of a step still runs (Adam scales its update by 0), and the
    # four configurations time one set of weights. At lr 1e-4 the
    # from-scratch loss spikes on unseen batches (exp(tw) in the wh term,
    # up to ~1e8 in the first 20 steps), and one run's bfloat16 steps
    # overflowed to a non-finite loss. Only the configuration measured
    # lives on the card, so its peak memory is its own.
    weights = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del state, metrics, losses
    gc.collect()
    readings = {}
    for name, dtype in (('float32', torch.float32),
                        ('bfloat16', torch.bfloat16)):
        for batch in (1, 4):
            config = train_state(device, dtype=dtype).with_learning_rate(0.0)
            config.model.load_state_dict(weights)
            batches = [train_batch(100 * batch + i, batch) for i in range(4)]
            train_readings(config, step, batches, f'b{batch}_{name}',
                           readings)
            del config
            gc.collect()
    readings['b1_float32']['first_step_ms_untrained'] = first_ms

    return {'phase': 'train', 'net': NET, 'T': T, 'classes': NUM_CLASSES,
            'anchors': 5, 'convlstm_features': 512, 'width_div': 1,
            'max_boxes': MAX_BOXES, 'lr': TRAIN_LR, 'readings_lr': 0.0,
            'augment': True,
            'card_vs_cpu': parity, 'checkpoint': round_trip,
            'sync_debug_step': 'no sync raised', 'bn_launches': bn,
            'loss_trajectory': trajectory,
            'loss_first5_mean': first5, 'loss_last5_mean': last5,
            'readings': readings, 'serve': serve_out, 'card': smi}, weights


def serve_trained(model, device, net: int = 0) -> dict:
    """Train → serve: the trained model in JointPredictor, three
    predict_window calls on net² frames (`net` 0 is NET); kernel 1
    launches once per call, and nms_impl='sort' gives identical
    detections and ids."""
    net = net or NET
    model.eval()
    clips = [train_batch(20 + i, 1, net=net)['images_u8'].astype(np.float32)
             / 255.0 for i in range(3)]
    obj_threshold = pick_obj_threshold(model, np.concatenate(clips), device)
    kwargs = dict(labels=LABELS_MOT17, obj_threshold=obj_threshold,
                  nms_threshold=NMS_THRESHOLD, net_size=(net, net),
                  device=device)
    torch.backends.cudnn.deterministic = True
    try:
        kernel_pred = JointPredictor(model, YOLOV2_ANCHORS, nms_impl='auto',
                                     **kwargs)
        cuda_nms.nms_scores.launches = 0
        frames = []
        for i, clip in enumerate(clips):
            frames.extend(kernel_pred.predict_window(clip[0]))
            if cuda_nms.nms_scores.launches != i + 1:
                raise AssertionError('nms_scores did not launch once per '
                                     'predict_window call')
        launches = cuda_nms.nms_scores.launches
        sort_pred = JointPredictor(model, YOLOV2_ANCHORS, nms_impl='sort',
                                   **kwargs)
        sort_frames = []
        for clip in clips:
            sort_frames.extend(sort_pred.predict_window(clip[0]))
    finally:
        torch.backends.cudnn.deterministic = False
    if sort_frames != frames:
        raise AssertionError("trained model: impl='kernel' and 'sort' "
                             'disagree')
    return {'predict_window_calls': len(clips), 'nms_launches': launches,
            'obj_threshold': obj_threshold, 'kernel_equals_sort': True,
            **check_results(frames, obj_threshold)}


# --------------------------------------------------- single-object pipeline
TRACK_B = 4            # TrainConfig.batch_size
TRACK_T = 4            # TrackerConfig.sequence_length
TRACK_VIDEOS, TRACK_FRAMES = 2, 16
TINY_LR = 1e-3         # TrainConfig.learning_rate
PRECOMPUTE_CHUNK = 16  # TrackerSequenceBatches.precompute's chunk
# kernel-name fragments → category of a tiny step's device time
TINY_CATEGORIES = (
    ('matmul', ('gemm', 'gemv', 'sm90_', 'cutlass', 'xmma', 'splitk')),
    ('optimizer', ('multi_tensor_apply', 'adam')),
    ('memcpy', ('memcpy', 'memset')),
)


def tracker_folder(seed: int):
    """Seeded videos as an in-memory folder: {path: (NET, NET, 3) float32
    frame}, and one annotation per frame whose object is the first of
    three filled rectangles drifting over dark noise (label set later)."""
    rng = np.random.RandomState(seed)
    frames, anns = {}, []
    for v in range(TRACK_VIDEOS):
        rects = [(rng.randint(NET // 10, NET // 3, 2),
                  rng.randint(0, NET // 2, 2), rng.randint(-8, 9, 2),
                  rng.randint(80, 256, 3)) for _ in range(3)]
        for f in range(TRACK_FRAMES):
            img = rng.randint(0, 60, (NET, NET, 3)).astype(np.uint8)
            boxes = []
            for (w, h), (x, y), (vx, vy), colour in rects:
                x1 = int(np.clip(x + vx * f, 0, NET - w))
                y1 = int(np.clip(y + vy * f, 0, NET - h))
                img[y1:y1 + h, x1:x1 + w] = colour
                boxes.append((x1, y1, x1 + w, y1 + h))
            path = f'frames/v{v}/{f:04d}.jpg'
            frames[path] = img.astype(np.float32) / 255.0
            anns.append(Annotation(path, f'v{v}', NET, NET, [
                ObjectAnnotation('', *map(float, boxes[0]))]))
    return frames, anns


def same_batches(a: list, b: list) -> float:
    """Largest |a - b| over every array of two lists of batches."""
    return max(float(np.abs(x[k] - y[k]).max())
               for x, y in zip(a, b) for k in x)


def tracker_batches(det, windows, frames) -> tuple:
    """The YOLOv2-prior batches, precomputed and augmented: kernel 1
    launches once per precompute chunk and once per augmented batch, and
    the 'sort' NMS gives identical batches (cuDNN deterministic for both).
    Returns the batches, their launch counts and the record."""
    kw = dict(net_h=NET, net_w=NET, batch_size=TRACK_B, seed=0,
              loader=frames.__getitem__)
    out, launches, record = {}, {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for mode, augment in (('precompute', False), ('augment', True)):
            det.nms_impl = 'auto'
            gen = TrackerSequenceBatches(windows, LABELS_COCO, det,
                                         augment=augment, **kw)
            cuda_nms.nms_scores.launches = 0
            batches = list(gen())
            torch.cuda.synchronize()
            launches[mode] = cuda_nms.nms_scores.launches
            want = (len(gen) if augment else
                    -(-len(frames) // PRECOMPUTE_CHUNK))
            if launches[mode] != want:
                raise AssertionError(f'tracker {mode}: nms_scores launched '
                                     f'{launches[mode]} times, not {want}')
            det.nms_impl = 'sort'
            sort = list(TrackerSequenceBatches(windows, LABELS_COCO, det,
                                               augment=augment, **kw)())
            diff = same_batches(batches, sort)
            if diff != 0:
                raise AssertionError(f"tracker {mode}: nms_impl='sort' "
                                     f'batches differ by {diff}')
            dets = np.concatenate([b['det'] for b in batches])
            record[mode] = {
                'batches': len(batches), 'nms_launches': launches[mode],
                'kernel_equals_sort_max_abs_diff': diff,
                'frames_with_detection': int((np.abs(dets).sum(-1)
                                              > 0).sum()),
                'frames': int(dets.shape[0] * dets.shape[1])}
            out[mode] = batches
    finally:
        det.nms_impl = 'auto'
        torch.backends.cudnn.deterministic = False
    feats = (TRACK_B, TRACK_T) + det.get_layer_dims('conv_feat')
    for b in out['precompute'] + out['augment']:
        if not all(np.isfinite(v).all() for v in b.values()) or \
                b['feats'].shape != feats:
            raise AssertionError('tracker batch: bad shape or value')
    return out, launches, record


def learns(state, step, batch, steps: int) -> dict:
    """`steps` steps on one fixed batch, the second under sync-debug mode
    'error' (a host sync in the step raises): a finite, falling loss."""
    losses = []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
        try:
            losses.append(step(state, batch)[1]['loss'])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    trajectory = torch.stack(losses).cpu().tolist()
    first5, last5 = np.mean(trajectory[:5]), np.mean(trajectory[-5:])
    if not (np.isfinite(trajectory).all() and last5 < first5):
        raise AssertionError(f'training did not learn: {trajectory}')
    return {'sync_debug_step': 'no sync raised', 'loss_trajectory':
            trajectory, 'loss_first5_mean': first5, 'loss_last5_mean': last5}


def readings_by_dtype(make_state, step, batches, categories, keys) -> dict:
    """For each (key, batches) and dtype, one configuration alone on the
    card: steps/s (median of three samples, all kept), device time by
    category, idle share and launches, peak memory, every loss."""
    readings = {}
    for name, dtype in (('float32', torch.float32),
                        ('bfloat16', torch.bfloat16)):
        for key, group in zip(keys, batches):
            state = make_state(dtype)
            train_readings(state, step, group, f'{key}_{name}', readings,
                           categories)
            del state
            gc.collect()
    return readings


def tracker_phase(device, smi: str) -> dict:
    """The single-object pipeline at TrackerConfig() defaults over the
    full-width YOLOv2 prior: batches, TinyTracker steps, one fit epoch."""
    cfg = DetectorConfig()
    det = YOLOv2Detector(cfg, seed=0, device=device)
    frames, anns = tracker_folder(7)
    images = np.stack(list(frames.values()))
    calibrate_bn(det.model, torch.from_numpy(images[:8]).to(device))
    cfg.obj_threshold = live_threshold(det.forward(images[:8])['netout'],
                                       det.anchors)
    # each frame's object takes the class of the prior's best detection
    _, _, labels, scores, valid = det.forward_batch(images)
    best = torch.where(valid, scores, torch.zeros_like(scores)).argmax(-1)
    names = [LABELS_COCO[int(labels[i, k])] if bool(valid[i, k])
             else 'person' for i, k in enumerate(best.tolist())]
    for ann, name in zip(anns, names):
        ann.objects[0].label = name
    windows = make_sequence_windows(anns, TRACK_T)
    batches, launches, record = tracker_batches(det, windows, frames)
    heat = list(TrackerSequenceBatches(
        windows, LABELS_COCO, det, net_h=NET, net_w=NET,
        batch_size=TRACK_B, target_mode='heatmap', heatmap_size=32,
        augment=False, seed=0, loader=frames.__getitem__)())

    feat_shape = det.get_layer_dims('conv_feat')
    heads = {}
    for name, heatmap, loss, residual in (
            ('bbox_bce', False, 'bce', False),
            ('bbox_huber_residual', False, 'huber', True),
            ('heatmap_bce', True, 'bce', False)):
        group = heat if heatmap else batches['precompute']

        def make_state(dtype=torch.float32, on=device, heatmap=heatmap,
                       residual=residual):
            model = init_like_flax(TinyTracker(
                feat_shape, lstm_units=512,
                out_dim=1024 if heatmap else 4, pool='Global', dtype=dtype,
                residual_det=residual), 0)
            return TrainState.create(model.to(on), make_optimizer(TINY_LR))
        step = make_tiny_train_step(heatmap, loss)
        cpu = make_state(on='cpu')
        card = TrainState.create(copy.deepcopy(cpu.model).to(device),
                                 make_optimizer(TINY_LR))
        out = {'card_vs_cpu': step_parity(cpu, card, step, group[0],
                                          TINY_LR)}
        out.update(learns(make_state(), step, group[0], 30))
        out['readings'] = readings_by_dtype(make_state, step, [group],
                                            TINY_CATEGORIES, ['b4'])
        heads[name] = out

    # one epoch of the flow's loop over the precomputed prior batches
    gen = TrackerSequenceBatches(windows, LABELS_COCO, det, net_h=NET,
                                 net_w=NET, batch_size=TRACK_B,
                                 augment=False, seed=0,
                                 loader=frames.__getitem__)
    state = TrainState.create(init_like_flax(TinyTracker(feat_shape), 0)
                              .to(device), make_optimizer(TINY_LR))
    start = time.perf_counter()
    seen = []
    fit(state, make_tiny_train_step(), gen, eval_step=make_tiny_eval_step(),
        val_batches=gen, epochs=1,
        on_epoch_end=lambda e, s, t, v: seen.append((t, v)))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - start
    (train_m, val_m), = seen
    if state.step != len(gen) or not np.isfinite(
            [train_m['loss'], val_m['loss']]).all():
        raise AssertionError(f'fit epoch: step {state.step}, {train_m}, '
                             f'{val_m}')
    return {'phase': 'tracker', 'net': NET, 'T': TRACK_T, 'B': TRACK_B,
            'classes': cfg.num_classes, 'lstm_units': 512, 'pool': 'Global',
            'feature': list(feat_shape), 'lr': TINY_LR,
            'obj_threshold': cfg.obj_threshold, 'windows': len(windows),
            'frames': len(frames), 'batches': record, 'heads': heads,
            'fit_epoch': {'steps': state.step, 'seconds': epoch_s,
                          'train': train_m, 'val': val_m},
            'card': smi}, launches


# ------------------------------------------------ standalone detector path
DET_LR = 1e-4          # TrainConfig.joint_learning_rate, the flow's rate
# the two-[yolo]-head topology of tests/test_darknet_cfg.py::V3_CFG at 416²
V3_CFG_416 = """
[net]
height=416
width=416
channels=3
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
activation=leaky
[convolutional]
batch_normalize=1
filters=8
size=3
activation=leaky
[shortcut]
from=-2
activation=linear
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
activation=leaky
[convolutional]
filters=21
size=1
activation=linear
[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=2
[route]
layers=-3
[upsample]
stride=2
[convolutional]
filters=21
size=1
activation=linear
[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=2
"""


def detection_batch(seed: int, batch: int, net: int = 0,
                    classes: int = 80) -> dict:
    """A seeded DetectionBatches-shaped batch: the first frame of each of
    train_batch's windows, its boxes encoded for Darknet-19's grid."""
    net = net or NET
    raw = train_batch(seed, batch, net=net)
    y, b = encode_targets_batch(
        torch.from_numpy(raw['boxes'][:, 0]), torch.from_numpy(
            raw['cls'][:, 0]), torch.from_numpy(raw['valid'][:, 0]),
        YOLOV2_ANCHORS, image_h=net, image_w=net, grid_h=net // 32,
        grid_w=net // 32, num_classes=classes, true_box_buffer=MAX_BOXES)
    return {'images': raw['images_u8'][:, 0].astype(np.float32) / 255.0,
            'y_true': y.numpy(), 'true_boxes': b.numpy()}


def multihead_parity(device) -> dict:
    """make_multihead_detector_train_step on the two-[yolo]-head cfg at
    416²: one step card against CPU; each head's grid from one forward."""
    cpu_net = init_like_flax(build_from_cfg(V3_CFG_416)[0], 0)
    grids = head_grids(cpu_net, NET, 'cpu')
    heads = tuple((tuple(float(v) for v in np.asarray(
        s['anchors'], np.float32).reshape(-1)), gh, gw, s['num_classes'])
        for s, (gh, gw) in zip(head_specs(cpu_net.plan), grids))
    raw = train_batch(31, 2)
    cls = raw['cls'][:, 0] % 2
    ys, bs = encode_targets_multiscale(
        torch.from_numpy(raw['boxes'][:, 0]), torch.from_numpy(cls),
        torch.from_numpy(raw['valid'][:, 0]), heads, image_h=NET,
        image_w=NET, true_box_buffer=MAX_BOXES)
    batch = {'images': raw['images_u8'][:, 0].astype(np.float32) / 255.0,
             'y_true': tuple(y.numpy() for y in ys),
             'true_boxes': tuple(b.numpy() for b in bs)}
    step = make_multihead_detector_train_step(heads, (NET, NET))
    cpu = TrainState.create(cpu_net, make_optimizer(DET_LR))
    card = TrainState.create(copy.deepcopy(cpu_net).to(device),
                             make_optimizer(DET_LR))
    return {'grids': grids, **step_parity(cpu, card, step, batch, DET_LR)}


def detector_train_phase(device, smi: str) -> dict:
    """make_detector_train_step on YOLOv2 at DetectorConfig(): card against
    CPU at a reduced cut, then at full width a sync-free step, 20 steps on
    a fixed batch, and readings at B=8 and B=32; the multi-head step."""
    cfg = DetectorConfig()
    step = make_detector_train_step(cfg.anchors)
    net = 128
    cpu = TrainState.create(init_like_flax(Darknet19(
        cfg.num_classes, cfg.num_anchors, width_div=8), 0),
        make_optimizer(DET_LR))
    card = TrainState.create(copy.deepcopy(cpu.model).to(device),
                             make_optimizer(DET_LR))
    parity = {'shape': {'net': net, 'B': 2, 'width_div': 8},
              **step_parity(cpu, card, step,
                            detection_batch(41, 2, net=net), DET_LR)}

    det = YOLOv2Detector(cfg, seed=0, device=device)
    init_like_flax(det.model, 0)            # the flow's start without weights
    state = TrainState.create(det.model, make_optimizer(DET_LR))
    learned = learns(state, step, detection_batch(42, 8), 20)
    weights = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del state, det
    gc.collect()

    def make_state(dtype):
        model = Darknet19(cfg.num_classes, cfg.num_anchors, dtype)
        model.load_state_dict(weights)
        return TrainState.create(model.to(device),
                                 make_optimizer(DET_LR)).with_learning_rate(
                                     0.0)
    # at lr 0 every kernel of a step runs and the weights stay those the 20
    # steps left (see train_phase); B=32 is DetectorConfig.batch_size
    readings = readings_by_dtype(
        make_state, step,
        [[detection_batch(300 + i, b) for i in range(2)] for b in (8, 32)],
        TRAIN_CATEGORIES, ['b8', 'b32'])
    return {'phase': 'detector_train', 'net': NET,
            'classes': cfg.num_classes, 'anchors': cfg.num_anchors,
            'width_div': cfg.width_div, 'lr': DET_LR, 'readings_lr': 0.0,
            'card_vs_cpu': parity, **learned, 'readings': readings,
            'multihead_card_vs_cpu': multihead_parity(device), 'card': smi}


# ------------------------------------------------ deep head and serving
DEEP_LAYERS = 2        # the deep head's ConvLSTM depth on the chip
SERVED_TOL = 1e-5      # served boxes and scores against JointPredictor's


def joint_model(device, layers: int = 1, **model_kw):
    """bench.py's joint model (416², 12 classes, 5 anchors, ConvLSTM-512,
    full width) with `layers` ConvLSTM layers and `model_kw`'s options,
    random weights from seed 0, in eval() mode (serving writes no
    statistic)."""
    torch.manual_seed(0)
    return MultiObjDetTracker(num_classes=NUM_CLASSES, num_anchors=5,
                              convlstm_features=512, width_div=1,
                              convlstm_layers=layers,
                              **model_kw).to(device).eval()


def streamed_windows(pred, clips) -> list:
    """One stream of predict_window calls, one per (1, T, H, W, 3) clip;
    kernel 1 must launch once per call. Returns the per-frame lists."""
    pred.reset_state()
    cuda_nms.nms_scores.launches = 0
    frames = []
    for i, clip in enumerate(clips):
        frames.extend(pred.predict_window(clip[0]))
        if cuda_nms.nms_scores.launches != i + 1:
            raise AssertionError('nms_scores did not launch once per '
                                 'predict_window call')
    return frames


def deep_phase(device, smi: str) -> dict:
    """The deep ConvLSTM head (convlstm_layers=2): one fused train step at
    the reduced cut on the card against the CPU; at bench.py's model three
    streamed predict_window calls, kernel 1 once per call, identical to
    nms_impl='sort'; and the B=1 call's cost against the single-layer
    head's in the same process."""
    parity = card_matches_cpu(device, layers=DEEP_LAYERS)
    clips = requests(np.random.RandomState(2), 1, 3)
    model = joint_model(device, DEEP_LAYERS)
    obj_threshold = pick_obj_threshold(model, clips[0], device)
    kwargs = dict(labels=LABELS_MOT17, obj_threshold=obj_threshold,
                  nms_threshold=NMS_THRESHOLD, net_size=(NET, NET),
                  device=device)
    torch.backends.cudnn.deterministic = True    # both runs: same netouts
    try:
        frames = streamed_windows(JointPredictor(model, YOLOV2_ANCHORS,
                                                 **kwargs), clips)
        launches = cuda_nms.nms_scores.launches
        sort_frames = []
        sort_pred = JointPredictor(model, YOLOV2_ANCHORS, nms_impl='sort',
                                   **kwargs)
        for clip in clips:
            sort_frames.extend(sort_pred.predict_window(clip[0]))
    finally:
        torch.backends.cudnn.deterministic = False
    if sort_frames != frames:
        raise AssertionError("deep head: impl='kernel' and 'sort' "
                             'disagree')
    (c, h), (cs, hs) = sort_pred._state
    if cs.shape != (DEEP_LAYERS - 1, 1, NET // 32, NET // 32,
                    model.convlstm_features):
        raise AssertionError(f'deep head state {tuple(cs.shape)}')
    rates, profiles = {}, {}
    for layers, m in ((1, joint_model(device)), (DEEP_LAYERS, model)):
        pred = JointPredictor(m, YOLOV2_ANCHORS, **kwargs)
        key = f'layers{layers}_b1_float32'
        median = put_rate(rates, f'fps_{key}', fps(pred, clips[0], 10,
                                                   False))
        profiles[key] = breakdown(device_times(
            lambda p=pred: p.predict_window(clips[0][0]), 2, m),
            1e3 * T / median)
    return {'phase': 'deep', 'convlstm_layers': DEEP_LAYERS,
            'card_vs_cpu': parity, 'net': NET, 'T': T,
            'classes': NUM_CLASSES, 'convlstm_features': 512,
            'width_div': 1, 'obj_threshold': obj_threshold,
            'predict_window_calls': len(clips), 'nms_launches': launches,
            'kernel_equals_sort': True, **check_results(frames,
                                                       obj_threshold),
            **rates, 'profiles': profiles, 'card': smi}


def as_served(frames_u8: np.ndarray, device) -> np.ndarray:
    """uint8 frames normalised as the served program normalises them, /255
    on the device (on the card a multiply by the reciprocal, which can
    differ from the host's division by an ulp), back on the host: the
    same float frames for JointPredictor."""
    return (torch.from_numpy(frames_u8).to(device).float()
            / 255.0).cpu().numpy()


def same_served(got: list, want: list) -> float:
    """Per call, clip and frame: the same labels and track ids in the same
    order, boxes and scores within SERVED_TOL; returns the largest
    difference. Raises otherwise."""
    worst = 0.0
    for i, (call_got, call_want) in enumerate(zip(got, want, strict=True)):
        for clip_got, clip_want in zip(call_got, call_want, strict=True):
            for f_got, f_want in zip(clip_got, clip_want, strict=True):
                if ([(d['label'], d['track_id']) for d in f_got]
                        != [(d['label'], d['track_id']) for d in f_want]):
                    raise AssertionError(
                        f'served labels or ids differ in call {i}: '
                        f'{f_got[:4]} against {f_want[:4]}')
                for a, b in zip(f_got, f_want):
                    worst = max(worst, abs(a['score'] - b['score']),
                                *(abs(x - y) for x, y in zip(a['box'],
                                                             b['box'])))
    if worst > SERVED_TOL:
        raise AssertionError(f'served boxes or scores differ by {worst}')
    return worst


def served_calls(served, reqs) -> list:
    """Three streamed calls of the served program; kernel 1 launches once
    per call."""
    served.reset_state()
    cuda_nms.nms_scores.launches = 0
    out = []
    for i, clips in enumerate(reqs):
        out.append(served.predict_window(clips))
        if cuda_nms.nms_scores.launches != i + 1:
            raise AssertionError('nms_scores did not launch once per '
                                 'served call')
    return out


def start_reload(art: bytes, reqs, tmp: str, device) -> subprocess.Popen:
    """Start a fresh interpreter that imports only serving.py (never the
    port's models) and serves the artifact on `device` over `reqs`;
    `reloaded` collects what it served."""
    path = save_artifact(art, str(Path(tmp) / 'joint.ottserve'))
    np.save(Path(tmp) / 'frames.npy', np.stack(reqs))
    code = (
        'import json, sys\n'
        'import numpy as np, torch\n'
        'torch.backends.cuda.matmul.allow_tf32 = False\n'
        'torch.backends.cudnn.allow_tf32 = False\n'
        'torch.backends.cudnn.deterministic = True\n'
        'from object_tracking_tpu_torch.serving import '
        'ServedJointPredictor\n'
        f'served = ServedJointPredictor.load({path!r}, '
        f'device={str(device)!r})\n'
        f'out = [served.predict_window(x) for x in np.load('
        f'{str(Path(tmp) / "frames.npy")!r})]\n'
        'assert "object_tracking_tpu_torch.models" not in sys.modules\n'
        'print(json.dumps(out))\n')
    return subprocess.Popen([sys.executable, '-c', code],
                            cwd=str(Path(__file__).resolve().parent),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def reloaded(proc: subprocess.Popen) -> list:
    """What start_reload's interpreter served; it is killed after 600 s."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f'reload failed: {err[-2000:]}')
    return json.loads(out.strip().splitlines()[-1])


def serve_phase(device, smi: str, weights: dict) -> dict:
    """The train phase's weights exported (torch.export, kernel 1 as the
    custom op) at B=8 and served: three streamed calls, against
    JointPredictor on the same weights and frames; a B=1 deep-head
    artifact at the reduced cut: its 4-leaf state, and a reload in a
    process without the models, which runs beside the B=8 export and its
    checks; frames/s served and through JointPredictor."""
    model = joint_model(device)
    model.load_state_dict(weights)
    reqs = [train_batch(140 + i, 8)['images_u8'] for i in range(3)]
    obj_threshold = pick_obj_threshold(model, as_served(reqs[0], device),
                                       device)
    kwargs = dict(obj_threshold=obj_threshold, nms_threshold=NMS_THRESHOLD)
    out = {'phase': 'serve', 'net': NET, 'T': T, 'classes': NUM_CLASSES,
           'convlstm_features': 512, 'width_div': 1,
           'weights': 'the train phase, 30 steps',
           'obj_threshold': obj_threshold, 'tolerance': SERVED_TOL,
           'card': smi}
    launches, rates = {}, {}
    torch.backends.cudnn.deterministic = True    # served and eager alike
    proc = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            deep, proc, deep_got = served_deep_head(device, tmp)
            launches['served_deep_head'] = deep['nms_launches']
            art, export_s = timed(lambda: export_joint(
                model, YOLOV2_ANCHORS, LABELS_MOT17, batch=8, window=T,
                net_size=(NET, NET), **kwargs))
            served, load_s = timed(lambda: ServedJointPredictor(
                art, device=device))
            graph = [n.target for n in served.exported.graph.nodes]
            if (graph.count(torch.ops.ott_torch.nms_scores.default) != 1
                    or served.exported.graph_signature.buffers_to_mutate):
                raise AssertionError('the served graph does not call the '
                                     'op once, or writes a buffer')
            got = served_calls(served, reqs)
            launches['served_b8'] = cuda_nms.nms_scores.launches
            pred = JointPredictor(model, YOLOV2_ANCHORS, LABELS_MOT17,
                                  net_size=(NET, NET), device=device,
                                  **kwargs)
            want = [pred.predict_batch(as_served(c, device)) for c in reqs]
            out['b8'] = {
                'export_s': export_s / 1e3, 'load_s': load_s / 1e3,
                'artifact_mb': len(art) / 1e6, 'graph_nodes': len(graph),
                'max_abs_diff_vs_joint_predictor': same_served(got, want),
                **check_results([f for call in got for clip in call
                                 for f in clip], obj_threshold)}
            deep['reload_without_models_max_abs_diff'] = same_served(
                reloaded(proc), deep_got)
            out['deep_head'] = deep
        put_rate(rates, 'fps_served_b8_float32', rate(
            lambda: served.predict_window(reqs[0]), 8 * T, 5,
            SHORT_SAMPLES))
        put_rate(rates, 'fps_joint_predictor_b8_float32', rate(
            lambda c=as_served(reqs[0], device): pred.predict_batch(c),
            8 * T, 5, SHORT_SAMPLES))
    finally:
        torch.backends.cudnn.deterministic = False
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {**out, **rates, 'nms_launches': launches}


def served_deep_head(device, tmp: str) -> tuple:
    """A deep head (convlstm_layers=2) at the reduced cut (width_div=8,
    128²) exported at B=1 on the card: its 4-leaf state streams and
    resets as tests/test_serving.py's deep case does, and its calls equal
    JointPredictor's. Returns the record, the started reload of the
    artifact in a fresh interpreter that never imports the port's models
    (`start_reload`), and the calls it must reproduce."""
    net = 128
    torch.manual_seed(0)
    model = MultiObjDetTracker(num_classes=NUM_CLASSES, num_anchors=5,
                               convlstm_features=64, width_div=8,
                               convlstm_layers=DEEP_LAYERS).to(device).eval()
    frames = train_batch(77, 1, net=net, objects=4)['images_u8']
    obj_threshold = pick_obj_threshold(model, as_served(frames, device),
                                       device)
    kwargs = dict(obj_threshold=obj_threshold, nms_threshold=NMS_THRESHOLD)
    art, export_s = timed(lambda: export_joint(
        model, YOLOV2_ANCHORS, LABELS_MOT17, batch=1, window=T,
        net_size=(net, net), **kwargs))
    served = ServedJointPredictor(art, device=device)
    leaves = [leaf['shape'] for leaf in served.meta['state_leaves']]
    got = served_calls(served, [frames] * 3)
    launches = cuda_nms.nms_scores.launches
    served.reset_state()
    again = served.predict_window(frames)
    if len(leaves) != 4 or repr(again) != repr(got[0]):
        raise AssertionError(f'deep-head state round trip: {leaves}')
    pred = JointPredictor(model, YOLOV2_ANCHORS, LABELS_MOT17,
                          net_size=(net, net), device=device, **kwargs)
    want = [pred.predict_batch(as_served(frames, device))
            for _ in range(3)]
    record = {'net': net, 'width_div': 8, 'convlstm_layers': DEEP_LAYERS,
              'export_s': export_s / 1e3, 'artifact_mb': len(art) / 1e6,
              'state_leaves': leaves, 'nms_launches': launches,
              'reset_equals_first_call': True,
              'max_abs_diff_vs_joint_predictor': same_served(got, want)}
    return record, start_reload(art, [frames] * 3, tmp, device), got


# ------------------------------------------------------------ parallel paths
MOE = dict(moe_experts=4, moe_hidden=256)   # JointConfig's hidden width
MOE_CAPACITY_FACTOR = 1.25                  # MoEGridHead's default
PROFILED_STEPS = 2


def moe_head_ms(model, call) -> dict:
    """The MoE head's device time on its input of one predict call (CUDA
    events), beside the call's; the head's input is captured by a hook."""
    seen = []
    hook = model.tconv_moe.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].detach()))
    try:
        call()
    finally:
        hook.remove()
    z = seen[-1]
    with torch.no_grad():
        head = cuda_ms(lambda: model.tconv_moe(z), 5)
        kernels = device_times(lambda: model.tconv_moe(z), 2)
    tokens = z.numel() // z.shape[-1]
    return {'tokens': tokens,
            'capacity': moe_capacity(tokens, MOE['moe_experts'],
                                     MOE_CAPACITY_FACTOR),
            'head_ms': head, 'head_kernels': breakdown(kernels, head)}


def host_top(fn, n: int = 8) -> list:
    """The `n` costliest host ops and CUDA runtime calls of one fn() by
    self CPU time under torch.profiler: [[name, count, self ms], ...]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:n]
    return [[e.key[:70], e.count, e.self_cpu_time_total / 1e3]
            for e in rows]


def forward_syncs(model, clips, device) -> dict:
    """One no-grad forward of `model` on `clips` under sync-debug mode
    'error': 'none', or the port's innermost frame that synced the host;
    and the host's time to enqueue one forward (host_us, in ms)."""
    import traceback
    x = torch.from_numpy(clips).to(device)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            model(x, train=True)
            where = 'none'
        except RuntimeError as e:
            frames = [f for f in traceback.extract_tb(e.__traceback__)
                      if 'object_tracking_tpu_torch' in f.filename]
            where = (f'{Path(frames[-1].filename).name}:{frames[-1].lineno} '
                     f'{frames[-1].line}' if frames else repr(e)[:200])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        enqueue_ms = host_us(lambda: model(x, train=True), 5) / 1e3
    return {'sync_in_forward': where, 'forward_enqueue_ms': enqueue_ms}


def moe_predict(device) -> dict:
    """The MoE head at bench.py's model: three B=8 predict_batch and three
    B=1 predict_window calls, kernel 1 once per call and equal to
    nms_impl='sort'; frames/s at B=1 and B=8 beside the dense head's in
    this process (median of SHORT_SAMPLES samples, all kept); each call's
    device time and the MoE head's share of it."""
    model = joint_model(device, **MOE)
    rng = np.random.RandomState(3)
    batch_reqs = requests(rng, 8, 3)
    window_reqs = requests(rng, 1, 3)
    obj_threshold = pick_obj_threshold(model, batch_reqs[0], device)
    kwargs = dict(labels=LABELS_MOT17, obj_threshold=obj_threshold,
                  nms_threshold=NMS_THRESHOLD, net_size=(NET, NET),
                  device=device)
    torch.backends.cudnn.deterministic = True    # both runs: same netouts
    try:
        cuda_nms.nms_scores.launches = 0
        results, calls = serve(JointPredictor(model, YOLOV2_ANCHORS,
                                              **kwargs),
                               batch_reqs, window_reqs)
        launches = cuda_nms.nms_scores.launches
        if launches != calls:
            raise AssertionError(f'MoE head: nms_scores launched {launches} '
                                 f'times in {calls} predict calls')
        sort_results, _ = serve(JointPredictor(model, YOLOV2_ANCHORS,
                                               nms_impl='sort', **kwargs),
                                batch_reqs, window_reqs)
    finally:
        torch.backends.cudnn.deterministic = False
    if sort_results != results:
        raise AssertionError("MoE head: impl='kernel' and 'sort' disagree")
    out = {'obj_threshold': obj_threshold, 'predict_calls': calls,
           'nms_launches': launches, 'kernel_equals_sort': True,
           **check_results(results, obj_threshold)}
    rates, profiles = {}, {}
    for head, m in (('dense', joint_model(device)), ('moe', model)):
        pred = JointPredictor(m, YOLOV2_ANCHORS, **kwargs)
        for batch, clips in ((8, batch_reqs[0]), (1, window_reqs[0])):
            key = f'{head}_b{batch}_float32'
            median = put_rate(rates, f'fps_{key}',
                              fps(pred, clips, 5 if batch > 1 else 10,
                                  batch > 1, SHORT_SAMPLES))
            call = (lambda c=clips, p=pred: p.predict_batch(c)) \
                if batch > 1 else \
                (lambda c=clips, p=pred: p.predict_window(c[0]))
            profiles[key] = breakdown(device_times(call, 2, m),
                                      1e3 * batch * T / median)
            if batch > 1:
                profiles[key]['host_top'] = host_top(call)
                profiles[key].update(forward_syncs(m, clips, device))
            if head == 'moe':
                share = moe_head_ms(m, call)
                busy = profiles[key].get('device_busy_ms')
                share['share_of_call_device_ms'] = (
                    share['head_ms'] / busy if busy else 'not measured')
                profiles[key]['moe_head'] = share
    return {**out, **rates, 'profiles': profiles}


def moe_training(device) -> dict:
    """Fused train steps of the MoE model at B=4 in float32 and bfloat16
    (flax-like init from seed 0, augmentation on): the first step's
    moe_aux finite and > 0 and its loss finite; then steps/s, the step's
    device profile and peak memory (train_readings, lr 0), beside the
    dense head's float32 step in this process."""
    step = train_step_fn(NET, augment=True)
    batches = [train_batch(300 + i, 4) for i in range(4)]
    readings, first = {}, {}
    for name, dtype, model_kw in (('float32', torch.float32, MOE),
                                  ('bfloat16', torch.bfloat16, MOE),
                                  ('dense_float32', torch.float32, {})):
        state = train_state(device, dtype=dtype, **model_kw)
        _, metrics = step(state, batches[0])
        got = {k: float(metrics[k]) for k in ('loss', 'moe_aux')}
        if not np.isfinite(list(got.values())).all() or (
                model_kw and not got['moe_aux'] > 0):
            raise AssertionError(f'MoE step {name}: {got}')
        first[name] = got
        state.with_learning_rate(0.0)
        train_readings(state, step, batches, f'b4_{name}', readings)
        del state
        gc.collect()
    return {'first_step': first, 'readings': readings}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def nccl_world_of_one(device) -> dict:
    """A process group of one rank over NCCL (tcp to localhost), the
    (1, 1) mesh over it, and on the card: a data-parallel fused step
    (BatchNorm sums, loss counts, metrics and gradients all-reduced over
    the group of one) against the plain step on the same weights and
    batch; expert_parallel_moe with one expert against moe_apply at the
    full-width head's tokens; pipeline_scan with one stage (a pipelined
    1-layer StackedConvLSTM) against the sequential stack. The group is
    destroyed afterwards. A failed NCCL init raises."""
    from object_tracking_tpu_torch.config import MeshConfig
    from object_tracking_tpu_torch.models.convlstm import StackedConvLSTM
    from object_tracking_tpu_torch.parallel import (
        distributed_init, expert_parallel_moe, init_moe_params, make_mesh,
        moe_apply)
    import torch.distributed as dist
    config = MeshConfig(distributed=True, num_processes=1, process_id=0,
                        coordinator_address=f'localhost:{free_port()}')
    distributed_init(config, device)
    try:
        backend = dist.get_backend()
        if backend != ('nccl' if device.type == 'cuda' else 'gloo'):
            raise AssertionError(f'backend {backend} on {device}')
        mesh = make_mesh(MeshConfig())
        out = {'backend': backend, 'world_size': dist.get_world_size(),
               'mesh': mesh.shape}
        if mesh.shape != {'data': 1, 'model': 1}:
            raise AssertionError(f'mesh {mesh.shape}')

        # data-parallel step vs the plain step (reduced cut, float32)
        net = 128
        raw = train_batch(7, 2, net=net, objects=4)
        plain = train_state(device, width_div=8)
        dp_model = init_like_flax(MultiObjDetTracker(
            num_classes=NUM_CLASSES, num_anchors=5, convlstm_features=64,
            width_div=8, mesh=mesh), 0).to(device)
        dp_model.load_state_dict(plain.model.state_dict())
        dp = TrainState.create(dp_model, make_optimizer(TRAIN_LR))
        _, m_plain = train_step_fn(net, False)(plain, raw)
        _, m_dp = make_joint_train_step_fused(
            YOLOV2_ANCHORS, augment=False, net_h=net, net_w=net,
            grid_h=net // 32, grid_w=net // 32, num_classes=NUM_CLASSES,
            true_box_buffer=MAX_BOXES, mesh=mesh)(dp, raw)
        torch.cuda.synchronize()
        pp = dict(plain.model.named_parameters())
        dpp = dict(dp.model.named_parameters())
        diffs = {
            'metrics_max_rel': max(abs(float(m_dp[k]) - float(m_plain[k]))
                                   / max(abs(float(m_plain[k])), 1e-30)
                                   for k in m_plain),
            'grads_rel_l2_max': max(rel_l2(dpp[n].grad, p.grad)
                                    for n, p in pp.items()),
            'params_rel_l2_max': max(rel_l2(dpp[n].detach(), p.detach())
                                     for n, p in pp.items())}
        zero = all(v == 0 for v in diffs.values())
        out['dp_step_vs_plain'] = {
            **diffs, 'zero': zero,
            'tolerance': {'metrics_rtol': METRIC_RTOL, 'rel_l2': LEAF_TOL}}
        if not zero:
            out['dp_step_vs_plain']['why_not_zero'] = (
                'BatchNorm under a data group normalises by sum / count, '
                'the plain one by mean(): float32 rounding (the sum over a '
                'group of one is exact)')
        if (diffs['metrics_max_rel'] > METRIC_RTOL
                or diffs['grads_rel_l2_max'] > LEAF_TOL
                or diffs['params_rel_l2_max'] > LEAF_TOL):
            raise AssertionError(f'dp step vs plain: {diffs}')
        del plain, dp, dp_model
        gc.collect()

        # expert parallelism with one expert vs the dense MoE
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_moe_params(gen, 1, 512, MOE['moe_hidden'],
                                 5 * (5 + NUM_CLASSES), device=device)
        tokens = torch.randn(8 * T * 13 * 13, 512, generator=gen,
                             device=device)
        with torch.no_grad():
            ep = expert_parallel_moe(params, tokens, mesh, 'model')
            dense = moe_apply(params, tokens)
        torch.cuda.synchronize()
        ep_diff = float((ep - dense).abs().max())
        out['ep_vs_moe_apply'] = {'tokens': tokens.shape[0],
                                  'max_abs_diff': ep_diff,
                                  'scale': float(dense.abs().max()),
                                  'tolerance': 1e-5}
        if ep_diff > 1e-5 * max(1.0, float(dense.abs().max())):
            raise AssertionError(f'EP vs moe_apply: {ep_diff}')

        # one pipeline stage vs the sequential stack
        torch.manual_seed(4)
        seq = StackedConvLSTM(512, 1).to(device)
        piped = StackedConvLSTM(512, 1, pipeline=True, mesh=mesh).to(device)
        piped.load_state_dict(seq.state_dict())
        x = torch.randn(1, T, 512, 13, 13, device=device)
        with torch.no_grad():
            a, b = piped(x), seq(x)
        torch.cuda.synchronize()
        pp_diff = float((a - b).abs().max())
        out['pipeline_vs_sequential'] = {'max_abs_diff': pp_diff,
                                         'tolerance': 1e-4}
        if pp_diff:
            out['pipeline_vs_sequential']['why_not_zero'] = (
                'the stage projects each step alone, the sequential stack '
                'all T steps in one conv')
        if pp_diff > 1e-4:
            raise AssertionError(f'pipeline vs sequential: {pp_diff}')
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def profiling_check(device) -> dict:
    """profile_trace around two fused steps (reduced cut), each inside a
    span: the trace file holds CUDA kernel events, the spans' ranges
    (`ott.fused_step_<i>`) and the step's own (`ott.train` and its seven
    parts);
    device_memory_stats() is not empty. A trace without device events
    raises."""
    from object_tracking_tpu_torch.utils.profiling import (
        device_memory_stats, profile_trace, span)
    net = 128
    state = train_state(device, width_div=8, **MOE)
    step = train_step_fn(net, augment=True)
    raws = [train_batch(40 + i, 2, net=net, objects=4)
            for i in range(PROFILED_STEPS)]
    step(state, raws[0])
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp):
            for i, raw in enumerate(raws):
                with span(f'fused_step_{i}'):
                    step(state, raw)
        files = list(Path(tmp).glob('*.pt.trace.json'))
        if len(files) != 1:
            raise AssertionError(f'profile_trace wrote {files}')
        size = files[0].stat().st_size
        with open(files[0]) as f:
            events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    ranges = {e.get('name') for e in events
              if str(e.get('name', '')).startswith('ott.fused_step_')}
    train = {e.get('name') for e in events} & {
        'ott.' + n for n in ('train', 'to_device', 'augment', 'targets',
                             'forward', 'loss', 'backward', 'optimizer')}
    stats = device_memory_stats()
    out = {'trace_bytes': size, 'events': len(events),
           'cuda_kernel_events': len(kernels),
           'span_ranges': sorted(ranges), 'train_ranges': sorted(train),
           'device_memory_stats': [{
               k: s.get(k) for k in ('allocated_bytes.all.peak',
                                     'reserved_bytes.all.peak')}
               for s in stats]}
    if not kernels or len(ranges) != PROFILED_STEPS or len(train) != 8 \
            or not stats or not stats[0]:
        raise AssertionError(f'profiling: {out}')
    return out


def parallel_phase(device, smi: str) -> dict:
    """The MoE head and the parallel paths on the card."""
    out = {'phase': 'parallel', 'net': NET, 'T': T,
           'classes': NUM_CLASSES, 'convlstm_features': 512,
           'width_div': 1, **MOE, 'capacity_factor': MOE_CAPACITY_FACTOR,
           'card': smi}
    out['moe_predict'] = moe_predict(device)
    out['moe_train'] = moe_training(device)
    out['moe_card_vs_cpu'] = card_matches_cpu(device, moe_experts=4,
                                              moe_hidden=32)
    out['nccl_world_of_one'] = nccl_world_of_one(device)
    out['profiling'] = profiling_check(device)
    return out


# ------------------------------------------------------------ native data
NATIVE_SCENES = tuple(FIXTURES / f'scene_{i}.jpg' for i in range(4))
NATIVE_MEAN_TOL = 0.02   # tests/test_native_loader.py's JPEG bound: mean
#                          |native − cv2| in [0, 1] (the IDCTs differ)
NATIVE_NMS_TOL = 1e-6    # tests/test_native_loader.py's, against the op


def native_data_phase(device, smi: str) -> dict:
    """The native data runtime's binding (data/native_loader.py): its
    build seconds, or the compiler's words where it cannot build. Where it
    builds: the four golden scenes decoded by load_batch_u8 at 160²
    against golden_scenes_160.npz (cv2's decode of the same files);
    load_batch equal to load_image per file; CfgDetector on the micro
    fixture detecting the natively decoded scenes as golden_boxes.json
    pins them, with mAP@0.5 (kernel 1 once); the host NMS against kernel
    1 and against its plain twin on seeded candidates at the joint path's
    shape (32, 128, 12)."""
    from object_tracking_tpu_torch.data import native_loader
    start = time.perf_counter()
    available = native_loader.available()
    out = {'phase': 'native_data', 'available': available,
           'build_s': time.perf_counter() - start, 'card': smi}
    if not available:
        out['build_error'] = native_loader.build_error
        return out
    out['library'] = native_loader.library_path().name
    files = [str(f) for f in NATIVE_SCENES]
    scenes = np.load(FIXTURES / 'golden_scenes_160.npz')
    if [str(f) for f in scenes['files']] != [f.name for f in NATIVE_SCENES]:
        raise AssertionError('golden scenes out of order')
    u8 = native_loader.load_batch_u8(files, 160, 160, n_threads=2)
    diff = np.abs(u8.astype(np.float32)
                  - scenes['images'].astype(np.float32)) / 255.0
    out['decode_vs_cv2'] = {'mean_abs_diff': float(diff.mean()),
                            'max_abs_diff': float(diff.max()),
                            'tolerance_mean': NATIVE_MEAN_TOL}
    if diff.mean() >= NATIVE_MEAN_TOL:
        raise AssertionError(f'native decode vs cv2: {out["decode_vs_cv2"]}')
    images = native_loader.load_batch(files, 160, 160, n_threads=2)
    if not np.array_equal(images, np.stack(
            [native_loader.load_image(f, 160, 160) for f in files])):
        raise AssertionError('load_batch differs from load_image')
    out['load_batch_equals_load_image'] = True

    golden = json.loads((FIXTURES / 'golden_boxes.json').read_text())
    detector = CfgDetector(str(FIXTURES / golden['cfg']),
                           weights_path=str(FIXTURES / golden['weights']),
                           labels=tuple(golden['labels']), device=device)
    cuda_nms.nms_scores.launches = 0
    dets = detector.detect_images(images)
    launches = cuda_nms.nms_scores.launches
    if launches != 1:
        raise AssertionError(f'nms_scores launched {launches} times in 1 '
                             'detect_images call')
    out['cfg_detector'] = {**check_golden('CfgDetector', dets, golden, 160,
                                          0.0), 'nms_launches': launches}

    frames, k, c = NMS_PATH_SHAPES[0]
    boxes, scores = candidates(np.random.RandomState(11), frames, k, c)
    host = np.stack([native_loader.nms_scores(boxes[f], scores[f],
                                              NMS_THRESHOLD)
                     for f in range(frames)])
    b, sc = torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(
        device)
    kernel = cuda_nms.nms_scores(b, sc, NMS_THRESHOLD).cpu().numpy()
    plain = cuda_nms.nms_scores_plain(b, sc, NMS_THRESHOLD).cpu().numpy()
    out['host_nms'] = {
        'shape': [frames, k, c],
        'vs_kernel_max_abs_diff': float(np.abs(host - kernel).max()),
        'vs_plain_max_abs_diff': float(np.abs(host - plain).max()),
        'suppressed': int(((scores > 0) & (host == 0)).sum()),
        'tolerance': NATIVE_NMS_TOL}
    if (out['host_nms']['vs_kernel_max_abs_diff'] > NATIVE_NMS_TOL
            or out['host_nms']['vs_plain_max_abs_diff'] > NATIVE_NMS_TOL
            or not out['host_nms']['suppressed']):
        raise AssertionError(f'host NMS: {out["host_nms"]}')
    return out


# ------------------------------------------------------ tensor parallelism
TP_RANKS = 2             # both on cuda:0: NCCL refuses two ranks a device
TP_NET = 128             # the train phase's reduced cut
TP_MIN_PARAMS = 1 << 8   # the dry run's
TP_TIMEOUT_S = 300
TP_COS, TP_RATIO, TP_LOSS = 0.999, 0.05, 1e-2   # the dry run's bars
COLUMN_TOL = 1e-4        # column-parallel conv: max |blocks − dense| over
#                          max |dense| (a wrong block is O(1) off)


def _tp_model(mesh=None):
    return MultiObjDetTracker(num_classes=NUM_CLASSES, num_anchors=5,
                              convlstm_features=64, width_div=8, mesh=mesh)


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _two_steps(state, step, raw, model, gather) -> dict:
    """Two fused steps: both steps' metrics, the first's gradients and
    parameters, the second's state, all dense (through `gather`) and on
    the host."""
    def host(tensors):
        return {k: v.detach().to('cpu', copy=True) for k, v in
                tensors.items()}
    out = {'metrics': []}
    for i in range(2):
        state, metrics = step(state, raw)
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out['grads'] = host(gather(model, {
                k: p.grad for k, p in model.named_parameters()}))
            out['step1'] = host(gather(model))
    out['step2'] = host(gather(model))
    return out


def tp_rank(rank: int, n: int, out_dir: str, device: str) -> None:
    """One rank of the tensor_parallel phase's gloo world, on `device`
    (cuda:0 for every rank): the reduced joint model, from the weights and
    batch in out_dir, sharded over a (1, n) mesh, two fused steps. Every
    rank writes what it holds (rank 0 its run too) to out_dir, or its
    traceback."""
    import pickle
    import traceback
    import torch.distributed as dist
    from object_tracking_tpu_torch.config import MeshConfig
    from object_tracking_tpu_torch.parallel import (
        gather_dense, make_mesh, shard_variables)
    entered = time.time()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device(device)
        with open(Path(out_dir) / 'inputs.pkl', 'rb') as f:
            weights, raw = pickle.load(f)
        dist.init_process_group('gloo',
                                init_method=f'file://{out_dir}/store',
                                world_size=n, rank=rank)
        mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=n))
        model = _tp_model(mesh)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
        model.to(device)
        dense_bytes = _param_bytes(model)
        shard_variables(mesh, model, min_params=TP_MIN_PARAMS)
        state = TrainState.create(model, make_optimizer(TRAIN_LR))
        step = make_joint_train_step_fused(
            YOLOV2_ANCHORS, augment=False, net_h=TP_NET, net_w=TP_NET,
            grid_h=TP_NET // 32, grid_w=TP_NET // 32,
            num_classes=NUM_CLASSES, true_box_buffer=MAX_BOXES, mesh=mesh)
        ready = time.time()
        run = _two_steps(state, step, raw, model, gather_dense)
        steps_s = time.time() - ready
        column = column_conv_rank(mesh, rank, device)
        result = {'bytes': _param_bytes(model),
                  'entered_at': entered, 'setup_s': ready - entered,
                  'steps_s': steps_s, 'column_conv': column,
                  'dense_bytes': dense_bytes,
                  'held': {k: tuple(p.shape)
                           for k, p in model.named_parameters()},
                  'run': run if rank == 0 else None}
        dist.destroy_process_group()
        kind = 'ok'
    except BaseException:
        result, kind = traceback.format_exc(), 'error'
    with open(Path(out_dir) / f'rank{rank}.pkl', 'wb') as f:
        pickle.dump((kind, result), f)


def tp_world(weights: dict, raw: dict, device) -> list:
    """tp_rank on TP_RANKS spawned processes; every process is joined (or
    killed at TP_TIMEOUT_S) before this returns or raises. The inputs go
    through a file: a large argument would hold each start until the
    previous child had imported this script and read it."""
    import pickle
    ctx = torch.multiprocessing.get_context('spawn')
    started = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        with open(Path(tmp) / 'inputs.pkl', 'wb') as f:
            pickle.dump((weights, raw), f)
        procs = [ctx.Process(target=tp_rank,
                             args=(r, TP_RANKS, tmp, str(device)))
                 for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        if alive:
            raise AssertionError(f'tensor_parallel: {len(alive)} ranks still '
                                 f'running after {TP_TIMEOUT_S} s: killed')
        results = []
        for r in range(TP_RANKS):
            path = Path(tmp) / f'rank{r}.pkl'
            if not path.exists():
                raise AssertionError(f'tensor_parallel: rank {r} exited with '
                                     f'{procs[r].exitcode} and no result')
            with open(path, 'rb') as f:
                kind, value = pickle.load(f)
            if kind != 'ok':
                raise AssertionError(f'tensor_parallel rank {r}:\n{value}')
            value['started_s'] = value.pop('entered_at') - started
            results.append(value)
    return results


def _update(params: dict, weights: dict) -> torch.Tensor:
    return torch.cat([(params[k].double() - weights[k].double()).reshape(-1)
                      for k in sorted(params)])


def host_ms(fn, iters: int) -> float:
    """ms a call of fn(), host clock, synchronised at both ends, after 2
    warm-up calls (a path through gloo waits on the host)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - start) / iters


def column_conv_rank(mesh, rank: int, device) -> dict:
    """tconv_lstm's input projection at full width (85 + 1024 → 2048
    channels, 3x3) on the joint path's B·T = 32 frames of 13x13, run by
    the port's conv (`models.darknet19.conv`) dense, then sharded by
    `shard_variables` over the model axis, where it computes this rank's
    block of output channels and gathers the rest. The dense call is
    timed on rank 0 alone (the other rank waits), the sharded one with
    every rank taking part; host clock."""
    import torch.distributed as dist
    from object_tracking_tpu_torch.models.convlstm import FusedConvLSTM
    from object_tracking_tpu_torch.models.darknet19 import conv
    from object_tracking_tpu_torch.parallel import shard_variables
    cin = 5 * (5 + NUM_CLASSES) + 1024
    lstm = init_like_flax(FusedConvLSTM(cin, 512), 3).to(device)
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (8 * T, cin, 13, 13)).astype(np.float32)).to(device)
    with torch.no_grad():
        dense = conv(x, lstm.input_proj)
        dense_ms = host_ms(lambda: conv(x, lstm.input_proj), 20) \
            if rank == 0 else None
        dist.barrier()
        shard_variables(mesh, lstm)
        got = conv(x, lstm.input_proj)
        torch.cuda.synchronize()
        out = {'x': list(x.shape),
               'weight_held': list(lstm.input_proj.weight.shape),
               'bias_held': list(lstm.input_proj.bias.shape),
               'max_abs_diff': float((got - dense).abs().max()),
               'scale': float(dense.abs().max()),
               'dense_ms': dense_ms,
               'blocks_ms': host_ms(lambda: conv(x, lstm.input_proj), 20)}
    return out


def tensor_parallel_phase(device, smi: str) -> dict:
    """The fused joint step under dp x tp = 1 x 2 on the card (two gloo
    ranks on cuda:0) against the dense step on the card, at the train
    phase's reduced cut (width_div=8, 128², T=4, B=2, no augmentation,
    min_params 1 << 8, the same weights and batch): the first step's
    metrics, every gathered gradient and parameter (relative L2), the
    two-step update (cosine, norm ratio, loss: the dry run's bars), the
    plan's summary, each rank's parameter bytes against the dense model's.
    In the same world, one full-width conv sharded by column against the
    dense conv; then the gathered TP-trained weights served through
    JointPredictor."""
    from object_tracking_tpu_torch.parallel import (
        Mesh, plan_tp_specs, tp_sharding_summary)
    start = time.perf_counter()
    raw = train_batch(7, 2, net=TP_NET, objects=4)
    initial = init_like_flax(_tp_model(), 0).state_dict()
    weights = {k: v.numpy() for k, v in initial.items()}
    dense_model = _tp_model()
    dense_model.load_state_dict(initial)
    dense_model.to(device)
    dense = _two_steps(
        TrainState.create(dense_model, make_optimizer(TRAIN_LR)),
        train_step_fn(TP_NET, False), raw, dense_model,
        lambda model, tensors=None: dict(
            model.state_dict() if tensors is None else tensors))
    del dense_model
    gc.collect()
    torch.cuda.empty_cache()

    ranks = tp_world(weights, raw, device)
    run = ranks[0]['run']
    m_tp, m_dense = run['metrics'][0], dense['metrics'][0]
    errors = {
        'metrics_max_rel': max(abs(m_tp[k] - v) / max(abs(v), 1e-30)
                               for k, v in m_dense.items() if v),
        'metrics_out_of_tol': [
            k for k, v in m_dense.items()
            if abs(m_tp[k] - v) > METRIC_ATOL + METRIC_RTOL * abs(v)],
        'grads_rel_l2_max': max(rel_l2(run['grads'][k], v)
                                for k, v in dense['grads'].items()),
        'step1_rel_l2_max': max(rel_l2(run['step1'][k], v)
                                for k, v in dense['step1'].items())}
    names = sorted(dense['grads'])
    w0 = {k: initial[k] for k in names}
    d = _update({k: run['step2'][k] for k in names}, w0)
    d_ref = _update({k: dense['step2'][k] for k in names}, w0)
    update = {'cosine': float(d @ d_ref / (d.norm() * d_ref.norm())),
              'norm_ratio': float(d.norm() / d_ref.norm()),
              'loss': m_tp['loss'], 'dense_loss': m_dense['loss']}
    mesh = Mesh({'data': 1, 'model': TP_RANKS})
    plan = plan_tp_specs(initial, mesh, min_params=TP_MIN_PARAMS)
    split = [k for k, axis in plan.items() if axis is not None]
    for r in ranks:
        for k in split:
            if r['held'][k][plan[k]] * TP_RANKS != weights[k].shape[plan[k]]:
                raise AssertionError(f'{k}: held {r["held"][k]}')
    out = {'phase': 'tensor_parallel', 'net': TP_NET, 'T': T, 'batch': 2,
           'classes': NUM_CLASSES, 'convlstm_features': 64, 'width_div': 8,
           'mesh': {'data': 1, 'model': TP_RANKS},
           'device_per_rank': str(device),
           'collectives': 'gloo, on the CUDA tensors',
           'rank_seconds': [{k: r[k] for k in ('started_s', 'setup_s',
                                               'steps_s')} for r in ranks],
           'min_params': TP_MIN_PARAMS,
           'summary': tp_sharding_summary(initial, mesh,
                                          min_params=TP_MIN_PARAMS),
           'param_bytes': {'dense': ranks[0]['dense_bytes'],
                           'ranks': [r['bytes'] for r in ranks]},
           'sharded_leaves_hold_1_over_tp': len(split),
           'tp_vs_dense': {**errors, 'update': update,
                           'tolerance': {'metrics_rtol': METRIC_RTOL,
                                         'metrics_atol': METRIC_ATOL,
                                         'rel_l2': LEAF_TOL,
                                         'cosine': TP_COS,
                                         'norm_ratio': TP_RATIO,
                                         'loss': TP_LOSS}}}
    if (errors['metrics_out_of_tol']
            or errors['grads_rel_l2_max'] > LEAF_TOL
            or errors['step1_rel_l2_max'] > LEAF_TOL
            or update['cosine'] < TP_COS
            or abs(update['norm_ratio'] - 1.0) > TP_RATIO
            or abs(update['loss'] - update['dense_loss'])
            > TP_LOSS * (1 + abs(update['dense_loss']))
            or max(out['param_bytes']['ranks'])
            >= out['param_bytes']['dense']):
        raise AssertionError(f'tensor parallel vs dense: {out}')
    column = {**ranks[0]['column_conv'], 'blocks': TP_RANKS,
              'tolerance_over_scale': COLUMN_TOL,
              'rank_max_abs_diff': [r['column_conv']['max_abs_diff']
                                    for r in ranks]}
    if (max(column['rank_max_abs_diff']) > COLUMN_TOL * column['scale']
            or column['weight_held'][0] * TP_RANKS != 4 * 512
            or column['bias_held'] != [4 * 512 // TP_RANKS]):
        raise AssertionError(f'column-parallel conv: {column}')
    out['column_conv'] = column
    out['world_s'] = time.perf_counter() - start

    served = _tp_model()
    served.load_state_dict(run['step2'])
    out['serve'] = serve_trained(served.to(device), device, net=TP_NET)
    out['phase_s'] = time.perf_counter() - start
    out['card'] = smi
    return out


# ------------------------------------------------ data-parallel flows
DP_RANKS = 2             # gloo ranks on cuda:0: NCCL refuses two a device
DP_TIMEOUT_S = 420
DP_DET_B = 8             # the detector step's global batch
DP_TINY_B = 4            # TrainConfig.batch_size, over T=4 of 13x13x1024
DP_MOE_NET = 128         # the MoE repair at the train phase's reduced cut
DP_MOE_B = 3             # ragged on 2 ranks: shard_batch replicates it
DP_FLOW_FRAMES = 11      # one video: 8 windows of T=4, two batches of 4
DP_COS, DP_RATIO = 0.999, 0.05   # the CPU tests' two-step bars
# held to the one-rank step in float64: at 416² float32 BatchNorm lies up
# to 6e-3 (relative L2 of a leaf's gradient) from float64 in either layout
DP_REPORTED = ('detector_float32',)
DP_RATE_STEPS = 5
TINY_HEADS = {'bbox_bce': (False, 4), 'heatmap_bce': (True, 32 * 32)}


def randomize_bn(model, seed: int):
    """Every BatchNorm's scale and bias drawn as tests/torch_parity.py's
    randomize_bn draws them (U(0.5, 1.5), N(0, 0.1)), so that Adam's
    first step does not start from zero biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                               + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
    return model


def dp_models() -> dict:
    """name → (make_model(mesh), make_step(mesh), lr): Darknet-19 at
    DetectorConfig() and the detector step, in float64 ('detector') and
    float32; TinyTracker (LSTM-512, Global pool over 13x13x1024) with each
    head of TINY_HEADS and the tiny step; the MoE joint model at the
    reduced cut and its fused step."""
    cfg = DetectorConfig()

    def detector(dtype):
        return lambda mesh=None: randomize_bn(init_like_flax(Darknet19(
            cfg.num_classes, cfg.num_anchors, dtype, mesh=mesh), 0),
            1).to(dtype)

    def tiny(out_dim):
        return lambda mesh=None: init_like_flax(TinyTracker(
            (13, 13, 1024), lstm_units=512, out_dim=out_dim, pool='Global'),
            0)

    def moe(mesh=None):
        return init_like_flax(MultiObjDetTracker(
            num_classes=NUM_CLASSES, num_anchors=5, convlstm_features=64,
            width_div=8, mesh=mesh, **MOE), 0)

    def moe_step(mesh=None):
        return make_joint_train_step_fused(
            YOLOV2_ANCHORS, augment=False, net_h=DP_MOE_NET,
            net_w=DP_MOE_NET, grid_h=DP_MOE_NET // 32,
            grid_w=DP_MOE_NET // 32, num_classes=NUM_CLASSES,
            true_box_buffer=MAX_BOXES, mesh=mesh)

    def detector_step(mesh=None):
        return make_detector_train_step(cfg.anchors, mesh=mesh)

    out = {'detector': (detector(torch.float64), detector_step, DET_LR),
           'detector_float32': (detector(torch.float32), detector_step,
                                DET_LR)}
    for name, (heatmap, out_dim) in TINY_HEADS.items():
        out[name] = (tiny(out_dim), lambda mesh=None, h=heatmap:
                     make_tiny_train_step(h, 'bce', mesh=mesh), TINY_LR)
    out['moe_ragged'] = (moe, moe_step, TRAIN_LR)
    return out


def tiny_batch(seed: int, out_dim: int, heatmap: bool) -> dict:
    """Seeded (B=4, T=4) features of 13x13x1024, detections and targets
    (binary for the heatmap, in [0.2, 0.8] for the box)."""
    rng = np.random.RandomState(seed)
    b, t = DP_TINY_B, TRACK_T
    target = (rng.rand(b, t, out_dim) > 0.9 if heatmap
              else rng.rand(b, t, out_dim) * 0.6 + 0.2)
    return {'feats': rng.rand(b, t, 13, 13, 1024).astype(np.float32),
            'det': rng.rand(b, t, out_dim).astype(np.float32),
            'target': target.astype(np.float32)}


def dp_batches() -> dict:
    """name → two global batches of that case."""
    det = [detection_batch(500 + i, DP_DET_B) for i in range(2)]
    out = {'detector': det, 'detector_float32': det,
           'moe_ragged': [train_batch(510 + i, DP_MOE_B, net=DP_MOE_NET,
                                      objects=4) for i in range(2)]}
    for j, (name, (heatmap, out_dim)) in enumerate(TINY_HEADS.items()):
        out[name] = [tiny_batch(520 + 2 * j + i, out_dim, heatmap)
                     for i in range(2)]
    return out


def _lead(batch) -> int:
    for key in ('images', 'feats', 'images_u8'):
        if key in batch:
            return int(batch[key].shape[0])
    raise KeyError(sorted(batch))


def dp_two_steps(case, batches, device, mesh=None) -> dict:
    """Two train steps of `case` (from dp_models) on this rank's slice of
    each global batch (shard_batch over `mesh`; the whole batch without):
    each step's metrics and batch size and whether it was replicated, the
    first step's gradients and the initial and final parameters (on the
    host), and each parameter's float64 sum."""
    from object_tracking_tpu_torch.parallel import is_replicated, shard_batch
    make_model, make_step, lr = case
    model = make_model(mesh).to(device)
    state = TrainState.create(model, make_optimizer(lr))
    step = make_step(mesh)
    out = {'metrics': [], 'local_batch': [], 'replicated': [],
           'initial': {k: p.detach().cpu().clone()
                       for k, p in model.named_parameters()}}
    for i, batch in enumerate(batches):
        mine = batch if mesh is None else shard_batch(mesh, batch)
        out['local_batch'].append(_lead(mine))
        out['replicated'].append(is_replicated(mine))
        state, metrics = step(state, mine)
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out['grads'] = {k: p.grad.detach().cpu()
                            for k, p in model.named_parameters()}
    out['params'] = {k: p.detach().cpu() for k, p in
                     model.named_parameters()}
    out['initial_sums'] = [float(p.double().sum())
                           for p in out['initial'].values()]
    out['sums'] = [float(p.detach().double().sum())
                   for p in model.parameters()]
    return out


def dp_errors(got: dict, ref: dict) -> dict:
    """The first step's metrics (rtol 1e-4) and gradients (relative L2
    per leaf) and the two-step update (cosine, norm ratio) of `got`
    against `ref`, both from the same weights (`same_start`); `ok`
    whether every bar holds."""
    m1, r1 = got['metrics'][0], ref['metrics'][0]
    names = sorted(ref['params'])
    d = _update({k: got['params'][k] for k in names}, ref['initial'])
    d_ref = _update(ref['params'], ref['initial'])
    out = {'metrics_max_rel': max(abs(m1[k] - v) / max(abs(v), 1e-30)
                                  for k, v in r1.items()),
           'metrics_out_of_tol': [
               k for k, v in r1.items()
               if abs(m1[k] - v) > METRIC_ATOL + METRIC_RTOL * abs(v)],
           'grads_rel_l2_max': max(rel_l2(got['grads'][k], v)
                                   for k, v in ref['grads'].items()),
           'update_cosine': float(d @ d_ref / (d.norm() * d_ref.norm())),
           'update_norm_ratio': float(d.norm() / d_ref.norm()),
           'same_start': got['initial_sums'] == ref['initial_sums']}
    out['ok'] = (out['same_start'] and not out['metrics_out_of_tol']
                 and out['grads_rel_l2_max'] <= LEAF_TOL
                 and out['update_cosine'] > DP_COS
                 and abs(out['update_norm_ratio'] - 1.0) < DP_RATIO)
    return out


def dp_flow_data():
    """One seeded video of DP_FLOW_FRAMES frames at 416² (tracker_folder's
    first), its objects labelled '1', the synthetic flow's label."""
    frames, anns = tracker_folder(7)
    keep = sorted(frames)[:DP_FLOW_FRAMES]
    anns = [a for a in anns if a.filename in keep]
    for a in anns:
        a.objects[0].label = '1'
    return {k: frames[k] for k in keep}, anns


@contextlib.contextmanager
def flow_on_arrays(frames: dict, anns: list, spy: dict):
    """single_object_tracking's dataset I/O on arrays (the card's machine
    has no cv2 and no libjpeg): `_synthetic_dirs` writes nothing,
    `parse_annotation_dir` returns `anns` and TrackerSequenceBatches
    reads `frames` by path. A spy on its train step keeps the parameters
    before the first step and each step's batch size and replication."""
    import functools
    from object_tracking_tpu_torch import data, trainer, training
    from object_tracking_tpu_torch.parallel import is_replicated
    saved = (trainer._synthetic_dirs, data.parse_annotation_dir,
             data.TrackerSequenceBatches, training.make_tiny_train_step)

    def make_step(*args, **kw):
        step = saved[3](*args, **kw)

        def run(state, batch):
            spy.setdefault('initial', {
                k: p.detach().cpu().clone()
                for k, p in state.model.named_parameters()})
            spy.setdefault('local_batch', []).append(_lead(batch))
            spy.setdefault('replicated', []).append(is_replicated(batch))
            return step(state, batch)
        return run

    trainer._synthetic_dirs = lambda cfg, *args, **kw: cfg
    data.parse_annotation_dir = lambda *args, **kw: (list(anns), {})
    data.TrackerSequenceBatches = functools.partial(
        TrackerSequenceBatches, loader=frames.__getitem__)
    training.make_tiny_train_step = make_step
    try:
        yield
    finally:
        (trainer._synthetic_dirs, data.parse_annotation_dir,
         data.TrackerSequenceBatches, training.make_tiny_train_step) = saved


def dp_flow(device, workdir: str, rank: int = 0, n: int = 1) -> dict:
    """single_object_tracking(synthetic=True), one epoch, over the
    full-width YOLOv2 prior (seed 0, BatchNorm statistics from the
    video's first 8 frames), on this rank of an n-rank world whose
    process group is up (n > 1), or alone. Kernel 1 runs in the prior;
    its launches are counted from 0 over the flow."""
    from object_tracking_tpu_torch import trainer
    from object_tracking_tpu_torch.config import Config
    frames, anns = dp_flow_data()
    cfg = Config()
    cfg.detector = DetectorConfig(image_h=NET, image_w=NET,
                                  grid_h=NET // 32, grid_w=NET // 32)
    prior = YOLOv2Detector(cfg.detector, seed=0, device=device)
    calibrate_bn(prior.model, torch.from_numpy(
        np.stack([frames[k] for k in sorted(frames)[:8]])).to(device))
    if n > 1:
        cfg.mesh.distributed = True
        cfg.mesh.num_processes, cfg.mesh.process_id = n, rank
        cfg.mesh.data_parallel = n
    spy = {}
    with flow_on_arrays(frames, anns, spy):
        cuda_nms.nms_scores.launches = 0
        start = time.perf_counter()
        state = trainer.single_object_tracking(
            cfg, synthetic=True, epochs=1, workdir=workdir, detector=prior,
            device=device)
        torch.cuda.synchronize()
        spy['seconds'] = time.perf_counter() - start
        spy['nms_launches'] = cuda_nms.nms_scores.launches
    spy['step'] = state.step
    spy['params'] = {k: p.detach().cpu() for k, p in
                     state.model.named_parameters()}
    spy['sums'] = [float(p.detach().double().sum())
                   for p in state.model.parameters()]
    return spy


def dp_rank(rank: int, n: int, out_dir: str, device: str) -> None:
    """One rank of the data_parallel_flows phase's gloo world on `device`
    (cuda:0 for every rank), mesh dp = n: every case of dp_models two
    steps on its slice of the global batches, then the single-object flow.
    Writes its results (rank 0 the steps' whole) or its traceback."""
    import pickle
    import traceback
    import torch.distributed as dist
    from object_tracking_tpu_torch.config import MeshConfig
    from object_tracking_tpu_torch.parallel import make_mesh
    entered = time.time()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device(device)
        with open(Path(out_dir) / 'batches.pkl', 'rb') as f:
            batches = pickle.load(f)
        dist.init_process_group('gloo',
                                init_method=f'file://{out_dir}/store',
                                world_size=n, rank=rank)
        mesh = make_mesh(MeshConfig(data_parallel=n))
        ready = time.time()
        steps = {}
        for name, case in dp_models().items():
            got = dp_two_steps(case, batches[name], device, mesh)
            del got['initial']
            if rank:
                got = {k: got[k] for k in ('metrics', 'local_batch',
                                           'replicated', 'sums')}
            steps[name] = got
        steps_s = time.time() - ready
        flow = dp_flow(device, str(Path(out_dir) / 'flow'), rank, n)
        if rank:
            del flow['params'], flow['initial']
        result = {'entered_at': entered, 'setup_s': ready - entered,
                  'steps_s': steps_s, 'steps': steps, 'flow': flow}
        dist.destroy_process_group()
        kind = 'ok'
    except BaseException:
        result, kind = traceback.format_exc(), 'error'
    with open(Path(out_dir) / f'rank{rank}.pkl', 'wb') as f:
        pickle.dump((kind, result), f)


def dp_world(batches: dict, device, out_dir: str) -> list:
    """dp_rank on DP_RANKS spawned processes; every process is joined (or
    killed at DP_TIMEOUT_S) before this returns or raises."""
    import pickle
    ctx = torch.multiprocessing.get_context('spawn')
    started = time.time()
    with open(Path(out_dir) / 'batches.pkl', 'wb') as f:
        pickle.dump(batches, f)
    procs = [ctx.Process(target=dp_rank,
                         args=(r, DP_RANKS, out_dir, str(device)))
             for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive:
        raise AssertionError(f'data_parallel_flows: {len(alive)} ranks '
                             f'still running after {DP_TIMEOUT_S} s: killed')
    results = []
    for r in range(DP_RANKS):
        path = Path(out_dir) / f'rank{r}.pkl'
        if not path.exists():
            raise AssertionError(f'data_parallel_flows: rank {r} exited '
                                 f'with {procs[r].exitcode} and no result')
        with open(path, 'rb') as f:
            kind, value = pickle.load(f)
        if kind != 'ok':
            raise AssertionError(f'data_parallel_flows rank {r}:\n{value}')
        value['started_s'] = value.pop('entered_at') - started
        results.append(value)
    return results


def dp_world_of_one(device, batches: dict) -> dict:
    """A process group of one NCCL rank (tcp to localhost) and the (1, 1)
    mesh over it: the data-parallel detector and tiny steps (BatchNorm
    sums, loss shares, metrics and gradients all-reduced over the group
    of one) against the plain steps from the same weights and batch, one
    step each; then steps/s of each, the data-parallel and the plain step
    in turn in this process, at lr 0 (median of three samples, all
    kept), and each one's device profile. The group is destroyed
    afterwards."""
    import torch.distributed as dist
    from object_tracking_tpu_torch.config import MeshConfig
    from object_tracking_tpu_torch.parallel import distributed_init, make_mesh
    config = MeshConfig(distributed=True, num_processes=1, process_id=0,
                        coordinator_address=f'localhost:{free_port()}')
    distributed_init(config, device)
    models = dp_models()
    out = {}
    try:
        if dist.get_backend() != ('nccl' if device.type == 'cuda'
                                  else 'gloo'):
            raise AssertionError(f'backend {dist.get_backend()}')
        mesh = make_mesh(MeshConfig())
        for name in ('detector_float32', 'bbox_bce'):
            make_model, make_step, lr = models[name]
            batch = batches[name][0]
            states, metrics, rates = {}, {}, {}
            for kind, on in (('plain', None), ('dp', mesh)):
                states[kind] = TrainState.create(
                    make_model(on).to(device), make_optimizer(lr))
                _, metrics[kind] = make_step(on)(states[kind], batch)
            torch.cuda.synchronize()
            plain = dict(states['plain'].model.named_parameters())
            dp = dict(states['dp'].model.named_parameters())
            entry = {
                'metrics_max_rel': max(
                    abs(float(metrics['dp'][k]) - float(v))
                    / max(abs(float(v)), 1e-30)
                    for k, v in metrics['plain'].items()),
                'grads_rel_l2_max': max(rel_l2(dp[k].grad, p.grad)
                                        for k, p in plain.items()),
                'params_rel_l2_max': max(rel_l2(dp[k].detach(), p.detach())
                                         for k, p in plain.items())}
            if (entry['metrics_max_rel'] > METRIC_RTOL
                    or entry['grads_rel_l2_max'] > LEAF_TOL
                    or entry['params_rel_l2_max'] > LEAF_TOL):
                raise AssertionError(f'dp {name} vs plain: {entry}')
            items = _lead(batch)
            for kind, on in (('dp', mesh), ('plain', None)):
                state = states[kind].with_learning_rate(0.0)
                step = make_step(on)
                median = put_rate(rates, f'steps_per_s_{kind}', rate(
                    lambda s=state, f=step: f(s, batch), 1, DP_RATE_STEPS))
                rates[f'profile_{kind}'] = breakdown(device_times(
                    lambda s=state, f=step: f(s, batch), 2, state.model),
                    1e3 / median, (('collectives', ('nccl',)),) + (
                        TRAIN_CATEGORIES if name.startswith('detector')
                        else TINY_CATEGORIES))
            rates['dp_over_plain'] = (rates['steps_per_s_dp']
                                      / rates['steps_per_s_plain'])
            out[name] = {'batch': items, 'vs_plain': entry, **rates,
                         'tolerance': {'metrics_rtol': METRIC_RTOL,
                                       'rel_l2': LEAF_TOL}}
            del states
            gc.collect()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def data_parallel_phase(device, smi: str) -> dict:
    """The single-object and detector training flows' data parallelism on
    the card: the steps at world size 1 over NCCL against the plain steps
    (and their steps/s), then over DP_RANKS gloo ranks on the card, each
    holding half of each global batch, against the one-rank step on the
    card at the CPU tests' bars; the MoE head on a ragged (replicated)
    batch against the one-rank MoE step; single_object_tracking over the
    ranks, kernel 1 in its prior, against the one-rank flow."""
    start = time.perf_counter()
    batches = dp_batches()
    out = {'phase': 'data_parallel_flows', 'ranks': DP_RANKS,
           'device_per_rank': str(device),
           'collectives': 'gloo, on the CUDA tensors',
           'shapes': {'detector': {'net': NET, 'classes': 80,
                                   'B': DP_DET_B,
                                   'dtype': 'float64, and float32 reported'},
                      'tiny': {'B': DP_TINY_B, 'T': TRACK_T,
                               'feature': [13, 13, 1024],
                               'lstm_units': 512},
                      'moe_ragged': {'net': DP_MOE_NET, 'width_div': 8,
                                     'B': DP_MOE_B, **MOE},
                      'flow': {'frames': DP_FLOW_FRAMES, 'T': TRACK_T,
                               'B': TRACK_B, 'prior': f'YOLOv2 {NET}²'}},
           'tolerance': {'metrics_rtol': METRIC_RTOL, 'rel_l2': LEAF_TOL,
                         'cosine': DP_COS, 'norm_ratio': DP_RATIO}}
    out['world_of_one_nccl'] = dp_world_of_one(device, batches)
    refs = {name: dp_two_steps(case, batches[name], device)
            for name, case in dp_models().items()}
    with tempfile.TemporaryDirectory() as tmp:
        ref_flow = dp_flow(device, str(Path(tmp) / 'one_rank'))
        gc.collect()
        torch.cuda.empty_cache()
        ranks = dp_world(batches, device, tmp)
        flow_dir = Path(tmp) / 'flow'
        written = {'logs': sorted(os.listdir(flow_dir / 'logs')),
                   'checkpoints': sorted(os.listdir(
                       flow_dir / 'models' / 'tiny_tracker'))}
    out['rank_seconds'] = [{k: r[k] for k in ('started_s', 'setup_s',
                                              'steps_s')} for r in ranks]
    steps = {}
    for name, ref in refs.items():
        whole = [_lead(b) for b in batches[name]]
        got = ranks[0]['steps'][name]
        if name in DP_REPORTED:
            f64 = refs['detector']['grads']
            steps[name] = {
                **dp_errors(got, ref),
                'one_rank_vs_float64_grads_rel_l2_max': max(
                    rel_l2(ref['grads'][k], v) for k, v in f64.items()),
                'two_ranks_vs_float64_grads_rel_l2_max': max(
                    rel_l2(got['grads'][k], v) for k, v in f64.items()),
                'ranks_agree': all(r['steps'][name]['sums'] == got['sums']
                                   for r in ranks),
                'held_to': 'reported: the bars hold in float64 (detector)'}
            continue
        entry = {'global_batch': whole,
                 'local_batch': [r['steps'][name]['local_batch']
                                 for r in ranks],
                 'replicated': [r['steps'][name]['replicated']
                                for r in ranks],
                 'ranks_agree': all(r['steps'][name]['sums'] == got['sums']
                                    for r in ranks),
                 **dp_errors(got, ref)}
        ragged = whole[0] % DP_RANKS != 0
        want = whole if ragged else [b // DP_RANKS for b in whole]
        if (not entry['ok'] or not entry['ranks_agree']
                or any(lb != want for lb in entry['local_batch'])
                or any(rep != [ragged] * 2 for rep in entry['replicated'])):
            raise AssertionError(f'data parallel {name}: {entry}')
        if name == 'moe_ragged':
            entry['moe_aux'] = [got['metrics'][0]['moe_aux'],
                                ref['metrics'][0]['moe_aux']]
        steps[name] = entry
    out['two_ranks_vs_one_rank'] = steps

    flows = [r['flow'] for r in ranks]
    mine = flows[0]
    names = sorted(ref_flow['params'])
    d = _update({k: mine['params'][k] for k in names}, mine['initial'])
    d_ref = _update(ref_flow['params'], ref_flow['initial'])
    flow = {'steps': [f['step'] for f in flows],
            'one_rank_steps': ref_flow['step'],
            'local_batch': [f['local_batch'] for f in flows],
            'one_rank_batch': ref_flow['local_batch'],
            'replicated': [f['replicated'] for f in flows],
            'ranks_agree': all(f['sums'] == mine['sums'] for f in flows),
            'same_start': all(torch.equal(mine['initial'][k],
                                          ref_flow['initial'][k])
                              for k in names),
            'update_cosine': float(d @ d_ref / (d.norm() * d_ref.norm())),
            'update_norm_ratio': float(d.norm() / d_ref.norm()),
            'nms_launches_ranks': [f['nms_launches'] for f in flows],
            'nms_launches_one_rank': ref_flow['nms_launches'],
            'seconds_ranks': [f['seconds'] for f in flows],
            'seconds_one_rank': ref_flow['seconds'],
            'written_by_rank_0': written}
    half = [b // DP_RANKS for b in ref_flow['local_batch']]
    if (not flow['ranks_agree'] or not flow['same_start']
            or flow['steps'] != [ref_flow['step']] * DP_RANKS
            or ref_flow['step'] < 2
            or any(lb != half for lb in flow['local_batch'])
            or any(any(rep) for rep in flow['replicated'])
            or flow['update_cosine'] <= DP_COS
            or abs(flow['update_norm_ratio'] - 1.0) >= DP_RATIO
            or min(flow['nms_launches_ranks']) == 0
            or len(set(flow['nms_launches_ranks'])) != 1
            or written != {'logs': ['run_1'],
                           'checkpoints': ['ckpt_1.json', 'ckpt_1.pt']}):
        raise AssertionError(f'data-parallel single-object flow: {flow}')
    out['single_object_flow'] = flow
    out['nms_launches'] = {
        'dp_single_object_flow_ranks': sum(flow['nms_launches_ranks']),
        'dp_single_object_flow_one_rank': ref_flow['nms_launches']}
    out['phase_s'] = time.perf_counter() - start
    out['card'] = smi
    return out


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

    seconds, mark = {}, [time.perf_counter()]

    def took(name: str) -> None:
        now = time.perf_counter()
        seconds[name], mark[0] = now - mark[0], now

    kern = kernel_phase(device)
    emit({'phase': 'kernel', **kern, 'card': smi})
    took('kernel')
    assign = assign_phase(device)
    emit({**assign, 'card': smi})
    took('assign')
    mish = mish_phase(device)
    emit({**mish, 'card': smi})
    took('mish')
    bn = batch_norm_phase(device)
    emit({**bn, 'card': smi})
    took('batch_norm')
    gc.collect()
    torch.cuda.empty_cache()
    rcnn = rcnn_phase(device)
    emit({**rcnn, 'card': smi})
    took('rcnn')
    gc.collect()
    torch.cuda.empty_cache()
    path, profiles = path_phase(device, smi)
    emit(path)
    emit({'phase': 'profile', 'per_call': profiles, 'card': smi})
    took('path')
    detector, netout, obj = detector_phase(device, smi)
    emit(detector)
    took('detector')
    golden = golden_phase(device, smi)
    emit(golden)
    took('golden')
    dn = decode_nms_phase(device, netout, obj)
    emit({'phase': 'decode_nms', **dn, 'card': smi})
    took('decode_nms')
    train, trained = train_phase(device, smi)
    emit(train)
    took('train')
    tracker, tracker_launches = tracker_phase(device, smi)
    emit(tracker)
    took('tracker')
    emit(detector_train_phase(device, smi))
    took('detector_train')
    deep = deep_phase(device, smi)
    emit(deep)
    took('deep')
    served = serve_phase(device, smi, trained)
    emit(served)
    took('serve')
    parallel = parallel_phase(device, smi)
    emit(parallel)
    took('parallel')
    native = native_data_phase(device, smi)
    emit(native)
    took('native_data')
    tp = tensor_parallel_phase(device, smi)
    emit(tp)
    took('tensor_parallel')
    dp = data_parallel_phase(device, smi)
    emit(dp)
    took('data_parallel_flows')
    emit({'phase_seconds': seconds, 'total_s': time.perf_counter() - start})

    nms_launches = {'joint_path': path['nms_launches'],
                    'detector_path': detector['nms_launches'],
                    'golden_detectors': golden['nms_launches'],
                    'train_to_serve': train['serve']['nms_launches'],
                    'tracker_precompute': tracker_launches['precompute'],
                    'tracker_augment': tracker_launches['augment'],
                    'deep_head_predict': deep['nms_launches'],
                    **served['nms_launches'],
                    'moe_head_predict':
                        parallel['moe_predict']['nms_launches'],
                    'tensor_parallel_serve': tp['serve']['nms_launches'],
                    **dp['nms_launches'],
                    'frcnn_detect_images': rcnn['nms_launches']}
    not_driven = {}
    if native['available']:
        nms_launches['native_decode_golden'] = \
            native['cfg_detector']['nms_launches']
    else:
        not_driven['native_decode_golden'] = \
            'not driven: libottdata.so cannot build on this machine'
    dn_err = max(max(c['boxes_max_abs_diff'], c['scores_max_abs_diff'])
                 for c in dn['checks'])
    dn_f8 = dn['times']['f8']
    k1 = kern['times'][f'32x128x{NUM_CLASSES}']
    a8 = assign['times']['b8']
    bn_launches = {'darknet19_step_b32': bn['step']['launches_per_step'],
                   'joint_path': path['bn_launches']['launches'],
                   'joint_train_step': train['bn_launches']['launches']}
    assign_launches = {
        'assign_phase': sum(c['launches'] for c in assign['checks']),
        'assign_branches': sum(c['launches'] for c in assign['branches']),
        'joint_path': path['assign_launches']}
    emit({'kernels': [{
        'name': 'nms_scores',
        'route': 'cuda',
        'source': 'object_tracking_tpu_torch/ops/cuda/csrc/nms_scores.cu',
        'replaces': 'object_tracking_tpu/ops/pallas/nms_pallas.py:83',
        'custom_op': 'ott_torch::nms_scores',
        'shapes': {'boxes': [32, 128, 4], 'scores': [32, 128, NUM_CLASSES]},
        'launches': sum(nms_launches.values()),
        'launches_by_path': nms_launches,
        'paths_not_driven': not_driven,
        'max_abs_err': max(c['max_abs_diff'] for c in kern['checks']),
        'max_abs_diff': max(c['max_abs_diff'] for c in kern['checks']),
        'ms': k1['device']['ms'] or k1['call_ms'],
        'passes_ms': k1['device']['passes'],
        'call_ms': k1['call_ms'],
        'host_us': k1['host_us'],
        'plain_ms': k1['plain_ms'],
        'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
        'ms_by_shape': {shape: t['device']['ms']
                        for shape, t in kern['times'].items()},
        # on the inputs of Faster R-CNN's own call (the rcnn phase)
        'ms_in_rcnn_call': {name: t['device']['ms']
                            for name, t in rcnn['nms'].items()},
        # no installed PyTorch call computes per-class greedy NMS over a
        # score matrix (torchvision's batched_nms is not installed, and it
        # is single-label hard NMS)
        'library_ms': None}, {
        'name': 'decode_nms_fused',
        'route': 'cuda',
        'source': 'object_tracking_tpu_torch/ops/cuda/csrc/decode_nms.cu',
        'replaces': 'object_tracking_tpu/ops/pallas/decode_nms_pallas.py:100',
        'shapes': {'netout': list(netout.shape)},
        'launches': dn['launches'],
        'launches_by_path': {'detector_netouts': dn['launches']},
        'max_abs_err': dn_err,
        'max_abs_diff': dn_err,
        'ms': dn_f8['device']['ms'] or dn_f8['kernel_call_ms'],
        'passes_ms': dn_f8['device']['passes'],
        'ms_f1': dn['times']['f1']['device']['ms'],
        'call_ms': dn_f8['kernel_call_ms'],
        'host_us': dn_f8['host_us'],
        'plain_ms': dn_f8['plain_ms'],
        'staged_ms': dn_f8['staged_ms'],
        'bound_ms': dn['bound_ms'], 'bound_by': dn['bound_by'],
        # no installed PyTorch call computes per-class greedy NMS, let
        # alone with the region decode fused in
        'library_ms': None}, {
        'name': 'assign_tracks',
        'route': 'cuda',
        'source': 'object_tracking_tpu_torch/ops/cuda/csrc/assign_tracks.cu',
        'replaces': None,
        'custom_op': 'ott_torch::assign_tracks',
        'shapes': a8['shape'],
        'launches': sum(assign_launches.values()),
        'launches_by_path': assign_launches,
        'max_abs_diff': max(c['max_abs_diff'] for c in
                            assign['checks'] + assign['branches']),
        'branches': {c['name']: {k: c[k] for k in (
            'slots', 'dets', 'threads', 'keys_in_smem', 'bitonic',
            'max_gated_pairs')} for c in assign['branches']},
        'ms': a8['device']['ms'] or a8['call_ms'],
        'ms_b1': assign['times']['b1']['device']['ms'],
        'call_ms': a8['call_ms'],
        'host_us': a8['host_us'],
        'plain_ms': a8['plain_ms'],
        'bound_ms': a8['bound_ms'], 'bound_by': a8['bound_by'],
        # no installed PyTorch call computes greedy track assignment
        'library_ms': None}, {
        'name': 'mish',
        'route': 'cuda',
        'source': 'object_tracking_tpu_torch/ops/cuda/csrc/mish.cu',
        'replaces': None,
        'custom_op': 'ott_torch::mish',
        'shapes': mish['forward']['shapes'],
        'launches': mish['forward']['launches_per_forward'],
        'launches_by_path': {'yolov4_forward_b8':
                             mish['forward']['launches_per_forward']},
        'max_abs_diff': 0.0,
        'ms': mish['per_forward']['kernel_ms'],
        'plain_ms': mish['per_forward']['plain_ms'],
        'bound_ms': mish['per_forward']['bound_ms'], 'bound_by': 'bytes',
        # F.mish computes the same function: a yardstick only, the port
        # never calls it
        'library_ms': mish['per_forward']['library_ms']}, {
        'name': 'batch_norm',
        'route': 'cuda',
        'source': 'object_tracking_tpu_torch/ops/cuda/csrc/batch_norm.cu',
        'replaces': None,
        'custom_op': 'ott_torch::batch_norm_stats',
        'shapes': bn['step']['inputs'],
        'launches': sum(bn_launches.values()),
        'launches_by_path': bn_launches,
        'max_abs_diff': bn['per_step']['max_abs_diff'],
        'ms': bn['per_step']['kernel_ms'],
        'plain_ms': bn['per_step']['plain_ms'],
        'bound_ms': bn['per_step']['bound_ms'], 'bound_by': 'bytes',
        # F.batch_norm(training=True) gives the same y and gradients up to
        # rounding (the biased batch variance; no clip on these inputs): a
        # yardstick only, the port never calls it
        'library_ms': bn['per_step']['library_ms']}, {
        'name': 'roi_pool',
        'route': 'cuda',
        'source': 'object_tracking_tpu_torch/ops/cuda/csrc/roi_pool.cu',
        'replaces': None,
        'custom_op': 'ott_torch::roi_pool',
        'shapes': {'map': rcnn['roi_pool']['map'],
                   'rois': rcnn['roi_pool']['rois']},
        'launches': rcnn['roi_pool_launches'],
        'launches_by_path': {'frcnn_detect_images':
                             rcnn['roi_pool_launches']},
        'max_abs_diff': 0.0,
        'ms': rcnn['roi_pool']['kernel_ms'],
        'call_ms': rcnn['roi_pool']['call_ms'],
        'host_us': rcnn['roi_pool']['host_us'],
        'plain_ms': rcnn['roi_pool']['plain_ms'],
        'bound_ms': rcnn['roi_pool']['bound_ms'], 'bound_by': 'bytes',
        # no installed PyTorch call pools RoIs (torchvision is absent)
        'library_ms': None}]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
