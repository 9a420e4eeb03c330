"""The port's serving artifact: export -> save -> reload -> serve.

Mirrors tests/test_serving.py on `object_tracking_tpu_torch.serving`, on
the CPU (width_div=8, 64x64 frames, 3 classes, 2 anchors, ConvLSTM-8,
T=4), and holds the served program:

- against the port's own `JointPredictor` with `nms_impl='op'` (the same
  custom op the program calls) on the same weights and uint8-quantised
  frames: exactly equal;
- against JAX's `make_clip_program`, jitted on the CPU, on the same
  converted weights: labels, valid detections and ids exactly equal,
  boxes and scores within rtol 1e-3, atol 1e-4 (batch-statistics
  BatchNorm carries ~1e-4 of float32 rounding, see test_torch_models.py;
  exp() scales it into the widths). JAX's program runs `nms_impl='sort'`,
  whose IoU is inter / (union + 1e-10); the op's is the TPU kernel's
  inter / max(union, 1e-12). A guard checks that no class score lies
  within 1e-4 of obj_threshold, so that a flipped detection is a fault.

Kernel 1's custom op is checked with `torch.library.opcheck`, and its CPU
result against `nms_scores_plain` (exactly).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu.serving import _batched_track_state as jtracks
from object_tracking_tpu.serving import make_clip_program as jprogram
from object_tracking_tpu_torch import trainer
from object_tracking_tpu_torch.config import YOLOV2_ANCHORS, Config
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.inference import JointPredictor
from object_tracking_tpu_torch.models import MultiObjDetTracker
from object_tracking_tpu_torch.models.darknet19 import init_like_flax
from object_tracking_tpu_torch.ops.cuda import nms as cuda_nms
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores
from object_tracking_tpu_torch.serving import (ServedJointPredictor,
                                               export_joint, save_artifact)
from torch_parity import randomize_bn

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_classes=3, num_anchors=2, convlstm_features=8, width_div=8)
ANCHORS = np.asarray(YOLOV2_ANCHORS[:4], np.float32)
LABELS = ('a', 'b', 'c')
OBJ = 0.25
# frames whose class scores all lie > 1e-4 from OBJ (the guard below)
SEED = 0
EXPORT = dict(labels=LABELS, window=4, net_size=(64, 64), obj_threshold=OBJ)


def _jax_weights(layers=1):
    jmodel = JTracker(convlstm_layers=layers, **SMALL)
    variables = randomize_bn(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 64, 64, 3))),
        np.random.RandomState(0))
    # a wider track head spreads the class scores over (0, 1)
    variables['params']['tconv_2']['kernel'] *= 4.0
    return jmodel, variables


def _model(variables, layers=1):
    model = MultiObjDetTracker(convlstm_layers=layers, **SMALL)
    model.load_state_dict(from_flax(variables), strict=True)
    return model


@pytest.fixture(scope='module')
def setup():
    """JAX's weights, the port's model on them, its B=1 artifact, and the
    artifact loaded (an export and a load take seconds each here; a test
    that serves starts with `reset_state()`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jmodel, variables = _jax_weights()
    model = _model(variables)
    art = export_joint(model, ANCHORS, batch=1, **EXPORT)
    yield jmodel, variables, model, art, ServedJointPredictor(
        art, device='cpu')
    torch.set_num_threads(threads)


@pytest.fixture
def served(setup):
    setup[4].reset_state()
    return setup[4]


def _clip(seed, b=1):
    return np.random.RandomState(seed).randint(0, 256, (b, 4, 64, 64, 3),
                                               np.uint8)


def test_artifact_roundtrips_through_disk(setup, tmp_path):
    path = save_artifact(setup[3], str(tmp_path / 'joint.ottserve'))
    served = ServedJointPredictor.load(path, device='cpu')
    assert served.labels == LABELS
    assert served.meta['net_size'] == [64, 64]
    assert served.meta['device'] == 'cpu'
    assert served.meta['dtype'] == 'float32'
    assert served.batch == 1 and served.window == 4
    assert [leaf['shape'] for leaf in served.meta['state_leaves']] == \
        [[1, 2, 2, 8]] * 2


def test_graph_calls_the_op_and_writes_no_buffer(served):
    targets = [n.target for n in served.exported.graph.nodes]
    assert targets.count(torch.ops.ott_torch.nms_scores.default) == 1
    assert not served.exported.graph_signature.buffers_to_mutate
    # the guard is live: a model that writes a buffer in eval() mode is
    # refused
    with pytest.raises(RuntimeError, match='write buffers'):
        export_joint(_Writes(**SMALL), ANCHORS, batch=1, **EXPORT)


class _Writes(MultiObjDetTracker):
    """Counts its calls in a buffer, whatever its mode."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.register_buffer('calls', torch.zeros(()))

    def forward(self, *args, **kw):
        self.calls.add_(1)
        return super().forward(*args, **kw)


def test_served_matches_in_process_predictor(setup, served):
    """Two streamed windows through the artifact == the same windows
    through JointPredictor(nms_impl='op') on the same weights, exactly."""
    model = setup[2]
    pred = JointPredictor(model, ANCHORS, LABELS, net_size=(64, 64),
                          obj_threshold=OBJ, device='cpu', nms_impl='op')
    clip = np.random.RandomState(7).randint(0, 256, (8, 64, 64, 3),
                                            np.uint8)
    ref, got = [], []
    for w in (clip[:4], clip[4:]):
        ref.extend(pred.predict_window(np.asarray(w, np.float32) / 255.0))
        got.extend(served.predict_window(w[None])[0])
    assert len(ref) == len(got) == 8
    assert sum(map(len, ref)) > 0, 'threshold too high: nothing to compare'
    assert got == ref


def _jax_frames(dets, ids):
    """JAX's padded outputs for one clip → per-frame (label, id, score,
    box) lists, sorted by score as ServedJointPredictor sorts them."""
    boxes, labels, scores, valid = (np.asarray(a)[0] for a in dets)
    out = []
    for t in range(boxes.shape[0]):
        v = valid[t]
        order = np.argsort(-scores[t][v], kind='stable')
        out.append([(int(labels[t][v][i]), int(np.asarray(ids)[0, t][v][i]),
                     float(scores[t][v][i]), boxes[t][v][i]) for i in order])
    return out


def test_served_matches_jax_clip_program(setup, served):
    """Two streamed windows: the artifact against JAX's make_clip_program
    jitted on the CPU, on the same converted weights."""
    jmodel, variables = setup[:2]
    program = jax.jit(jprogram(jmodel, variables, ANCHORS,
                               obj_threshold=OBJ))
    state, tracks = jmodel.zero_state(1, 2, 2), jtracks(1, 64)
    detections = 0
    for seed in (SEED, SEED + 1):
        frames = _clip(seed)
        out = jmodel.apply(variables, frames.astype(np.float32) / 255.0,
                           train=True, initial_state=state,
                           mutable=['batch_stats'])[0]['track']
        netout = np.asarray(out)
        conf = 1.0 / (1.0 + np.exp(-netout[..., 4:5]))
        logits = netout[..., 5:] - netout[..., 5:].max(-1, keepdims=True)
        probs = conf * np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        assert np.abs(probs - OBJ).min() > 1e-4
        dets, ids, state, tracks = program(frames, state, tracks)
        ref = _jax_frames(dets, ids)
        got = served.predict_window(frames)[0]
        for frame_ref, frame_got in zip(ref, got):
            assert [(LABELS[r[0]], r[1]) for r in frame_ref] == \
                [(d['label'], d['track_id']) for d in frame_got]
            for r, d in zip(frame_ref, frame_got):
                np.testing.assert_allclose(d['score'], r[2], rtol=1e-3,
                                           atol=1e-4)
                np.testing.assert_allclose(d['box'], r[3], rtol=1e-3,
                                           atol=1e-4)
            detections += len(frame_ref)
    assert detections > 0


def test_reset_state_restarts_streams(served):
    w = _clip(3)
    first = served.predict_window(w)
    served.predict_window(w)          # advances ConvLSTM + track state
    served.reset_state()
    assert repr(served.predict_window(w)) == repr(first)


def test_float_frames_and_wrong_inputs(setup, served, tmp_path):
    """Float frames in [0, 1] are quantised as uint8; a wrong shape and a
    file that is not an artifact raise; no card, no CUDA serving."""
    w = _clip(4)
    first = served.predict_window(w)
    served.reset_state()
    assert served.predict_window(w / 255.0) == first
    with pytest.raises(ValueError, match='expected'):
        served.predict_window(w[:, :3])
    with pytest.raises(ValueError, match='not an OTTSERVE artifact'):
        ServedJointPredictor(b'GARBAGE' + setup[3], device='cpu')
    path = tmp_path / 'weights.pt'
    torch.save({'w': torch.zeros(2)}, path)
    with pytest.raises(ValueError, match='not an OTTSERVE artifact'):
        ServedJointPredictor.load(str(path), device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            ServedJointPredictor(setup[3])


def test_reload_in_a_process_without_model_classes(setup, served,
                                                    tmp_path):
    """A fresh interpreter that imports only serving.py serves the saved
    artifact to the same results, and never loads the port's models."""
    path = save_artifact(setup[3], str(tmp_path / 'joint.ottserve'))
    frames = _clip(5)
    np.save(tmp_path / 'frames.npy', frames)
    code = (
        'import json, sys\n'
        'import numpy as np, torch\n'
        'torch.set_num_threads(1)\n'
        'from object_tracking_tpu_torch.serving import '
        'ServedJointPredictor\n'
        f'served = ServedJointPredictor.load({str(path)!r}, device="cpu")\n'
        f'x = np.load({str(tmp_path / "frames.npy")!r})\n'
        'out = [served.predict_window(x), served.predict_window(x)]\n'
        'assert "object_tracking_tpu_torch.models" not in sys.modules\n'
        'assert not [m for m in sys.modules if m.startswith("jax")]\n'
        'print(json.dumps(out))\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(REPO)
    run = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout.strip().splitlines()[-1])
    want = [served.predict_window(frames), served.predict_window(frames)]
    assert got == json.loads(json.dumps(want))


def small_config():
    cfg = Config()
    cfg.detector.image_h = cfg.detector.image_w = 64
    cfg.detector.width_div = 8
    cfg.joint.convlstm_features = 8
    cfg.joint.sequence_length = 3
    cfg.joint.labels = ('1', '2')
    return cfg


def test_trainer_export_flow(tmp_path, capsys):
    """`export` end to end: config -> model with the checkpoint baked in
    -> artifact on disk -> served predictions equal to JointPredictor's on
    the checkpoint's weights."""
    from object_tracking_tpu_torch.training import (
        CheckpointManager, TrainState, make_optimizer)
    cfg = small_config()
    model = trainer._joint_model(cfg, cfg.joint.labels)
    with torch.no_grad():
        model.tconv_2.weight.mul_(4.0)
    CheckpointManager(str(tmp_path / 'ckpt')).save(
        7, TrainState.create(model, make_optimizer(1e-4)))
    cfg.detector.obj_threshold = 0.2
    path = trainer.export_serving(
        cfg, out_path=str(tmp_path / 'joint.ottserve'),
        checkpoint_dir=str(tmp_path / 'ckpt'), device='cpu')
    assert 'B=1 T=3 64x64' in capsys.readouterr().out
    served = ServedJointPredictor.load(path, device='cpu')
    assert served.window == 3 and served.net_h == 64
    frames = _clip(0)[:, :3]
    out = served.predict_window(frames)
    assert len(out) == 1 and len(out[0]) == 3
    pred = JointPredictor(model, cfg.detector.anchors, cfg.joint.labels,
                          obj_threshold=0.2, net_size=(64, 64),
                          device='cpu', nms_impl='op')
    assert out[0] == pred.predict_window(frames[0] / 255.0)
    assert sum(map(len, out[0])) > 0


def test_export_missing_checkpoint_refuses(tmp_path):
    """A given-but-empty checkpoint directory fails loudly instead of
    baking random weights."""
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        trainer.export_serving(small_config(),
                               out_path=str(tmp_path / 'x.ottserve'),
                               checkpoint_dir=str(tmp_path / 'empty'),
                               device='cpu')
    assert not (tmp_path / 'x.ottserve').exists()


def test_deep_head_state_roundtrip():
    """convlstm_layers=2 carries the 4-leaf ((c, h), (cs, hs)) streaming
    state through the artifact, and serves as JointPredictor does."""
    model = _model(_jax_weights(layers=2)[1], layers=2)
    art = export_joint(model, ANCHORS, batch=1, **EXPORT)
    served = ServedJointPredictor(art, device='cpu')
    assert [leaf['shape'] for leaf in served.meta['state_leaves']] == \
        [[1, 2, 2, 8]] * 2 + [[1, 1, 2, 2, 8]] * 2
    frames = _clip(0)
    first = served.predict_window(frames)
    second = served.predict_window(frames)
    (c, h), (cs, hs) = served._state
    assert cs.shape == (1, 1, 2, 2, 8) and cs.dtype == torch.float32
    pred = JointPredictor(model, ANCHORS, LABELS, net_size=(64, 64),
                          obj_threshold=OBJ, device='cpu', nms_impl='op')
    for want in (first, second):
        assert want[0] == pred.predict_window(frames[0] / 255.0)
    served.reset_state()
    assert repr(served.predict_window(frames)) == repr(first)


def test_batched_streams_export():
    """B=2: two independent streams in one program, identities per
    stream; the same pixels in both streams give the same results."""
    art = export_joint(init_like_flax(MultiObjDetTracker(**SMALL), 0),
                       ANCHORS, batch=2, **{**EXPORT, 'obj_threshold': 0.1})
    served = ServedJointPredictor(art, device='cpu')
    frames = _clip(5, b=2)
    out = served.predict_window(frames)
    assert len(out) == 2 and all(len(c) == 4 for c in out)
    served.reset_state()
    dup = served.predict_window(np.stack([frames[0], frames[0]]))
    assert repr(dup[0]) == repr(dup[1])
    assert served._track_state[-1].shape == (2,)        # next_id per stream


def test_custom_op_opcheck_and_cpu_twin(rng):
    """opcheck (schema, fake tensor, autograd registration, AOT dispatch)
    of `ott_torch::nms_scores`; on the CPU it equals nms_scores_plain
    exactly and launches nothing, and impl='op' routes through it."""
    boxes = torch.from_numpy(rng.rand(3, 32, 4).astype(np.float32))
    scores = torch.from_numpy((rng.rand(3, 32, 5) * (rng.rand(3, 32, 5)
                                                      > 0.5)).astype(
        np.float32))
    result = torch.library.opcheck(torch.ops.ott_torch.nms_scores.default,
                                   (boxes, scores, 0.45))
    assert set(result.values()) == {'SUCCESS'}
    before = cuda_nms.nms_scores.launches
    out = torch.ops.ott_torch.nms_scores(boxes, scores, 0.45)
    want = cuda_nms.nms_scores_plain(boxes, scores, 0.45)
    assert torch.equal(out, want) and (out != scores).any()
    assert cuda_nms.nms_scores.launches == before
    _, kept = greedy_nms_scores(boxes, scores, 0.45, top_k=0, impl='op')
    assert torch.equal(kept, want)
    with pytest.raises(ValueError, match='CUDA'):
        greedy_nms_scores(boxes, scores, impl='kernel')
