"""The port's evaluation, tracking and command-line flows on the CPU.

- `evaluate_tracking` against JAX's `evaluate_tracking_dataset` with a
  Hungarian `JointPredictor`, on the same weights (JAX's, converted and
  baked into a checkpoint that the port's flow restores) and the same
  synthetic frames: the per-video and overall CLEAR-MOT counts exactly,
  MOTA, MOTP and the detection AP within 1e-4 (the port's boxes lie
  within ~1e-4 of JAX's under batch statistics,
  tests/test_torch_inference.py).
- `track_video` over a frames directory and over a video file (cv2 is
  on this host; the card's machine has none).
- `main`: `--help` lists the seven commands; `joint --synthetic
  --epochs 1 --device cpu` trains from a config file; `--profile-dir`
  writes a profiler trace of the fit.

Small: 64x64 frames, width_div=8, ConvLSTM-8, T=3, one thread.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.data import parse_annotation_dir as jparse
from object_tracking_tpu.evaluation import evaluate_tracking_dataset as jeval
from object_tracking_tpu.inference import JointPredictor as JPredictor
from object_tracking_tpu.models import MultiObjDetTracker as JTracker
from object_tracking_tpu_torch import trainer
from object_tracking_tpu_torch.config import Config
from object_tracking_tpu_torch.convert import from_flax
from object_tracking_tpu_torch.training import (CheckpointManager,
                                                TrainState, make_optimizer)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_config():
    cfg = Config()
    cfg.detector.image_h = cfg.detector.image_w = 64
    cfg.detector.width_div = 8
    cfg.joint.convlstm_features = 8
    cfg.joint.sequence_length = 3
    cfg.train.max_boxes_per_image = 8
    cfg.train.augment = False
    return cfg


def test_evaluate_tracking_matches_jax(tmp_path, capsys):
    cfg = tiny_config()
    cfg.detector.obj_threshold = 0.3
    labels = ('1', '2')
    jmodel = JTracker(num_classes=2, num_anchors=5, convlstm_features=8,
                      width_div=8)
    variables = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 3, 64, 64, 3))))
    # a wider track head spreads the class scores over (0, 1)
    variables['params']['tconv_2']['kernel'] *= 4.0
    model = trainer._joint_model(cfg, labels)
    model.load_state_dict(from_flax(variables), strict=True)
    CheckpointManager(str(tmp_path / 'ckpt')).save(
        1, TrainState.create(model, make_optimizer(1e-4)))

    results = trainer.evaluate_tracking(
        cfg, synthetic=True, checkpoint_dir=str(tmp_path / 'ckpt'),
        window=3, workdir=str(tmp_path), device='cpu')
    printed = capsys.readouterr().out
    assert 'restored checkpoint step 1' in printed
    assert json.loads(printed[printed.index('{'):])['overall']

    pred = JPredictor(jmodel, variables, cfg.detector.anchors, labels,
                      obj_threshold=0.3, net_size=(64, 64),
                      matcher='hungarian')
    anns, _ = jparse(cfg.train.val_annot_folder, cfg.train.val_image_folder,
                     labels)
    ref = jeval(pred, anns, window=3)
    assert set(results) == set(ref) == {'video_00', 'video_01',
                                         'detection', 'overall'}
    for name, metrics in ref.items():
        assert set(results[name]) == set(metrics), name
        for key, want in metrics.items():
            got = results[name][key]
            if key in ('fp', 'fn', 'id_switches', 'num_gt', 'matches'):
                assert got == want, (name, key)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                           err_msg=f'{name}/{key}')
    # untrained weights match little of the ground truth; the compared
    # predictions are their detections, all of them false positives here
    assert ref['overall']['fp'] > 0


def _frames_dir(tmp_path):
    from object_tracking_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    img_dir, _ = make_synthetic_dataset(
        str(tmp_path / 'clip'), num_videos=1, frames_per_video=5,
        image_size=(64, 64), labels=('1',))
    return os.path.join(img_dir, 'video_00')


def test_track_flow_on_frames_dir(tmp_path):
    """`track`: a frames directory in → drawn frames, persistent ids and
    an assembled video out."""
    import cv2
    cfg = tiny_config()
    cfg.joint.labels = ('1',)
    cfg.detector.obj_threshold = 0.05
    out = str(tmp_path / 'drawn')
    vid = str(tmp_path / 'tracked.avi')
    results = trainer.track_video(cfg, frames_dir=_frames_dir(tmp_path),
                                  out_dir=out, out_video=vid, fps=5.0,
                                  device='cpu')
    assert len(results) == 5 and len(os.listdir(out)) == 5
    assert sum(map(len, results)) > 0
    assert all(d['track_id'] >= 0 for frame in results for d in frame)
    cap = cv2.VideoCapture(vid)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()


def test_track_flow_on_video_file(tmp_path):
    """`track` accepts a video file: decoded with cv2, then tracked, with
    the Hungarian matcher through the command line."""
    import cv2
    path = str(tmp_path / 'clip.avi')
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 5, (64, 64))
    assert wr.isOpened()
    rng = np.random.RandomState(0)
    for i in range(4):
        frame = rng.randint(0, 80, (64, 64, 3), np.uint8)
        frame[20:36, 10 + 4 * i:26 + 4 * i] = (0, 200, 255)
        wr.write(frame)
    wr.release()
    cfg_path = tmp_path / 'cfg.json'
    cfg = tiny_config()
    cfg.joint.labels = ('1',)
    cfg_path.write_text(cfg.to_json())
    out = str(tmp_path / 'drawn')
    assert trainer.main(['--config', str(cfg_path), '--device', 'cpu',
                         'track', '--frames', path, '--out-dir', out,
                         '--matcher', 'hungarian']) == 0
    assert len(os.listdir(out)) == 4


def test_help_lists_the_seven_commands(capsys):
    with pytest.raises(SystemExit) as stop:
        trainer.main(['--help'])
    assert stop.value.code == 0
    text = capsys.readouterr().out
    assert '{single,joint,detect,track,eval,export,convert}' in text
    assert '--device' in text and 'compile cache' in text


def test_main_joint_trains_on_the_cpu(tmp_path, monkeypatch):
    """`joint --synthetic --epochs 1 --device cpu` from a config file: one
    epoch of the deep head, its checkpoint, then `eval` restores it."""
    monkeypatch.chdir(tmp_path)
    cfg = tiny_config()
    cfg.joint.convlstm_layers = 2
    cfg.train.checkpoint_every_epochs = 1
    (tmp_path / 'cfg.json').write_text(cfg.to_json())
    monkeypatch.setattr(trainer, '_synthetic_dirs',
                        lambda c, size, labels, workdir=None:
                        _small_synthetic(c, size, labels, workdir))
    assert trainer.main(['--config', 'cfg.json', '--device', 'cpu', 'joint',
                         '--synthetic', '--epochs', '1',
                         '--image-size', '64']) == 0
    ckpts = tmp_path / 'models' / 'multi_obj'
    assert sorted(os.listdir(ckpts)) == ['ckpt_1.json', 'ckpt_1.pt']
    assert trainer.main(['--config', 'cfg.json', '--device', 'cpu', 'eval',
                         '--synthetic', '--checkpoint-dir', str(ckpts),
                         '--window', '3']) == 0


_SYNTHETIC = trainer._synthetic_dirs


def _small_synthetic(cfg, size, labels, workdir):
    """One video of 5 frames: the flow's mechanics, not its capacity."""
    return _SYNTHETIC(cfg, size, labels, frames=5, videos=1,
                      workdir=workdir or '.')


def test_main_refuses_profile_dir(tmp_path, monkeypatch):
    """`joint --profile-dir` is no longer refused: the fit runs under
    torch.profiler and its Chrome trace lands in the directory."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'cfg.json').write_text(tiny_config().to_json())
    monkeypatch.setattr(trainer, '_synthetic_dirs',
                        lambda c, size, labels, workdir=None:
                        _small_synthetic(c, size, labels, workdir))
    trace = tmp_path / 'trace'
    assert trainer.main(['--config', 'cfg.json', '--device', 'cpu', 'joint',
                         '--synthetic', '--epochs', '1', '--image-size',
                         '64', '--profile-dir', str(trace)]) == 0
    files = [f for f in os.listdir(trace) if f.endswith('.pt.trace.json')]
    assert len(files) == 1
    with open(trace / files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'aten::conv2d' in names


