"""The port's joint training flow, `trainer.simult_multi_obj_detection_
tracking`, on the CPU (port side only: the JAX joint flow compiles for
minutes and is a slow-tier test).

Small size: 64x64 synthetic frames, width_div=8, ConvLSTM-8, T=3, one
epoch, then a resume; the fused path (the default) and the legacy host
pipeline; the parallel and profiling options; flax-like initialisation
and the darknet backbone with its head re-randomised.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch import trainer
from object_tracking_tpu_torch.config import Config
from object_tracking_tpu_torch.models import Darknet19, MultiObjDetTracker
from object_tracking_tpu_torch.models.darknet19 import BatchNorm, init_like_flax


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """Small tensors gain nothing from intra-op threads, and beside the
    other test workers' threads they make the flow's ~100 small steps
    crawl; one thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_config(**train):
    cfg = Config()
    cfg.detector.width_div = 8
    cfg.joint.convlstm_features = 8
    cfg.joint.sequence_length = 3
    cfg.train.max_boxes_per_image = 8
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def run(cfg, workdir, **kw):
    return trainer.simult_multi_obj_detection_tracking(
        cfg, synthetic=True, epochs=1, workdir=str(workdir), image_size=64,
        device='cpu', **kw)


def checkpoints(workdir):
    return sorted(os.listdir(os.path.join(workdir, 'models', 'multi_obj')))


@pytest.mark.parametrize('device_data', [True, False])
def test_flow_one_epoch_then_resume(tmp_path, device_data):
    state = run(small_config(device_data=device_data), tmp_path)
    steps = state.step
    assert steps == 20                  # 2 videos x (12 - 3 + 1) windows
    assert checkpoints(tmp_path) == ['ckpt_1.json', 'ckpt_1.pt']
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    log = os.path.join(tmp_path, 'logs', 'run_1', 'metrics.jsonl')
    with open(log) as f:
        records = [json.loads(line) for line in f]
    assert {'train/loss', 'train/track_recall'} <= set(records[0])
    assert any('val/loss' in r for r in records)

    resumed = run(small_config(device_data=device_data, resume=True,
                               resume_lr=3e-5), tmp_path)
    assert resumed.step == 2 * steps
    assert resumed.learning_rate == pytest.approx(3e-5)
    assert 'ckpt_2.pt' in checkpoints(tmp_path)


def test_resume_lr_without_checkpoint_raises(tmp_path):
    with pytest.raises(RuntimeError, match='no checkpoint was restored'):
        run(small_config(resume=True, resume_lr=1e-5), tmp_path)


@pytest.mark.parametrize('option', ['time_shards', 'moe_experts',
                                    'pp_layers', 'profile_dir', 'mesh'])
def test_later_options_raise(tmp_path, option, monkeypatch):
    """The options once refused run through the flow (one synthetic video
    here). In one process the mesh's data axis holds one rank, so
    time_shards=2 raises as JAX's model does on one device (its 2-rank
    run is in test_torch_parallel_flows.py); pp_layers without a stacked
    layer changes nothing, as in JAX."""
    import torch.distributed as dist
    from torch_ranks import one_rank_world
    orig = trainer._synthetic_dirs
    monkeypatch.setattr(
        trainer, '_synthetic_dirs',
        lambda cfg, size, labels, workdir=None: orig(
            cfg, size, labels, frames=5, videos=1, workdir=workdir))
    cfg = small_config()
    kw = {}
    if option == 'time_shards':
        cfg.joint.time_shards = 2
        cfg.joint.sequence_length = 4
        with pytest.raises(ValueError, match="time_shards=2 must equal the "
                           "mesh 'data' axis size 1"):
            run(cfg, tmp_path)
        return
    if option == 'profile_dir':
        kw['profile_dir'] = str(tmp_path / 'trace')
    elif option != 'mesh':
        setattr(cfg.joint, option, 2)
    with (one_rank_world(cfg, tmp_path) if option == 'mesh'
          else contextlib.nullcontext()):
        state = run(cfg, tmp_path, **kw)
        if option == 'mesh':
            assert dist.get_world_size() == 1
    assert state.step == 3                   # 5 frames, T=3: 3 windows
    if option == 'moe_experts':
        assert state.model.tconv_moe.w1.shape[0] == 2
    if option == 'profile_dir':
        assert any(f.endswith('.pt.trace.json')
                   for f in os.listdir(tmp_path / 'trace'))


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer.simult_multi_obj_detection_tracking(
            small_config(), workdir=str(tmp_path))


def test_init_like_flax():
    model = init_like_flax(MultiObjDetTracker(num_classes=2, width_div=4,
                                              convlstm_features=8), 0)
    conv = model.detector.conv_16.weight          # 256 x 128 x 3 x 3
    fan_in = conv[0].numel()
    assert abs(float(conv.std()) * fan_in ** 0.5 - 1.0) < 0.01
    assert float(conv.abs().max()) <= 2.0 / 0.8796256 / fan_in ** 0.5
    assert not model.detector.conv_23.bias.any()
    f = 8
    bias = model.tconv_lstm.input_proj.bias
    assert bias[f:2 * f].eq(1).all() and bias[:f].eq(0).all()
    rk = model.tconv_lstm.recurrent_kernel.reshape(4 * f, -1)
    torch.testing.assert_close(rk @ rk.T, torch.eye(4 * f), atol=1e-5,
                               rtol=0)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert m.weight.eq(1).all() and m.bias.eq(0).all()
    again = init_like_flax(MultiObjDetTracker(num_classes=2, width_div=4,
                                              convlstm_features=8), 0)
    assert torch.equal(again.detector.conv_1.weight,
                       model.detector.conv_1.weight)


def test_darknet_backbone_then_head_rerandomized(monkeypatch):
    """weights_path: every backbone tensor and statistic comes from the
    detector, the head conv_23 is drawn anew (N(0,1) / (GH·GW))."""
    source = init_like_flax(Darknet19(num_classes=80, width_div=8), 3)
    with torch.no_grad():
        for m in source.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.uniform_(-1, 1)
                m.running_var.uniform_(0.5, 1.5)

    class Detector:
        def __init__(self, config, device):
            assert device == 'cpu' and config.weights_path == 'yolo.weights'
            self.model = source

    monkeypatch.setattr('object_tracking_tpu_torch.models.YOLOv2Detector',
                        Detector)
    cfg = small_config()
    cfg.detector.weights_path = 'yolo.weights'
    model = init_like_flax(MultiObjDetTracker(num_classes=2, width_div=8,
                                              convlstm_features=8), 0)
    trainer._load_darknet_backbone(model, cfg, 2, 2)
    mine, theirs = model.detector.state_dict(), source.state_dict()
    for k, v in mine.items():
        if k.startswith('conv_23'):
            assert v.shape != theirs[k].shape
            assert 0.05 < float(v.std()) < 0.5      # N(0,1) / 4
        else:
            assert torch.equal(v, theirs[k]), k
    assert np.isfinite(model.detector.conv_23.weight.detach().numpy()).all()
