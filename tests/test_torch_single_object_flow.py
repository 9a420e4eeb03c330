"""The port's single-object and detector training flows,
`trainer.single_object_tracking` and `trainer.keras_yolo_obj_detection`,
on the CPU (`device='cpu'`), mirroring tests/test_trainer.py.

Small size, as tests/test_trainer.py: 64² frames (one synthetic video of 5
frames), width_div=8, LSTM-16, 8² heatmaps, T=3, B=2, one epoch, then a
resume from the checkpoint it wrote. Also: the prior-source dispatch and
its feature-layer fallbacks, the residual+bce refusal, a multi-process
config (a world of one rank, each step on its slice of the batch), and
the default device.
"""

import json
import os

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch import trainer
from object_tracking_tpu_torch.config import Config
from object_tracking_tpu_torch.models import (CfgDetector, FakeDetector,
                                              VGG16PriorSource,
                                              YOLOv2Detector)
from tests.test_darknet_cfg import TINY_CFG, V3_CFG


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """One synthetic video of 5 frames, and one intra-op thread beside the
    other test workers."""
    orig = trainer._synthetic_dirs
    monkeypatch.setattr(
        trainer, '_synthetic_dirs',
        lambda cfg, image_size, labels, frames=5, videos=1, workdir=None:
            orig(cfg, image_size, labels, frames=frames, videos=videos,
                 workdir=workdir))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(**tracker):
    cfg = Config()
    cfg.detector.image_h = cfg.detector.image_w = 64
    cfg.detector.grid_h = cfg.detector.grid_w = 2
    cfg.detector.batch_size = 4
    cfg.detector.width_div = 8
    cfg.tracker.sequence_length = 3
    cfg.tracker.lstm_units = 16
    cfg.tracker.heatmap_size = 8
    cfg.train.batch_size = 2
    cfg.train.max_epochs = 1
    cfg.train.augment = False
    for k, v in tracker.items():
        setattr(cfg.tracker, k, v)
    return cfg


def single(cfg, workdir, **kw):
    return trainer.single_object_tracking(cfg, synthetic=True, epochs=1,
                                          workdir=str(workdir),
                                          device='cpu', **kw)


def saved(workdir, name):
    return sorted(os.listdir(os.path.join(workdir, 'models', name)))


@pytest.mark.parametrize('tracker,augment', [
    (dict(), False),
    (dict(name='TinyHeatmapTracker'), False),
    (dict(residual=True, loss='huber', det_dropout=0.3), True)],
    ids=['bbox', 'heatmap', 'residual_huber_augment'])
def test_single_object_flow_then_resume(tmp_path, tracker, augment):
    cfg = tiny_cfg(**tracker)
    cfg.train.augment = augment
    state = single(cfg, tmp_path)
    first = state.step
    assert first == 1                         # 3 windows of 3, B=2
    assert saved(tmp_path, 'tiny_tracker') == ['ckpt_1.json', 'ckpt_1.pt']
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    log = os.path.join(tmp_path, 'logs', 'run_1', 'metrics.jsonl')
    with open(log) as f:
        records = [json.loads(line) for line in f]
    assert np.isfinite(records[0]['train/loss'])
    assert any('val/loss' in r for r in records)
    if cfg.tracker.name == 'TinyHeatmapTracker':
        assert state.model.out_dim == 64
        assert any('val/heatmap_acc' in r for r in records)

    cfg.train.resume = True
    cfg.train.resume_lr = 3e-4
    resumed = single(cfg, tmp_path)
    assert resumed.step == 2 * first
    assert resumed.learning_rate == pytest.approx(3e-4)
    assert 'ckpt_2.pt' in saved(tmp_path, 'tiny_tracker')


def test_single_object_flow_over_a_vgg16_prior(tmp_path):
    """backend 'vgg16': the feature layer falls back to its fc7 vector
    (a 1x1xfc volume) and the prior's own head gives the detections."""
    cfg = tiny_cfg()
    cfg.detector.backend = 'vgg16'
    src = VGG16PriorSource(image_h=64, image_w=64, det_labels=('1',),
                           conf_threshold=0.05, width_div=8, fc_features=32,
                           device='cpu')
    state = single(cfg, tmp_path, detector=src)
    assert state.step == 1
    assert state.model.lstm.weight_ih.shape[1] == 32 + 4


def test_residual_with_bce_raises(tmp_path):
    with pytest.raises(ValueError, match="requires tracker.loss='huber'"):
        single(tiny_cfg(residual=True), tmp_path)


def test_prior_source_dispatch_and_feature_layers(monkeypatch):
    cfg = tiny_cfg()
    labels = ('1',)
    fake = trainer._prior_source(cfg, labels, True, 'cpu')
    assert isinstance(fake, FakeDetector)
    assert trainer._feature_layer(cfg, fake) == 'conv_feat'
    # no weights: the fake; weights: YOLOv2Detector
    assert isinstance(trainer._prior_source(cfg, labels, False, 'cpu'),
                      FakeDetector)
    monkeypatch.setattr(YOLOv2Detector, 'load_darknet_weights',
                        lambda self, path: None)
    cfg.detector.weights_path = 'yolo.weights'
    yolo = trainer._prior_source(cfg, labels, False, 'cpu')
    assert isinstance(yolo, YOLOv2Detector) and yolo.device.type == 'cpu'
    assert trainer._feature_layer(cfg, yolo) == 'conv_feat'
    # a cfg path comes before the weights, and exposes 'final'
    cfg.detector.weights_path = None
    cfg.detector.cfg_path = TINY_CFG
    net = trainer._prior_source(cfg, labels, False, 'cpu')
    assert isinstance(net, CfgDetector)
    assert trainer._feature_layer(cfg, net) == 'final'
    # backend vgg16 comes first of all
    cfg.detector.backend = 'vgg16'
    cfg.detector.vgg_width_div, cfg.detector.vgg_fc_features = 8, 16
    vgg = trainer._prior_source(cfg, labels, False, 'cpu')
    assert isinstance(vgg, VGG16PriorSource)
    assert trainer._feature_layer(cfg, vgg) == 'fc7'
    assert vgg.get_layer_dims('fc7') == (1, 1, 16)


def detect(cfg, workdir, **kw):
    return trainer.keras_yolo_obj_detection(
        cfg, synthetic=True, epochs=1, workdir=str(workdir), train=True,
        device='cpu', **kw)


@pytest.mark.parametrize('cfg_text', [None, TINY_CFG, V3_CFG],
                         ids=['yolov2', 'region_cfg', 'yolo_heads_cfg'])
def test_detector_flow_then_resume(tmp_path, cfg_text):
    cfg = tiny_cfg()
    if cfg_text is not None:
        path = tmp_path / 'net.cfg'
        path.write_text(cfg_text)
        cfg.detector.cfg_path = str(path)
    state = detect(cfg, tmp_path)
    assert state.step == 2                    # 5 frames, B=4, last one kept
    assert saved(tmp_path, 'yolov2') == ['ckpt_1.json', 'ckpt_1.pt']
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    # the flow logs every 10th step (fit's default, as in JAX); the
    # checkpoint records the monitored (train) loss
    with open(os.path.join(tmp_path, 'models', 'yolov2', 'ckpt_1.json')) as f:
        assert np.isfinite(json.load(f)['val_loss'])
    cfg.train.resume = True
    resumed = detect(cfg, tmp_path)
    assert resumed.step == 4
    assert 'ckpt_2.pt' in saved(tmp_path, 'yolov2')


def test_detector_predict_over_an_image(tmp_path):
    import cv2
    cfg = tiny_cfg()
    img = (np.random.RandomState(0).rand(64, 64, 3) * 255).astype('uint8')
    path = str(tmp_path / 'frame.jpg')
    cv2.imwrite(path, img)
    results = trainer.keras_yolo_obj_detection(cfg, images=[path],
                                               out_dir=str(tmp_path),
                                               device='cpu')
    assert list(results) == [path] and isinstance(results[path], list)
    assert os.path.exists(tmp_path / 'frame_out.jpg')


@pytest.mark.parametrize('flow', ['single', 'detect'])
def test_default_device_is_the_card(tmp_path, monkeypatch, flow):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        if flow == 'single':
            trainer.single_object_tracking(tiny_cfg(), workdir=str(tmp_path))
        else:
            trainer.keras_yolo_obj_detection(tiny_cfg())


@pytest.mark.parametrize('flow', ['single', 'detect'])
def test_multi_host_waits(tmp_path, flow, monkeypatch):
    """`mesh.distributed` no longer waits: the flow joins the configured
    world (one gloo rank here), each train step takes this rank's slice
    of the global batch from `shard_batch` (over a data axis of 1, all of
    it, sliced and not replicated), and rank 0 writes the checkpoint."""
    import torch.distributed as dist
    from object_tracking_tpu_torch import training
    from object_tracking_tpu_torch.parallel import ShardedBatch
    from torch_ranks import one_rank_world
    name = ('make_tiny_train_step' if flow == 'single'
            else 'make_detector_train_step')
    factory, seen = getattr(training, name), []

    def spy(*args, **kw):
        step = factory(*args, **kw)

        def run(state, batch):
            seen.append(batch)
            return step(state, batch)
        return run

    monkeypatch.setattr(training, name, spy)
    cfg = tiny_cfg()
    with one_rank_world(cfg, tmp_path):
        state = single(cfg, tmp_path) if flow == 'single' else \
            detect(cfg, tmp_path)
        assert dist.is_initialized() and dist.get_world_size() == 1
    assert state.step > 0
    assert all(isinstance(b, ShardedBatch) and not b.replicated
               for b in seen)
    key = 'feats' if flow == 'single' else 'images'
    assert [len(b[key]) for b in seen] == ([2] if flow == 'single'
                                           else [4, 1])
    name = 'tiny_tracker' if flow == 'single' else 'yolov2'
    assert saved(tmp_path, name) == ['ckpt_1.json', 'ckpt_1.pt']


def test_not_ported_names_only_what_waits():
    """Nothing waits: the refusal list is gone, and the joint options it
    named build their model (the dense eval model without a mesh; with
    a one-rank mesh the pipelined stack holds its single stage)."""
    from object_tracking_tpu_torch.parallel import Mesh
    assert not hasattr(trainer, '_not_ported')
    cfg = tiny_cfg()
    cfg.joint.moe_experts = 4
    cfg.joint.convlstm_layers = 2
    cfg.joint.pp_layers = True
    cfg.joint.convlstm_features = 8
    dense = trainer._joint_model(cfg, ('a', 'b'))
    assert dense.tconv_moe.w1.shape[0] == 4
    assert not dense.tconv_stack.pipeline
    piped = trainer._joint_model(cfg, ('a', 'b'),
                                 Mesh({'data': 1, 'model': 1}))
    assert piped.tconv_stack.pipeline
    for name, p in dense.state_dict().items():
        assert torch.equal(piped.state_dict()[name], p), name
