"""The port's config loading against the JAX package's.

Mirrors tests/test_config.py on `object_tracking_tpu_torch.config`: the
reference's legacy config.json layout, the new layout's round trip, and
both read into the same values as JAX's `load_config` reads them (every
field compared, exactly). Then the parallel options the config carries
run through the flows: `mesh.distributed` (a world of one gloo rank in
this process) and `joint.pp_layers`.
"""

import dataclasses
import json

import pytest

from object_tracking_tpu.config import load_config as jload_config
from object_tracking_tpu_torch import trainer
from object_tracking_tpu_torch.config import (Config, JointConfig,
                                              MeshConfig, load_config)
from torch_ranks import one_rank_world

LEGACY = {
    "model_detector": {
        "name": "YOLO",
        "config_file": "cfg/yolov2.cfg",
        "weights_file": "yolov2.weights",
        "fv_layer": 25,
        "nms": 0.4,
        "thresh": 0.6,
    },
    "model_tracker": {
        "name": "TinyHeatmapTracker",
        "lstm_units": 256,
        "sequence_length": 8,
        "heatmap_size": 16,
    },
    "train": {
        "train_image_folder": "data/VisualTB/",
        "train_annot_folder": "data/VisualTB-voc/train",
        "batch_size": 7,
        "max_epochs": 42,
        "pool": "Max",
        "classes": ["person", "car"],
        "debug": True,
        "tensorboard_dir": "logs_x",
        "saved_model_dir": "models_x",
    },
    "val": {
        "val_image_folder": "data/VisualTB/",
        "val_annot_folder": "data/VisualTB-voc/val",
    },
}


def _same_as_jax(cfg, path):
    """Every section and field of `cfg` equals what JAX's load_config
    reads from `path` (JAX has sections the port lacks: none)."""
    ref = jload_config(str(path))
    for section in dataclasses.fields(cfg):
        ours = dataclasses.asdict(getattr(cfg, section.name))
        theirs = dataclasses.asdict(getattr(ref, section.name))
        assert set(ours) <= set(theirs), section.name
        for key, value in ours.items():
            assert value == theirs[key], (section.name, key)


def test_legacy_layout_maps_every_consumed_field(tmp_path):
    p = tmp_path / 'config.json'
    p.write_text(json.dumps(LEGACY))
    cfg = load_config(str(p))
    assert cfg.detector.backend == 'yolo'
    assert cfg.detector.cfg_path == 'cfg/yolov2.cfg'
    assert cfg.detector.weights_path == 'yolov2.weights'
    assert cfg.detector.nms_threshold == 0.4
    assert cfg.detector.obj_threshold == 0.6
    assert cfg.tracker.name == 'TinyHeatmapTracker'
    assert cfg.tracker.lstm_units == 256
    assert cfg.tracker.sequence_length == 8
    assert cfg.tracker.heatmap_size == 16
    assert cfg.tracker.pool == 'Max'
    assert cfg.train.batch_size == 7
    assert cfg.train.max_epochs == 42
    assert cfg.train.classes == ('person', 'car')
    assert cfg.train.debug is True
    assert cfg.train.tensorboard_dir == 'logs_x'
    assert cfg.train.val_annot_folder == 'data/VisualTB-voc/val'
    _same_as_jax(cfg, p)


def test_legacy_fasterrcnn_name_selects_vgg16_backend(tmp_path):
    d = dict(LEGACY)
    d['model_detector'] = {'name': 'FasterRCNN'}
    p = tmp_path / 'config.json'
    p.write_text(json.dumps(d))
    cfg = load_config(str(p))
    assert cfg.detector.backend == 'vgg16'
    _same_as_jax(cfg, p)


def test_new_layout_roundtrip(tmp_path):
    cfg = Config()
    cfg.detector.backend = 'vgg16'
    cfg.joint.convlstm_layers = 3
    cfg.joint.time_shards = 2
    cfg.joint.pp_layers = True
    cfg.mesh.model_parallel = 2
    cfg.train.classes = ('a',)
    p = tmp_path / 'config.json'
    p.write_text(cfg.to_json())
    back = load_config(str(p))
    assert back == cfg
    assert back.joint.convlstm_layers == 3 and back.train.classes == ('a',)
    _same_as_jax(back, p)


def test_jax_written_config_reads_the_same(tmp_path):
    """A config JAX writes (its new layout, all six sections) reads into
    the port's fields unchanged; keys the port has no field for are
    skipped as JAX's from_dict skips them."""
    from object_tracking_tpu.config import Config as JConfig
    ref = JConfig()
    ref.joint.moe_hidden = 64
    ref.joint.convlstm_layers = 2
    ref.mesh.distributed = True
    ref.detector.anchors = (1.0, 2.0)
    p = tmp_path / 'config.json'
    p.write_text(ref.to_json())
    cfg = load_config(str(p))
    assert cfg.joint.moe_hidden == 64 and cfg.mesh.distributed
    assert cfg.detector.anchors == (1.0, 2.0)
    _same_as_jax(cfg, p)
    extra = json.loads(p.read_text())
    extra['joint']['no_such_field'] = 1
    assert Config.from_dict(extra) == cfg


def test_defaults_match_jax():
    from object_tracking_tpu.config import JointConfig as JJoint
    from object_tracking_tpu.config import MeshConfig as JMesh
    for ours, theirs in ((JointConfig(), JJoint()), (MeshConfig(), JMesh())):
        ref = dataclasses.asdict(theirs)
        for key, value in dataclasses.asdict(ours).items():
            assert value == ref[key], key


def _small():
    cfg = Config()
    cfg.detector.image_h = cfg.detector.image_w = 64
    cfg.detector.width_div = 8
    cfg.joint.convlstm_features = 8
    return cfg


@pytest.mark.parametrize('flow', ['joint', 'export', 'single'])
def test_mesh_distributed_is_refused(tmp_path, flow, monkeypatch):
    """`mesh.distributed` runs: the training flows join the process group
    the config names (here a world of this process alone) and lay out
    its mesh; the export flow is one device's and joins none."""
    import torch.distributed as dist
    monkeypatch.setattr(trainer, '_synthetic_dirs', _one_video)
    cfg = _small()
    with one_rank_world(cfg, tmp_path):
        if flow == 'joint':
            state = trainer.simult_multi_obj_detection_tracking(
                cfg, synthetic=True, epochs=1, workdir=str(tmp_path),
                image_size=64, device='cpu')
            assert dist.get_world_size() == 1 and state.step > 0
        elif flow == 'export':
            path = trainer.export_serving(cfg, out_path=str(tmp_path / 'a'),
                                          device='cpu')
            assert (tmp_path / 'a').is_file() and path.endswith('a')
            assert not dist.is_initialized()
        else:
            cfg.train.batch_size = 1
            state = trainer.single_object_tracking(
                cfg, synthetic=True, epochs=1, workdir=str(tmp_path),
                device='cpu')
            assert dist.get_world_size() == 1 and state.step > 0


def test_pp_layers_is_refused(tmp_path, monkeypatch):
    """`joint.pp_layers` pipelines the stacked layers over the mesh's
    model axis, one layer per rank: in one process the model axis holds
    one rank, so a 2-layer stack raises (as JAX's model does on one
    device) and a 1-layer stack trains."""
    monkeypatch.setattr(trainer, '_synthetic_dirs', _one_video)
    cfg = _small()
    cfg.joint.convlstm_layers = 3
    cfg.joint.pp_layers = True
    with pytest.raises(ValueError, match="must equal the mesh 'model' "
                       'axis size 1'):
        trainer.simult_multi_obj_detection_tracking(
            cfg, synthetic=True, epochs=1, workdir=str(tmp_path),
            image_size=64, device='cpu')
    cfg.joint.convlstm_layers = 2
    (tmp_path / 'pp').mkdir()
    state = trainer.simult_multi_obj_detection_tracking(
        cfg, synthetic=True, epochs=1, workdir=str(tmp_path / 'pp'),
        image_size=64, device='cpu')
    assert state.model.tconv_stack.pipeline and state.step > 0


_SYNTHETIC = trainer._synthetic_dirs


def _one_video(cfg, size, labels, frames=5, videos=1, workdir=None):
    return _SYNTHETIC(cfg, size, labels, frames=5, videos=1, workdir=workdir)
