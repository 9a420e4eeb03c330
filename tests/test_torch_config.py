"""The port's own copy of the config constants and fields equals the JAX
package's (the port may not import it)."""

import dataclasses

import pytest

from object_tracking_tpu import config as jcfg
from object_tracking_tpu_torch import config as tcfg


@pytest.mark.parametrize('name', ['YOLOV2_ANCHORS', 'TRACK_GATE_IOU',
                                  'LABELS_MOT17', 'LABELS_COCO'])
def test_constants_equal(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize('cls', ['DetectorConfig', 'LossConfig',
                                 'TrackerConfig', 'JointConfig',
                                 'TrainConfig', 'MeshConfig'])
def test_config_fields_have_the_jax_defaults(cls):
    port, ref = getattr(tcfg, cls)(), getattr(jcfg, cls)()
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(ref, field.name), \
            field.name


def test_detector_config_num_classes():
    assert tcfg.DetectorConfig().num_classes == \
        jcfg.DetectorConfig().num_classes == 80
    assert tcfg.DetectorConfig(labels=('a', 'b')).num_classes == 2


def test_config_holds_the_ported_sections():
    cfg = tcfg.Config()
    assert [f.name for f in dataclasses.fields(cfg)] == [
        'detector', 'loss', 'tracker', 'joint', 'train', 'mesh']
    ref = jcfg.Config()
    for name in ('detector', 'loss', 'tracker', 'joint', 'train', 'mesh'):
        assert type(getattr(cfg, name)).__name__ == \
            type(getattr(ref, name)).__name__
