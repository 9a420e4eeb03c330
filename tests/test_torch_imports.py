"""Import hygiene of the port: no JAX and nothing of the JAX package.

A fresh interpreter imports every module of object_tracking_tpu_torch and
chip_smoke.py and must end with no `jax*`, `flax*`, `optax*`, `orbax*` or
`object_tracking_tpu.*` module loaded (nor `cv2`, which the card's machine
lacks: it is imported where images are read or drawn); an AST scan of the same files finds
no such import statement, including imports inside functions.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / 'object_tracking_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'object_tracking_tpu')


def _port_files():
    return sorted(PACKAGE.rglob('*.py')) + [REPO / 'chip_smoke.py']


def _modules():
    names = []
    for path in sorted(PACKAGE.rglob('*.py')):
        parts = path.relative_to(REPO).with_suffix('').parts
        if parts[-1] == '__init__':
            parts = parts[:-1]
        names.append('.'.join(parts))
    return names


def _forbidden(name: str) -> bool:
    return name.split('.')[0] in FORBIDDEN


def test_package_has_the_slice_modules():
    names = set(_modules())
    for module in ('config', 'convert', 'inference', 'evaluation',
                   'ops.boxes', 'ops.nms', 'ops.decode', 'ops.matching',
                   'ops.weights', 'ops.caffemodel', 'ops.cuda.nms',
                   'ops.cuda.decode_nms', 'ops.cuda._build',
                   'models.darknet19', 'models.convlstm',
                   'models.multi_obj_det_tracker', 'models.yolov2',
                   'models.darknet_cfg', 'models.vgg16', 'models.losses',
                   'ops.targets', 'data', 'data.augment', 'data.voc',
                   'data.windows', 'data.generators', 'data.synthetic',
                   'training', 'training.state', 'training.steps',
                   'training.callbacks', 'training.metrics',
                   'training.checkpoint', 'training.loop', 'trainer',
                   'ops.heatmap', 'models.fake_detector',
                   'models.tiny_tracker', 'serving', 'data.converters',
                   'models.moe_head', 'parallel', 'parallel.mesh',
                   'parallel.collectives', 'parallel.context',
                   'parallel.pipeline', 'parallel.expert', 'utils',
                   'utils.profiling', 'parallel.sharding',
                   'data.native_loader'):
        assert f'object_tracking_tpu_torch.{module}' in names
    from object_tracking_tpu_torch import trainer
    from object_tracking_tpu_torch.models.convlstm import StackedConvLSTM
    for flow in ('single_object_tracking',
                 'simult_multi_obj_detection_tracking',
                 'keras_yolo_obj_detection', 'evaluate_tracking',
                 'export_serving', 'track_video', 'convert_dataset', 'main'):
        assert callable(getattr(trainer, flow)), flow
    assert StackedConvLSTM.__module__.endswith('models.convlstm')
    for source in ('nms_scores.cu', 'decode_nms.cu'):
        assert (PACKAGE / 'ops' / 'cuda' / 'csrc' / source).is_file()


def test_importing_the_port_loads_no_jax():
    code = (
        'import importlib, json, sys\n'
        f'sys.path.insert(0, {str(REPO)!r})\n'
        f'for name in {_modules()!r} + ["chip_smoke"]:\n'
        '    importlib.import_module(name)\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert 'object_tracking_tpu_torch.inference' in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert 'cv2' not in loaded


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f'{path.name}:{node.lineno} imports {bad}'
