"""Nothing the benchmark loads is JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's own name begins with the JAX
package's)."""

import subprocess
import sys

from portbench.cells import ROOT

SCRIPT = '''
import sys
import portbench.run, portbench.control, portbench.cells
from portbench.tests import tiny
for name in ('joint_live_b1', 'yolov2_train_b32'):
    tiny.run(name)
from portbench.run import loaded_forbidden
print('FOUND', loaded_forbidden())
print('TOP', sorted({m.split('.')[0] for m in sys.modules}))
'''


def test_no_jax_is_loaded():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    found = out.stdout.split('FOUND ')[1].splitlines()[0]
    assert found == '[]'
    top = out.stdout.split('TOP ')[1]
    for name in ('jax', 'jaxlib', 'flax', 'object_tracking_tpu'):
        assert f"'{name}'" not in top
    assert "'object_tracking_tpu_torch'" in top


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench.run import loaded_forbidden
    monkeypatch.setitem(sys.modules, 'object_tracking_tpu_torch_x', sys)
    assert loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, 'object_tracking_tpu.ops', sys)
    assert loaded_forbidden() == ['object_tracking_tpu']
