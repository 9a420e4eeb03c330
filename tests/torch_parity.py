"""Shared helpers of the tests/test_torch_*.py parity tests."""

import jax
import numpy as np


def numpy_tree(tree):
    """A flax variables tree with every leaf copied to a numpy array."""
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def randomize_bn(variables, rng):
    """numpy copy of `variables` with random BatchNorm scale/bias/mean/var,
    so that the running-statistics mode is not an identity."""
    v = numpy_tree(dict(variables))

    def walk(node, name=''):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, key)
            elif name.startswith('norm_'):
                if key in ('scale', 'var'):
                    node[key] = rng.uniform(0.5, 1.5, val.shape)
                else:
                    node[key] = rng.normal(0, 0.1, val.shape)
                node[key] = node[key].astype(np.float32)
    walk(v['params'])
    walk(v['batch_stats'])
    return v


def share_native_library(monkeypatch):
    """Hand the JAX package's native binding the library that the port's
    binding built from the same source with the same flags (or, where the
    port's cannot build, no library, so that both decode with cv2): the
    two generators then decode with one decoder, and no test makes the JAX
    binding run `make` in native/. Returns whether the library is there."""
    from object_tracking_tpu.data import native_loader as jax_native
    from object_tracking_tpu_torch.data import native_loader
    lib = native_loader.load_library()
    monkeypatch.setattr(jax_native, '_lib', lib)
    monkeypatch.setattr(jax_native, '_build_failed', lib is None)
    return lib is not None


def jax_own_native_library(monkeypatch):
    """Load the JAX binding's own build, native/libottdata.so, with
    `load_library(build=False)`, where it is there, newer than its source
    and of the binding's ABI: the binding then reads the file and runs no
    `make`. Returns whether it loaded; where not, the binding is left as
    it was."""
    import ctypes
    import os
    from object_tracking_tpu.data import native_loader as jax_native
    so = os.path.join(jax_native._NATIVE_DIR, 'libottdata.so')
    src = os.path.join(jax_native._NATIVE_DIR, 'ott_dataio.cpp')
    try:
        if os.path.getmtime(src) > os.path.getmtime(so):
            return False
        if ctypes.CDLL(so).ott_version() != jax_native._ABI_VERSION:
            return False
    except OSError:                     # no build there, or not loadable
        return False
    monkeypatch.setattr(jax_native, '_lib', None)
    monkeypatch.setattr(jax_native, '_build_failed', False)
    return jax_native.load_library(build=False) is not None
