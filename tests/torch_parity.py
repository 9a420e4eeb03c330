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
