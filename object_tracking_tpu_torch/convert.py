"""Convert a flax variables tree of the JAX package to a torch state_dict.

`from_flax` takes `{'params': ..., 'batch_stats': ...}` as nested dicts of
numpy arrays (convert JAX arrays with `np.asarray` first: this module never
imports JAX) and returns the state_dict of the matching port module:
`MultiObjDetTracker`, `Darknet19` or `FusedConvLSTM`.

- conv `kernel` (kh, kw, in, out) HWIO → `weight` (out, in, kh, kw) OIHW;
- `tconv_lstm/recurrent_kernel` (kh, kw, F, 4F) → (4F, F, kh, kw), the
  same transpose, keeping the gate order (i, f, g, o) along the output
  channel;
- `bias` → `bias`;
- BatchNorm `scale` / `bias` and batch_stats `mean` / `var` → `weight` /
  `bias` / `running_mean` / `running_var`.

A leaf that no rule maps, or a BatchNorm missing one of its four
entries, raises; `load_state_dict(strict=True)` then catches any key the
module has and the tree lacks.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {'kernel': 'weight', 'recurrent_kernel': 'recurrent_kernel',
                 'bias': 'bias', 'scale': 'weight'}
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var'}
_NORM_KEYS = ('weight', 'bias', 'running_mean', 'running_var')


def _leaves(tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _tensor(path: Tuple[str, ...], leaf: str, value: np.ndarray):
    if leaf in ('kernel', 'recurrent_kernel'):
        if value.ndim != 4:
            raise ValueError(f'{"/".join(path)}: expected a 4-d conv kernel, '
                             f'got shape {value.shape}')
        value = value.transpose(3, 2, 0, 1)            # HWIO → OIHW
    return torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))


def from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax {'params', 'batch_stats'} (numpy leaves) → torch state_dict."""
    unknown = set(variables) - {'params', 'batch_stats'}
    if unknown:
        raise KeyError(f'unused collections: {sorted(unknown)}')
    state: Dict[str, torch.Tensor] = {}
    norms = set()
    for collection, rules in (('params', _PARAM_LEAVES),
                              ('batch_stats', _STAT_LEAVES)):
        for path, value in _leaves(variables.get(collection, {})):
            *module, leaf = path
            if leaf not in rules:
                raise KeyError(f'unused key {collection}/{"/".join(path)}')
            if leaf in ('scale', 'mean', 'var'):
                norms.add('.'.join(module))
            name = '.'.join(module + [rules[leaf]])
            state[name] = _tensor(path, leaf, value)
    for norm in sorted(norms):
        missing = [k for k in _NORM_KEYS if f'{norm}.{k}' not in state]
        if missing:
            raise KeyError(f'missing key(s) for BatchNorm {norm}: {missing}')
    return state
