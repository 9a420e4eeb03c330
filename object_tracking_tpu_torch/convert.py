"""Convert between a flax variables tree and a torch state_dict.

`from_flax` takes `{'params': ..., 'batch_stats': ...}` as nested dicts of
numpy arrays (convert JAX arrays with `np.asarray` first: this module never
imports JAX) and returns the state_dict of the matching port module:
`MultiObjDetTracker`, `Darknet19`, `FusedConvLSTM`, `DarknetCfgNet` or
`VGG16`. Leaves are copied, never shared with the numpy arrays.

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

`to_flax` is its inverse: a state_dict → the same nested numpy tree, which
the darknet exporters (`ops/weights.py`, `models/darknet_cfg.py`) write.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

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
    return torch.from_numpy(np.array(value, dtype=np.float32, order='C'))


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


def to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """torch state_dict → flax {'params', 'batch_stats'} of numpy arrays:
    the inverse of `from_flax`."""
    norms = {k.rsplit('.', 1)[0] for k in state
             if k.endswith('.running_mean')}
    tree: Dict[str, Any] = {'params': {}, 'batch_stats': {}}
    for key, value in state.items():
        module, leaf = key.rsplit('.', 1)
        value = value.detach().cpu().float().numpy()
        if module in norms:
            collection, name = {
                'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
                'running_mean': ('batch_stats', 'mean'),
                'running_var': ('batch_stats', 'var')}[leaf]
        elif leaf in ('weight', 'recurrent_kernel') and value.ndim == 4:
            collection, name = 'params', ('kernel' if leaf == 'weight'
                                          else leaf)
            value = value.transpose(2, 3, 1, 0)            # OIHW → HWIO
        elif leaf == 'bias':
            collection, name = 'params', 'bias'
        else:
            raise KeyError(f'no flax name for {key} {tuple(value.shape)}')
        node = tree[collection]
        for part in module.split('.'):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(value)
    if not tree['batch_stats']:
        del tree['batch_stats']
    return tree
