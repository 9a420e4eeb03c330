"""Convert between a flax variables tree and a torch state_dict.

`from_flax` takes `{'params': ..., 'batch_stats': ...}` as nested dicts of
numpy arrays (convert JAX arrays with `np.asarray` first: this module never
imports JAX) and returns the state_dict of the matching port module:
`MultiObjDetTracker`, `Darknet19`, `FusedConvLSTM`, `DarknetCfgNet`,
`VGG16` or `TinyTracker`. Leaves are copied, never shared with the numpy
arrays.

- conv `kernel` (kh, kw, in, out) HWIO → `weight` (out, in, kh, kw) OIHW;
- `tconv_lstm/recurrent_kernel` (kh, kw, F, 4F) → (4F, F, kh, kw), the
  same transpose, keeping the gate order (i, f, g, o) along the output
  channel;
- the deep head's `tconv_stack/{input_kernel, recurrent_kernel}`
  (L, kh, kw, F, 4F) → (L, 4F, F, kh, kw), the same transpose per layer
  of the leading L axis, and `tconv_stack/input_bias` (L, 4F) as it is;
- the MoE head's `tconv_moe/{gate, w1, b1, w2, b2}` as they are (the
  port keeps JAX's layout: gate (D, E), w1 (E, D, H), b1 (E, H),
  w2 (E, H, O), b2 (E, O));
- Dense `kernel` (in, out) → `weight` (out, in);
- `bias` → `bias`;
- BatchNorm `scale` / `bias` and batch_stats `mean` / `var` → `weight` /
  `bias` / `running_mean` / `running_var`;
- an `OptimizedLSTMCell_<n>` (gates `ii/if/ig/io`, kernel (in, H) each,
  and `hi/hf/hg/ho`, kernel (H, H) and bias each) → the sibling module
  `lstm` of `models/tiny_tracker.py::LSTM`: `weight_ih` (4H, in) and
  `weight_hh` (4H, H), the gate kernels stacked (i, f, g, o) and
  transposed, and `bias` (4H) from the four recurrent biases.

A leaf that no rule maps, an LSTM cell missing a gate, or a BatchNorm
missing one of its four entries, raises; `load_state_dict(strict=True)`
then catches any key the module has and the tree lacks.

`to_flax` is its inverse: a state_dict → the same nested numpy tree, which
the darknet exporters (`ops/weights.py`, `models/darknet_cfg.py`) write.

`load_flax_train_state` carries a JAX `TrainState` into the port's: the
step, params and batch stats, and Adam's `count`, `mu` and `nu` (optax's
`ScaleByAdamState`, whose trees take the params' transposes) with the
injected learning rate, so that a JAX run resumed in the port continues
the same trajectory.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

_MOE_LEAVES = ('gate', 'w1', 'b1', 'w2', 'b2')
_PARAM_LEAVES = {'kernel': 'weight', 'recurrent_kernel': 'recurrent_kernel',
                 'input_kernel': 'input_kernel', 'input_bias': 'input_bias',
                 'bias': 'bias', 'scale': 'weight',
                 **{k: k for k in _MOE_LEAVES}}
_STACKED_KERNELS = ('input_kernel', 'recurrent_kernel')
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var'}
_NORM_KEYS = ('weight', 'bias', 'running_mean', 'running_var')


_INPUT_GATES = ('ii', 'if', 'ig', 'io')
_HIDDEN_GATES = ('hi', 'hf', 'hg', 'ho')


def _tensor(path: Tuple[str, ...], leaf: str, value: np.ndarray):
    if leaf == 'kernel' and value.ndim == 2:
        value = value.T                                 # Dense (in, out)
    elif leaf in _STACKED_KERNELS and value.ndim == 5:
        value = value.transpose(0, 4, 3, 1, 2)         # L,HWIO → L,OIHW
    elif leaf in ('kernel',) + _STACKED_KERNELS:
        if value.ndim != 4:
            raise ValueError(f'{"/".join(path)}: expected a 4-d conv, a '
                             f'5-d stacked conv or a 2-d dense kernel, got '
                             f'shape {value.shape}')
        value = value.transpose(3, 2, 0, 1)            # HWIO → OIHW
    return torch.from_numpy(np.array(value, dtype=np.float32, order='C'))


def _lstm_cell(path: Tuple[str, ...], cell: Dict, state) -> None:
    """One flax OptimizedLSTMCell (or a tree shaped like its params: the
    gradients, Adam's moments) → `lstm.weight_ih` / `weight_hh` / `bias`
    of the sibling module `lstm`."""
    where = '/'.join(path)
    unknown = set(cell) - set(_INPUT_GATES + _HIDDEN_GATES)
    missing = set(_INPUT_GATES + _HIDDEN_GATES) - set(cell)
    if unknown or missing:
        raise KeyError(f'{where}: unused gates {sorted(unknown)}, missing '
                       f'{sorted(missing)}')
    for gate in _INPUT_GATES + _HIDDEN_GATES:
        want = {'kernel'} if gate in _INPUT_GATES else {'kernel', 'bias'}
        if set(cell[gate]) != want:
            raise KeyError(f'{where}/{gate}: keys {sorted(cell[gate])}, '
                           f'expected {sorted(want)}')

    def stack(gates, leaf, axis):
        return np.concatenate([np.asarray(cell[g][leaf], np.float32)
                               for g in gates], axis=axis)
    prefix = '.'.join(path[:-1] + ('lstm',))
    for name, value in (('weight_ih', stack(_INPUT_GATES, 'kernel', 1).T),
                        ('weight_hh', stack(_HIDDEN_GATES, 'kernel', 1).T),
                        ('bias', stack(_HIDDEN_GATES, 'bias', 0))):
        state[f'{prefix}.{name}'] = torch.from_numpy(
            np.ascontiguousarray(value))


def _collection(tree, collection: str, rules, state, norms,
                path: Tuple[str, ...] = ()) -> None:
    """Map one flax collection's leaves into `state` (name → tensor),
    adding each BatchNorm's module name to `norms`."""
    for key, node in tree.items():
        if key.startswith('OptimizedLSTMCell') and isinstance(node, dict):
            _lstm_cell(path + (key,), node, state)
        elif isinstance(node, dict):
            _collection(node, collection, rules, state, norms, path + (key,))
        else:
            _leaf(path + (key,), np.asarray(node), collection, rules, state,
                  norms)


def _leaf(path: Tuple[str, ...], value: np.ndarray, collection: str, rules,
          state, norms) -> None:
    *module, leaf = path
    if leaf not in rules:
        raise KeyError(f'unused key {collection}/{"/".join(path)}')
    if leaf in ('scale', 'mean', 'var'):
        norms.add('.'.join(module))
    state['.'.join(module + [rules[leaf]])] = _tensor(path, leaf, value)


def from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax {'params', 'batch_stats'} (numpy leaves) → torch state_dict."""
    unknown = set(variables) - {'params', 'batch_stats'}
    if unknown:
        raise KeyError(f'unused collections: {sorted(unknown)}')
    state: Dict[str, torch.Tensor] = {}
    norms = set()
    for collection, rules in (('params', _PARAM_LEAVES),
                              ('batch_stats', _STAT_LEAVES)):
        _collection(variables.get(collection, {}), collection, rules, state,
                    norms)
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
        module, _, leaf = key.rpartition('.')
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
        elif leaf in _STACKED_KERNELS and value.ndim == 5:
            collection, name = 'params', leaf
            value = value.transpose(0, 3, 4, 2, 1)      # L,OIHW → L,HWIO
        elif leaf in ('bias', 'input_bias') + _MOE_LEAVES:
            collection, name = 'params', leaf
        else:
            raise KeyError(f'no flax name for {key} {tuple(value.shape)}')
        node = tree[collection]
        for part in module.split('.') if module else ():
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(value)
    if not tree['batch_stats']:
        del tree['batch_stats']
    return tree


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A tree shaped like flax 'params' (the params, their gradients, or
    Adam's moments; numpy leaves) → {parameter name: tensor}, with the
    parameters' transposes and no BatchNorm statistics."""
    named: Dict[str, torch.Tensor] = {}
    _collection(tree, 'params', _PARAM_LEAVES, named, set())
    return named


def load_flax_train_state(state, *, step, params: Dict, batch_stats: Dict,
                          count, mu: Dict, nu: Dict, learning_rate: float):
    """Load a JAX TrainState, given as numpy (`step`; `params` and
    `batch_stats` trees; the optax Adam state's `count`, `mu` and `nu`,
    trees shaped like `params`; the injected `learning_rate`), into the
    port's `state` (a `training.state.TrainState`), in place; returns it.

    Adam's first and second moments take the same transposes (and LSTM
    gate stacking) as their parameters; each parameter's Adam step is
    `count`."""
    state.model.load_state_dict(
        from_flax({'params': params, 'batch_stats': batch_stats}),
        strict=True)
    moments = [params_from_flax(mu), params_from_flax(nu)]
    opt = state.optimizer
    for name, p in state.model.named_parameters():
        opt.state[p] = {
            'step': torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            'exp_avg': moments[0][name].to(p.device),
            'exp_avg_sq': moments[1][name].to(p.device)}
    state.with_learning_rate(float(np.asarray(learning_rate)))
    state.step = int(np.asarray(step))
    return state
