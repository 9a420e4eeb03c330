"""Tensor parallelism over the mesh's `model` axis: each rank of a model
group holds a block of every large parameter.

Port of `object_tracking_tpu/parallel/sharding.py`. JAX lays the
parameters out sharded and lets GSPMD partition the convs; the port
partitions them itself, with the collectives of `collectives.py`:

- `plan_tp_specs` applies JAX's rules to the port's layouts: for each
  state_dict name, the axis sharded over `model` (the axis that JAX's
  trailing output axis became under `convert.py`), or None;
- `shard_variables` replaces each planned parameter by this rank's block,
  in place, and records it in its module's `tp_shards`. The model code
  then runs each leaf by one of two routes:
  - *column-parallel*: a conv whose weight is sharded computes only its
    own output channels (`column_conv`): its input enters through
    `replicated_input` (identity forward; backward sums every rank's
    share of dL/dx over the group) and its output leaves through
    `gather_blocks` (all-gather of the channel blocks; backward keeps the
    own block). Darknet-19's convs, `tconv_lstm`'s input projection and
    recurrent conv, the stacked head's convs and `tconv_2` take it, with
    their bias block (a replicated bias is cut to the block by
    `column_block`, its gradient summed over the group);
  - *gathered at use* (`held`): BatchNorm biases and the MoE head's
    leaves are all-gathered where the module reads them; each rank's
    gradient is its own block.
  BatchNorm statistics stay replicated: every rank of a model group
  normalises the same gathered channels over the same data group. The
  gradients of blocks and of replicated leaves are then summed over the
  `data` group alone, as without tensor parallelism;
- `gather_dense` reads sharded tensors back whole (JAX's `np.asarray` of a
  sharded array), and `tp_sharding_summary` counts what the plan split.

Build the optimizer after `shard_variables`, so that its moments live on
the blocks. `DTensor` weights are not used: `F.conv2d` on a weight placed
`Shard(0)` fails in torch's sharding propagation.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from object_tracking_tpu_torch.parallel.collectives import (
    gather_blocks, replicated_input)

_STATS = ('running_mean', 'running_var', 'num_batches_tracked')


class Shard(NamedTuple):
    """A parameter held as block `index` of `size` along `axis`, over the
    model group `group`."""
    group: Any
    index: int
    size: int
    axis: int


def _shapes(model_or_state_dict) -> Dict[str, Tuple[int, ...]]:
    state = (model_or_state_dict.state_dict()
             if isinstance(model_or_state_dict, nn.Module)
             else model_or_state_dict)
    return {k: tuple(v.shape) for k, v in state.items()}


def _output_axis(name: str, ndim: int) -> int:
    """The axis of a port leaf that JAX's trailing (output) axis became."""
    leaf = name.rsplit('.', 1)[-1]
    if '_moe' in name or leaf == 'input_bias':
        return ndim - 1                   # JAX's layout, kept as it is
    if leaf in ('input_kernel', 'recurrent_kernel') and ndim == 5:
        return 1                          # (L, 4F, F, kh, kw)
    return 0                              # OIHW conv, (out, in) dense


def _plan_axis(name: str, shape: Tuple[int, ...], tp: int,
               min_params: int) -> Optional[int]:
    if tp <= 1 or name.rsplit('.', 1)[-1] in _STATS:
        return None
    # MoE expert-stacked leaves shard their leading (expert) axis
    if '_moe' in name and len(shape) >= 2 and shape[0] % tp == 0:
        return 0
    if len(shape) >= 2:
        axis = _output_axis(name, len(shape))
        if shape[axis] % tp == 0 and math.prod(shape) >= min_params:
            return axis
        return None
    if len(shape) == 1 and shape[0] % tp == 0 and shape[0] >= 4 * tp \
            and 'bias' in name:
        return 0
    return None


def plan_tp_specs(model_or_state_dict: Union[nn.Module, Mapping],
                  mesh, model_axis: str = 'model',
                  min_params: int = 1 << 16) -> Dict[str, Optional[int]]:
    """{state_dict name: the axis sharded over `model_axis`, or None}.

    JAX's rules on the port's layouts: a conv or dense weight of at least
    `min_params` elements shards its output channels (axis 0 of OIHW and
    (out, in); axis 1 of the stacked head's (L, 4F, F, kh, kw); the last
    of (L, 4F) `input_bias`) when the axis size divides them; an MoE leaf
    (`_moe` in its name) of two or more axes shards its leading axis when
    it divides; a 1-D `bias` shards when the axis size divides it and it
    has at least 4 elements a rank; BatchNorm statistics and everything
    else replicate. Plan on the dense model (or its state_dict; tensors on
    the `meta` device will do)."""
    return _plan(_shapes(model_or_state_dict), mesh.shape[model_axis],
                 min_params)


def _plan(shapes: Dict[str, Tuple[int, ...]], tp: int, min_params: int
          ) -> Dict[str, Optional[int]]:
    return {name: _plan_axis(name, shape, tp, min_params)
            for name, shape in shapes.items()}


def tp_sharding_summary(model_or_state_dict: Union[nn.Module, Mapping],
                        mesh, model_axis: str = 'model',
                        min_params: int = 1 << 16
                        ) -> Dict[str, Tuple[int, int]]:
    """{'sharded': (leaves, params), 'replicated': (leaves, params)} of
    the plan, for logging what it splits."""
    shapes = _shapes(model_or_state_dict)
    specs = _plan(shapes, mesh.shape[model_axis], min_params)
    stats = {'sharded': [0, 0], 'replicated': [0, 0]}
    for name, shape in shapes.items():
        key = 'replicated' if specs[name] is None else 'sharded'
        stats[key][0] += 1
        stats[key][1] += math.prod(shape)
    return {k: tuple(v) for k, v in stats.items()}


def _tp_leaves(module: nn.Module) -> Tuple[str, ...]:
    """The leaves `module`'s code can run sharded: a conv's through
    `models.darknet19.conv`, the others as each module lists them."""
    if isinstance(module, nn.Conv2d):
        return ('weight', 'bias')
    return getattr(module, 'tp_leaves', ())


def shard_variables(mesh, model: nn.Module, model_axis: str = 'model',
                    min_params: int = 1 << 16) -> nn.Module:
    """Keep only this rank's block of every leaf that `plan_tp_specs`
    shards, in place, and return `model`. Its forward and backward then
    equal the dense model's (see the module docstring). A leaf that its
    module cannot run sharded, or a pipelined or time-sharded layer,
    raises ValueError."""
    specs = plan_tp_specs(model, mesh, model_axis, min_params)
    if not any(axis is not None for axis in specs.values()):
        return model
    for name, module in model.named_modules():
        if getattr(module, 'pipeline', False) \
                or getattr(module, 'time_shards', 1) > 1:
            raise ValueError(f'{name}: tensor parallelism runs beside data '
                             'parallelism only, not with pipelined or '
                             'time-sharded layers')
    group, size = mesh.group(model_axis), mesh.shape[model_axis]
    if group is None:
        raise ValueError(f'a {model_axis!r} axis of {size} needs a process '
                         'group')
    index = mesh.index(model_axis)
    for name, axis in specs.items():
        if axis is None:
            continue
        prefix, _, leaf = name.rpartition('.')
        module = model.get_submodule(prefix)
        if leaf not in _tp_leaves(module):
            raise ValueError(f'{name}: {type(module).__name__} cannot run '
                             f'with a sharded {leaf!r}')
        param = getattr(module, leaf)
        per = param.shape[axis] // size
        block = param.detach().narrow(axis, index * per, per).clone()
        setattr(module, leaf, nn.Parameter(
            block, requires_grad=param.requires_grad))
        module.tp_shards = {**_shards(module),
                            leaf: Shard(group, index, size, axis)}
    return model


def tp_sharded_parameters(model: nn.Module) -> Dict[str, Shard]:
    """{parameter name: its Shard} for every leaf held as a block."""
    out = {}
    for prefix, module in model.named_modules():
        for leaf, shard in _shards(module).items():
            out[f'{prefix}.{leaf}' if prefix else leaf] = shard
    return out


@torch.no_grad()
def gather_dense(model: nn.Module,
                 tensors: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """`tensors` (default: `model.state_dict()`) with every block of a
    sharded leaf gathered whole: the dense state_dict (or the dense
    gradients, given {name: grad}). Every rank of each model group takes
    part."""
    tensors = model.state_dict() if tensors is None else tensors
    out = dict(tensors)
    for name, shard in sorted(tp_sharded_parameters(model).items()):
        if name not in tensors:
            continue
        local = tensors[name].contiguous()
        parts = [torch.empty_like(local) for _ in range(shard.size)]
        dist.all_gather(parts, local, group=shard.group)
        out[name] = torch.cat(parts, shard.axis)
    return out


def _shards(module: nn.Module) -> Dict[str, Shard]:
    # read from the instance dict: a getattr miss on a module goes through
    # nn.Module.__getattr__, which raises and catches on every conv call
    return vars(module).get('tp_shards', {})


def tp_shard(module: nn.Module, leaf: str) -> Optional[Shard]:
    return _shards(module).get(leaf)


def held(module: nn.Module, leaf: str) -> Optional[torch.Tensor]:
    """`module.<leaf>` whole: gathered at use when this rank holds a block
    of it (the gradient reaches the block), else the parameter itself."""
    value = getattr(module, leaf)
    shard = tp_shard(module, leaf)
    return value if shard is None else gather_blocks(value, shard.group,
                                                     shard.axis)


def column_block(module: nn.Module, leaf: str, shard: Shard,
                 axis: int) -> torch.Tensor:
    """`module.<leaf>` cut to this rank's block of output channels along
    `axis`, beside a weight sharded as `shard`: the block held when the
    leaf is sharded too, else the block of the replicated leaf, whose
    gradient is then summed over the group."""
    value = getattr(module, leaf)
    if tp_shard(module, leaf) is not None:
        return value
    per = value.shape[axis] // shard.size
    return replicated_input(value, shard.group).narrow(
        axis, shard.index * per, per)


def column_operands(module: nn.Module, weight: str, bias: Optional[str],
                    bias_axis: int = 0):
    """(weight, bias, group) of a conv: the weight's block with the
    matching bias block and the model group when the weight is sharded;
    else both whole (a sharded bias gathered) and no group."""
    if bias is not None and getattr(module, bias) is None:
        bias = None                                 # a conv without bias
    shard = tp_shard(module, weight)
    if shard is None:
        return (getattr(module, weight),
                None if bias is None else held(module, bias), None)
    block = None if bias is None else column_block(module, bias, shard,
                                                   bias_axis)
    return getattr(module, weight), block, shard.group


def column_conv(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], padding: int,
                group=None) -> torch.Tensor:
    """`F.conv2d(x, weight, bias)` on NCHW; with a model `group`, weight
    and bias are this rank's block of output channels and the blocks of
    every rank are gathered along the channels."""
    if group is None:
        return F.conv2d(x, weight, bias, padding=padding)
    y = F.conv2d(replicated_input(x, group), weight, bias, padding=padding)
    return gather_blocks(y, group, 1)
