"""Pipeline parallelism: homogeneous stages, one per rank of a group.

Port of `object_tracking_tpu/parallel/pipeline.py`. Stage s runs on rank s
of the group and holds only its own parameters; items (timesteps of a
stacked recurrence, or microbatches) stream through in a wavefront: at
tick k stage s processes item k − s, its output hops to stage s + 1
(`ring_shift`, JAX's `ppermute`), and T + S − 1 ticks run every item
through every stage. For recurrent stages each rank carries its own state
across ticks, frozen outside its live window [s, s + T), so that bubble
values never reach it: the sequential stack's result, reordered.

As in JAX, every rank computes every tick and selects with rank masks, so
every rank's autograd graph is the same (which orders the collectives of
the backward pass alike). The input stream enters as a value every rank
holds (its gradient is summed over the group); the last stage's outputs
are shared with every rank, and what follows them must be computed alike
on every rank (the joint model's head and loss are).

`stage_sharded_parameters`, `gather_stages` and `local_stage` serve the
model and its checkpoints: a pipelined `StackedConvLSTM` holds its
layer's (1, …) slice of the dense (L, …) stacks, gathered on save and
sliced on restore.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map

from object_tracking_tpu_torch.parallel.collectives import (
    group_rank, group_size, replicated_input, ring_shift, share_from_last)
from object_tracking_tpu_torch.parallel.mesh import axis_group


def _local(tree, s: int, idx: int):
    """This stage's slice of `stacked_params`: leading axis S (the whole
    stack on every rank: row idx) or 1 (this rank's stage)."""
    lead = tree_flatten(tree)[0][0].shape[0]
    if lead != s and not (lead == 1 and s > 1):
        raise ValueError(f'stacked_params leading axis {lead} != axis size '
                         f'{s}')
    return tree_map(lambda l: l[idx] if lead == s else l[0], tree)


def pipeline_scan(stage_fn: Callable[[Any, Any, torch.Tensor], tuple],
                  stacked_params: Any, xs: torch.Tensor, mesh,
                  axis_name: str = 'model',
                  carry_init: Optional[Any] = None) -> torch.Tensor:
    """Run S homogeneous stages over T items in a wavefront pipeline.

    Args:
      stage_fn: (params_s, carry_s, x) → (carry_s, y), y shaped as x.
      stacked_params: pytree whose leaves have leading axis S (every
        stage, alike on every rank) or 1 (this rank's stage).
      xs: (T, ...) items, alike on every rank.
      mesh: the framework `Mesh` (None: one process, one stage).
      axis_name: the mesh axis whose S ranks run the S stages.
      carry_init: per-stage recurrent state stacked on a leading S (or 1)
        axis; None for stateless stages.

    Returns:
      ys (T, ...): the last stage's output for every item, on every rank.
    """
    group = axis_group(mesh, axis_name)
    s, idx = group_size(group), group_rank(group)
    t = xs.shape[0]
    params = _local(stacked_params, s, idx)
    carry = (torch.zeros((), device=xs.device) if carry_init is None
             else _local(carry_init, s, idx))

    def checked(carry, x):
        new_carry, y = stage_fn(params, carry, x)
        if (tuple(y.shape), y.dtype) != (tuple(x.shape), x.dtype):
            raise ValueError(f'stage output {tuple(y.shape)}/{y.dtype} must '
                             f'match stage input {tuple(x.shape)}/{x.dtype}')
        return new_carry, y

    if group is None:
        ys = []
        for k in range(t):
            carry, y = checked(carry, xs[k])
            ys.append(y)
        return torch.stack(ys)

    xs = replicated_input(xs, group)
    first = torch.tensor(idx == 0, device=xs.device)
    last = torch.tensor(idx == s - 1, device=xs.device)
    recv = torch.zeros_like(xs[0])
    ys: List[torch.Tensor] = []
    for k in range(t + s - 1):
        inp = torch.where(first, xs[min(k, t - 1)], recv)
        new_carry, out = checked(carry, inp)
        live = torch.tensor(idx <= k < idx + t, device=xs.device)
        carry = tree_map(lambda a, b: torch.where(live, a, b), new_carry,
                         carry)
        if k >= s - 1:                  # the last stage emits item k-(S-1)
            ys.append(torch.where(last, out, torch.zeros_like(out)))
        recv = ring_shift(out, group)
    return share_from_last(torch.stack(ys), group)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stacked_params: Any, xs: torch.Tensor, mesh,
          axis_name: str = 'model') -> torch.Tensor:
    """GPipe-style microbatch pipeline of stateless stages: stage_fn
    (params_s, x) → y shaped as x, over the (M, ...) microbatch axis of
    `xs`; stage 0 first."""
    def wrapped(params, carry, x):
        return carry, stage_fn(params, x)
    return pipeline_scan(wrapped, stacked_params, xs, mesh, axis_name)


def stage_sharded_parameters(model: torch.nn.Module
                             ) -> Dict[str, Tuple[Any, int, int]]:
    """{parameter name: (group, stage index, stage count)} for every
    parameter held as one stage's (1, …) slice of an (S, …) stack."""
    out = {}
    for prefix, module in model.named_modules():
        stage = getattr(module, 'stage', None)
        if stage is None:
            continue
        for name, _ in module.named_parameters(recurse=False):
            out[f'{prefix}.{name}' if prefix else name] = stage
    return out


@torch.no_grad()
def gather_stages(tensors: Dict[str, torch.Tensor],
                  sharded: Dict[str, Tuple[Any, int, int]]
                  ) -> Dict[str, torch.Tensor]:
    """The dense (S, …) stacks of stage-sharded tensors (every rank of
    each group takes part); the other tensors as they are."""
    out = dict(tensors)
    for name in sorted(sharded):
        if name not in tensors:
            continue
        group, _, s = sharded[name]
        local = tensors[name].contiguous()
        parts = [torch.empty_like(local) for _ in range(s)]
        dist.all_gather(parts, local, group=group)
        out[name] = torch.cat(parts)
    return out


def local_stage(tensors: Dict[str, torch.Tensor],
                sharded: Dict[str, Tuple[Any, int, int]]
                ) -> Dict[str, torch.Tensor]:
    """This rank's (1, …) slices of dense (S, …) stage stacks."""
    out = dict(tensors)
    for name, (_, idx, s) in sharded.items():
        if name in tensors and tensors[name].shape[0] == s:
            out[name] = tensors[name][idx:idx + 1].clone()
    return out
