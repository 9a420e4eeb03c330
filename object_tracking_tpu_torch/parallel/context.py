"""Context-parallel recurrence: a scan over a time axis sharded across
the ranks of a group.

Port of `object_tracking_tpu/parallel/context.py`. Each rank holds T/n
consecutive steps of the inputs (rank i the i-th block) and returns its
block of the outputs; the carry passes rank to rank (`ring_shift`, JAX's
`ppermute`).

A recurrence is sequential, so the exact scan runs n rounds: in round r
rank r scans its block from the carry it received, and the carry moves on
one rank. Every rank scans every round and keeps its result only in its
own round (a rank mask), as the JAX scan does: compute is replicated
across rounds, the inputs and outputs each rank holds are T/n steps, and
every rank's autograd graph is the same, which orders the collectives of
the backward pass alike on all of them. `halo > 0` runs one round: each
rank starts from a state burned in on its predecessor's *last* `halo`
steps (rank 0 from the initial carry), which trades exactness for one
round, as streaming trackers warm up.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from object_tracking_tpu_torch.parallel.collectives import (
    all_gather_stack, group_rank, group_size, ring_shift)
from object_tracking_tpu_torch.parallel.mesh import axis_group


def _scan(cell_fn, carry, xs):
    """lax.scan over the leading axis of the pytree `xs`; ys stacked."""
    leaves, spec = tree_flatten(xs)
    ys = []
    for t in range(leaves[0].shape[0]):
        carry, y = cell_fn(carry, tree_unflatten([l[t] for l in leaves],
                                                 spec))
        ys.append(y)
    y_leaves, y_spec = tree_flatten(ys[0])
    stacked = [torch.stack([tree_flatten(y)[0][i] for y in ys])
               for i in range(len(y_leaves))]
    return carry, tree_unflatten(stacked, y_spec)


def _select(mask, a, b):
    return tree_map(lambda x, y: torch.where(mask, x, y), a, b)


def context_parallel_scan(cell_fn: Callable[..., tuple], carry_init: Any,
                          xs: Any, mesh, axis_name: str = 'data',
                          halo: int = 0, consts: Any = None):
    """Scan `cell_fn` over the leading (time) axis of `xs`, time-sharded
    over the ranks of a mesh axis.

    Args:
      cell_fn: (carry, x_t) → (carry, y_t); or (consts, carry, x_t) →
        (carry, y_t) when `consts` is given.
      carry_init: the initial recurrent state (a pytree), alike on every
        rank.
      xs: this rank's block of the steps, a pytree with leading axis
        T / n (rank i holds steps [i·T/n, (i+1)·T/n)); blocks of unequal
        length (a T the axis size does not divide) raise ValueError.
      mesh: the framework `Mesh` (None: one process, a plain scan).
      axis_name: the mesh axis the time axis is sharded over.
      halo: 0 → the exact n-round ring; k > 0 → one round, each rank
        warm-started on its predecessor's last k steps.
      consts: what the cell reads every step (e.g. the recurrent kernel),
        passed through as the JAX scan's explicit replicated inputs.

    Returns:
      ys: this rank's block of the outputs (leading axis T / n).
    """
    if consts is not None:
        full_cell = cell_fn
        cell_fn = lambda c, x: full_cell(consts, c, x)   # noqa: E731
    group = axis_group(mesh, axis_name)
    if group is None:
        return _scan(cell_fn, carry_init, xs)[1]
    n = group_size(group)
    device = tree_flatten(xs)[0][0].device
    t = tree_flatten(xs)[0][0].shape[0]
    blocks = all_gather_stack(torch.tensor(t, device=device), group)
    if bool((blocks != t).any()):
        raise ValueError(f'time axis {int(blocks.sum())} not divisible by '
                         f'axis size {n}: the ranks hold {blocks.tolist()} '
                         'steps')
    me = group_rank(group)
    first = torch.tensor(me == 0, device=device)

    def shift(tree):
        return tree_map(lambda l: ring_shift(l, group), tree)

    if halo > 0:
        burn = tree_map(lambda l: l[-halo:], xs)
        warm, _ = _scan(cell_fn, carry_init, burn)
        start = _select(first, carry_init, shift(warm))
        return _scan(cell_fn, start, xs)[1]

    carry, ys = carry_init, None
    for r in range(n):
        mine = torch.tensor(me == r, device=device)
        new_carry, new_ys = _scan(cell_fn, carry, xs)
        ys = new_ys if ys is None else _select(mine, new_ys, ys)
        carry = shift(_select(mine, new_carry, carry))
    return ys

