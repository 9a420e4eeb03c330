"""The collectives of the parallel paths, with the autograd rules of JAX's.

Under `jax.shard_map` every collective has a transpose that JAX derives;
here each one is an explicit `torch.autograd.Function` whose backward is
that transpose:

- `all_reduce_sum`: psum of per-rank partial sums (the BatchNorm sums of
  a data group); backward sums the cotangents of every rank;
- `ring_shift`: `ppermute` to the next rank of the group; backward sends
  the cotangent back to the previous one;
- `replicated_input`: a value every rank holds (JAX's `pcast` of an
  invariant to a varying value); backward sums the cotangents, since each
  rank may use it differently. Tensor parallelism puts it at the input of
  a column-parallel conv: each rank's conv computes only its block of
  output channels, so it holds only their share of dL/dx;
- `gather_blocks`: every rank's block of a tensor, concatenated along an
  axis in rank order (tensor parallelism's output of a column-parallel
  conv, or a sharded parameter gathered at use); backward keeps each
  rank's own block of the cotangent, because the computation after it is
  replicated and every rank holds the same one (summing would count it
  once per rank);
- `share_from_last`: the last rank's value given to every rank (a psum of
  masked values); backward keeps each rank's own cotangent, because the
  computation after it is replicated and every rank holds the same one;
- `all_to_all`: the tiled `all_to_all` on axis 0; backward is the same
  exchange of the cotangents.

`group=None` means no process group (one process): every function is then
the identity. A group of one rank still runs its collective, so that a
world of one exercises the backend.

Backward collectives run in the order the autograd engine visits their
nodes. The parallel paths keep the graph of every rank of a group the
same (every rank computes every step and selects with a rank mask, as the
JAX paths do), so that order is the same on every rank.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the ranks of `group`, differentiable."""
    return x if group is None else _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` of a tensor that takes no gradient (a
    count, a metric); returns `x`."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's `x`, in rank order; no gradient."""
    if group is None:
        return x[None]
    out = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send `x` to the rank `step` places on in `group` and receive from
    the rank `step` places back: one all_to_all with every other split
    empty."""
    n, me = group_size(group), group_rank(group)
    rows = x.shape[0]
    send = [0] * n
    recv = [0] * n
    send[(me + step) % n] = rows
    recv[(me - step) % n] = rows
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x.reshape((1,) + x.shape), group, 1)[0]

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad.reshape((1,) + grad.shape), ctx.group, -1)[0], \
            None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """`x` of rank i arrives at rank i+1 (mod size): JAX's `ppermute` over
    the ring `[(i, i+1 mod n)]`. The identity without a group."""
    if group is None:
        return x
    return _RingShift.apply(x, group)


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, held alike by every rank of `group`, entering a computation
    that differs by rank: its gradient is the sum of every rank's."""
    return x if group is None else _ReplicatedInput.apply(x, group)


class _ShareFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, is_last):
        ctx.is_last = is_last
        x = torch.where(is_last, x, torch.zeros_like(x)).contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return torch.where(ctx.is_last, grad, torch.zeros_like(grad)), \
            None, None


def share_from_last(x: torch.Tensor, group) -> torch.Tensor:
    """The last rank's `x` on every rank of `group`. What follows must be
    computed alike on every rank (it holds the same cotangent): the
    gradient goes to the last rank's `x` once."""
    if group is None:
        return x
    is_last = torch.tensor(group_rank(group) == group_size(group) - 1,
                           device=x.device)
    return _ShareFromLast.apply(x, group, is_last)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.block = x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        at = group_rank(ctx.group) * ctx.block
        return grad.narrow(ctx.dim, at, ctx.block), None, None


def gather_blocks(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order; the
    identity without a group. What follows must be computed alike on every
    rank of `group`: the gradient of `x` is its block of the cotangent."""
    return x if group is None else _GatherBlocks.apply(x, group, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all_to_all on axis 0: row block j of `x` goes to rank j, and
    row block j of the result came from rank j."""
    return x if group is None else _AllToAll.apply(x, group)


def average_gradients_(params: List[torch.nn.Parameter],
                       group: Optional[object]) -> None:
    """Mean of every parameter's gradient over `group`, whose ranks each
    computed the same gradient (a replicated batch): the card's
    reductions may differ in the last bits from rank to rank, and the
    mean leaves every rank on the same weights."""
    if group is None:
        return
    sum_gradients_(params, group)
    for p in params:
        if p.grad is not None:
            p.grad.div_(group_size(group))


def sum_gradients_(params: List[torch.nn.Parameter],
                   group: Optional[object]) -> None:
    """Sum every parameter's gradient over `group`, in one collective per
    dtype: a data group's ranks each hold the gradient of their share of
    the global loss."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        at = 0
        for g in same:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
