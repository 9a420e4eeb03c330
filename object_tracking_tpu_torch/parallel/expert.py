"""Mixture-of-experts routing, dense and expert-parallel.

Port of `object_tracking_tpu/parallel/expert.py` (Switch/GShard
semantics: top-1 routing within groups, a fixed per-expert capacity,
overflow tokens contribute zero). The parameters keep JAX's layout,
`gate` (D, E), `w1` (E, D, H), `b1` (E, H), `w2` (E, H, O), `b2` (E, O),
so that a flax tree converts as the identity and the einsums read as
JAX's.

- `moe_apply`: the dense formulation, the expert axis a tensor dimension.
  With `group` (a data group whose ranks each hold a share of one routing
  group's tokens) it routes the global token order: a rank's slots are
  offset by the per-expert counts of the tokens before its own, the
  capacity comes from the global token count, and the auxiliary loss's
  means are global. A rank that holds every token (a batch that
  `mesh.shard_batch` replicated) routes them with no group, as one group
  of its own tokens in their own order, as JAX routes a replicated
  input: the steps run such a batch inside `mesh.whole_batch()`, where
  the data axis has no group.
- `expert_parallel_moe`: one expert per rank of a group; tokens are
  sharded, and dispatch and combine hop ranks with an all_to_all. It
  equals `moe_apply(num_groups=group size)` on the concatenated tokens.

Pins: top-1 is the first maximal logit (`argmax`, as `jnp.argmax`); the
softmax runs in float32; a token's slot is the inclusive running count of
its expert's tokens − 1, and a slot at or past the capacity drops it; the
auxiliary loss is E · mean over groups of Σ_e fraction_e · mean prob_e;
dispatch and combine are cast to the tokens' dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from object_tracking_tpu_torch.parallel.collectives import (
    all_gather_stack, all_to_all, group_rank, group_size)
from object_tracking_tpu_torch.parallel.mesh import axis_group

_KEYS = ('gate', 'w1', 'b1', 'w2', 'b2')


def moe_capacity(tokens_per_group: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Per-expert slot count per group (static)."""
    return max(1, math.ceil(tokens_per_group / num_experts * capacity_factor))


def init_moe_params(generator: torch.Generator, num_experts: int, d_in: int,
                    d_hidden: int, d_out: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Gate and expert-stacked two-layer MLP: normal weights scaled by
    1/sqrt(fan_in), zero biases, drawn from `generator` (on its device)."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                / math.sqrt(fan_in)).to(dtype)
    e = num_experts
    return {
        'gate': normal((d_in, e), d_in),
        'w1': normal((e, d_in, d_hidden), d_in),
        'b1': torch.zeros((e, d_hidden), dtype=dtype, device=device),
        'w2': normal((e, d_hidden, d_out), d_hidden),
        'b2': torch.zeros((e, d_out), dtype=dtype, device=device),
    }


def _slots(expert: torch.Tensor, num_experts: int, capacity: int,
           offset: Optional[torch.Tensor] = None):
    """expert (G, N) → (one-hot (G, N, E) float32, slot one-hot
    (G, N, E, C) float32 with overflow dropped). `offset` (G, E) adds the
    count of each expert's tokens that precede the group's."""
    experts = torch.arange(num_experts, device=expert.device)
    onehot = (expert[..., None] == experts).to(torch.float32)
    pos = torch.cumsum(onehot, dim=1) - 1.0
    if offset is not None:
        pos = pos + offset[:, None, :]
    keep = torch.where(pos < capacity, onehot, torch.zeros_like(onehot))
    slot = torch.clamp(pos.to(torch.int32), 0, capacity - 1)
    slots = torch.arange(capacity, device=expert.device, dtype=torch.int32)
    return onehot, (slot[..., None] == slots).to(torch.float32) \
        * keep[..., None]


def _route(tokens: torch.Tensor, gate_w: torch.Tensor, num_experts: int,
           capacity: int, group=None, segments: int = 1):
    """Top-1 routing of tokens (G, N, D).

    → dispatch (G, N, E, C) 0/1 slot assignment, combine = dispatch ·
    gate prob, aux = E · mean over groups of Σ_e fraction_e · mean prob_e.

    With `group`, the G groups' tokens are shared out among the group's
    ranks: this rank holds `segments` runs of N / segments tokens of each
    group, and the global order of a group is run 0 of every rank in rank
    order, then run 1, and so on. `aux` is then this rank's share of the
    global auxiliary loss (the shares sum to it).
    """
    g, n, _ = tokens.shape
    logits = torch.einsum('gnd,de->gne', tokens, gate_w)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    expert = torch.argmax(logits, dim=-1)                       # (G, N)
    gate = torch.gather(probs, -1, expert[..., None])[..., 0]
    if group is None:
        onehot, dispatch = _slots(expert, num_experts, capacity)
        aux = num_experts * torch.mean(
            torch.sum(onehot.mean(dim=1) * probs.mean(dim=1), dim=-1))
        return dispatch, dispatch * gate[..., None, None], aux
    # global order: count each expert's tokens per run on every rank
    s, me = segments, group_rank(group)
    runs = expert.reshape(g * s, n // s)
    onehot = (runs[..., None] == torch.arange(
        num_experts, device=tokens.device)).to(torch.float32)
    counts = all_gather_stack(onehot.sum(dim=1).reshape(g, s, -1), group)
    counts = counts.permute(1, 2, 0, 3)                     # (G, S, R, E)
    before = counts.reshape(g, -1, num_experts).cumsum(dim=1) \
        - counts.reshape(g, -1, num_experts)                  # exclusive
    offset = before.reshape(counts.shape)[:, :, me]         # (G, S, E)
    _, dispatch = _slots(runs, num_experts, capacity,
                         offset.reshape(g * s, num_experts))
    dispatch = dispatch.reshape(g, n, num_experts, capacity)
    total = counts.sum(dim=(1, 2))                          # (G, E)
    n_global = total.sum(dim=-1, keepdim=True)
    fraction = total / n_global
    prob_sum = probs.sum(dim=1)                             # (G, E) local
    aux = num_experts * torch.mean(
        torch.sum(fraction * prob_sum / n_global, dim=-1))
    return dispatch, dispatch * gate[..., None, None], aux


def moe_apply(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              num_groups: int = 1, capacity_factor: float = 1.25,
              return_aux: bool = False, group=None, segments: int = 1):
    """Dense MoE forward: tokens (N, D) → (N, d_out).

    Tokens route top-1 within each of `num_groups` groups (group-local
    capacity); overflow tokens contribute zero. With `group` (see
    `_route`), this rank's tokens are its share of the groups' global
    tokens: the capacity, the slots and the auxiliary loss are the global
    ones, and the returned aux is this rank's share of it.
    """
    n, _ = tokens.shape
    g = num_groups
    if n % g:
        raise ValueError(f'{n} tokens not divisible by {g} groups')
    e = params['w1'].shape[0]
    cap = moe_capacity(n * group_size(group) // g, e, capacity_factor)
    tok = tokens.reshape(g, n // g, -1)
    dispatch, combine, aux = _route(tok, params['gate'], e, cap, group,
                                    segments)
    dispatch = dispatch.to(tokens.dtype)
    combine = combine.to(tokens.dtype)
    buf = torch.einsum('gnec,gnd->gecd', dispatch, tok)
    h = torch.relu(torch.einsum('gecd,edh->gech', buf, params['w1'])
                   + params['b1'][:, None])
    y = torch.einsum('gech,eho->geco', h, params['w2']) \
        + params['b2'][:, None]
    out = torch.einsum('gnec,geco->gno', combine, y).reshape(n, -1)
    return (out, aux) if return_aux else out


def expert_parallel_moe(params: Dict[str, torch.Tensor],
                        tokens: torch.Tensor, mesh, axis_name: str = 'model',
                        capacity_factor: float = 1.25) -> torch.Tensor:
    """Expert-parallel MoE forward: one expert per rank of the mesh axis
    `axis_name` (`mesh` None: one process, one expert).

    `tokens` (N, D) is this rank's shard of the tokens, one routing group;
    every rank holds the same number. `params` hold either every expert
    (leading axis E) or this rank's expert alone (leading axis 1); the
    gate (D, E) is whole on every rank. Each rank routes its tokens, ships
    each expert's capacity buffer to that expert's rank with one
    all_to_all, runs its expert on what it received and ships the results
    back with a second one. Returns this rank's (N, d_out): the rows of
    `moe_apply(..., num_groups=size)` over the ranks' concatenated tokens.
    """
    group = axis_group(mesh, axis_name)
    s, me = group_size(group), group_rank(group)
    e = params['gate'].shape[1]
    if e != s:
        raise ValueError(f'{e} experts != {axis_name} axis size {s}; '
                         'explicit EP places '
                         'one expert per device')
    n, _ = tokens.shape
    sizes = all_gather_stack(torch.tensor(n, device=tokens.device), group)
    if bool((sizes != n).any()):
        raise ValueError(f'{int(sizes.sum())} tokens not divisible by axis '
                         f'size {s}: the ranks hold {sizes.tolist()}')
    cap = moe_capacity(n, e, capacity_factor)
    my = {k: (params[k][me] if params[k].shape[0] == e else params[k][0])
          for k in _KEYS[1:]}
    dispatch, combine, _ = _route(tokens[None], params['gate'], e, cap)
    dispatch = dispatch[0].to(tokens.dtype)
    combine = combine[0].to(tokens.dtype)
    buf = torch.einsum('nec,nd->ecd', dispatch, tokens)
    # row j of `buf` goes to expert/rank j; row j of `recv` came from j
    recv = all_to_all(buf, group)
    h = torch.relu(torch.einsum('scd,dh->sch', recv, my['w1']) + my['b1'])
    y = torch.einsum('sch,ho->sco', h, my['w2']) + my['b2']
    back = all_to_all(y, group)
    return torch.einsum('nec,eco->no', combine, back)

