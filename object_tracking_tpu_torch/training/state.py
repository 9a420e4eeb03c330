"""Train state and the Adam optimizer.

Port of `object_tracking_tpu/training/state.py`. JAX's state is one
immutable pytree (step, params, batch_stats, opt_state); here `TrainState`
holds the module (parameters and BatchNorm statistics), a
`torch.optim.Adam`, the optional global-norm clip and a host `step`, and a
step updates them in place.

`make_optimizer` is Adam with Keras' constants (b1 0.9, b2 0.999, eps 1e-7,
not torch's 1e-8). The learning rate lives in the optimizer's param group,
so ReduceLROnPlateau changes it without rebuilding anything.

Global-norm clipping follows optax's `clip_by_global_norm`: the gradients
are scaled by max/norm only when norm >= max (`clip_grad_norm_` scales by
max/(norm + 1e-6) whenever norm > max), computed on the device without a
host sync. Under pipeline parallelism a stage's parameters live on its
rank alone, and under tensor parallelism a block on its rank alone, so
their squared norms are summed over the stage or model group: the norm is
the dense model's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from object_tracking_tpu_torch.parallel.pipeline import (
    stage_sharded_parameters)
from object_tracking_tpu_torch.parallel.sharding import (
    tp_sharded_parameters)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What `make_optimizer` returns: Adam's settings and the clip, built
    into a `torch.optim.Adam` over a module's parameters by `build`."""
    learning_rate: float = 1e-4
    grad_clip_norm: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7

    def build(self, params: Iterable[torch.Tensor]) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.learning_rate,
                                betas=(self.b1, self.b2), eps=self.eps)


def make_optimizer(learning_rate: float = 1e-4,
                   grad_clip_norm: Optional[float] = None) -> Optimizer:
    """Adam with a runtime-adjustable learning rate, optionally after a
    global-norm clip."""
    return Optimizer(learning_rate, grad_clip_norm)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Sequence[Tuple[object, List[torch.Tensor]]]
                         = ()) -> torch.Tensor:
    """Scale `grads` (and the `sharded` ones) in place by max_norm / norm
    when norm >= max_norm (optax's rule); returns the global norm, a device
    scalar. `sharded` lists (group, grads) whose squares sum over their
    group (pipeline stages)."""
    every = list(grads) + [g for _, part in sharded for g in part]
    norm = torch.zeros((), device=every[0].device)
    if grads:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    for group, part in sharded:
        sq = torch.stack([torch.square(torch.linalg.vector_norm(g.float()))
                          for g in part]).sum()
        dist.all_reduce(sq, group=group)
        norm = torch.sqrt(torch.square(norm) + sq)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in every:
        g.mul_(factor.to(g.dtype))
    return norm


def clip_model_gradients_(model: nn.Module, max_norm: float
                          ) -> torch.Tensor:
    """`clip_by_global_norm_` over the gradients of `model`'s parameters,
    a pipelined stack's stage slices summed over their stage group and
    tensor-parallel blocks over their model group; returns the global
    norm."""
    sharded = {name: stage[0] for name, stage
               in stage_sharded_parameters(model).items()}
    sharded.update((name, shard.group) for name, shard
                   in tp_sharded_parameters(model).items())
    groups, grads = {}, []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        if name in sharded:
            groups.setdefault(sharded[name], []).append(p.grad)
        else:
            grads.append(p.grad)
    return clip_by_global_norm_(grads, max_norm, list(groups.items()))


class TrainState:
    """The module, its optimizer and the global step (a host int: it
    drives the loss warm-up and is read without a sync)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 grad_clip_norm: Optional[float] = None, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.grad_clip_norm = grad_clip_norm
        self.step = step

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> 'TrainState':
        return cls(model, tx.build(model.parameters()), tx.grad_clip_norm)

    @property
    def params(self):
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self):
        return dict(self.model.named_buffers())

    def apply_gradients(self) -> 'TrainState':
        """Clip (when set) and take one Adam step on the gradients that
        backward left in the parameters; the step count advances."""
        if self.grad_clip_norm is not None:
            clip_model_gradients_(self.model, self.grad_clip_norm)
        self.optimizer.step()
        self.step += 1
        return self

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]['lr'])

    def with_learning_rate(self, lr: float) -> 'TrainState':
        """Set the learning rate (the ReduceLROnPlateau mechanism); the
        state is changed in place and returned."""
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        return self
