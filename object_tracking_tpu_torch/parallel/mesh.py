"""Process groups and the (data, model) mesh, and the host batch's slice.

Port of `object_tracking_tpu/parallel/mesh.py`. The JAX package runs one
program over a `jax.sharding.Mesh` of every chip; the port runs one
process per device (`torchrun`, or `MeshConfig.distributed` with an
address, a process count and a process id) and lays the ranks of the
world out as a (data, model) `DeviceMesh`:

- `distributed_init` calls `torch.distributed.init_process_group` once,
  NCCL for a flow on a CUDA device and gloo on the CPU;
- `make_mesh` builds the `Mesh`, rank = data index · model size + model
  index (row-major, as JAX's `reshape(dp, mp)`); without a process group
  the world is one rank and the mesh has no groups, so that every
  collective of the parallel paths is the identity;
- `shard_batch`: every rank builds the same global host batch from the
  same seed and keeps its own slice along `axis` (the counterpart of
  `jax.device_put` with a data-sharded spec); a ragged axis replicates,
  and the batch says so (`ShardedBatch.replicated`).

The steps then keep the global-batch semantics of JAX's sharded `jit`
(training/steps.py): BatchNorm statistics, the loss normalisers and the
MoE routing span the data group, and the gradients are summed over it.
A replicated batch is the whole global batch on every rank, so its step
runs as the one-rank step inside `whole_batch(replicas)`: the data axis
has no group there (`Mesh.group`, `in_whole_batch`), and every rank
computes the whole batch's update, as GSPMD does for a replicated input
(the steps average the replicas' gradients, `replica_group`, so that the
card's reductions leave every rank on the same bits).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from object_tracking_tpu_torch.config import MeshConfig

def _init_method(address: Optional[str]) -> Optional[str]:
    """'host:port' → 'tcp://host:port'; an address with a scheme
    ('tcp://…', 'file://…') stays as it is; None reads the environment
    (torchrun's MASTER_ADDR / MASTER_PORT)."""
    if not address:
        return None
    return address if '://' in address else f'tcp://{address}'


def distributed_init(config: Optional[MeshConfig] = None,
                     device='cpu') -> bool:
    """Join the process group once, iff `config.distributed` is set.

    The backend follows the device the flow runs on: NCCL for CUDA, gloo
    for the CPU. `coordinator_address` is the rendezvous (an init method),
    `num_processes` the world size and `process_id` this rank; -1 (or no
    address) reads them from the environment, as `torchrun` sets it.
    Idempotent (a process already in a group joins no other); returns True
    when the process group is (now) initialised.
    """
    config = config or MeshConfig()
    if not config.distributed:
        return False
    if dist.is_initialized():
        return True
    device = torch.device(device)
    kwargs = {'backend': 'nccl' if device.type == 'cuda' else 'gloo'}
    method = _init_method(config.coordinator_address)
    if method:
        kwargs['init_method'] = method
    if config.num_processes != -1:
        kwargs['world_size'] = config.num_processes
    if config.process_id != -1:
        kwargs['rank'] = config.process_id
    if device.type == 'cuda' and device.index is None:
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group(**kwargs)
    return True


class Mesh:
    """The (data, model) layout of the world's ranks.

    `shape` maps each axis name to its size, as `jax.sharding.Mesh.shape`;
    `group(axis)` is the process group of this rank's ranks along that
    axis (None without a process group), `index(axis)` this rank's place
    on it. `device_mesh` is the torch `DeviceMesh` (None for one process
    without a process group).
    """

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.device_mesh = device_mesh

    def group(self, axis: str):
        if self.device_mesh is None or (
                axis == self.axis_names[0] and in_whole_batch()):
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def data_group(self):
        return self.group(self.axis_names[0])

    def __repr__(self):
        return f'Mesh({self.shape})'


def axis_group(mesh: Optional[Mesh], axis: str):
    """The process group of `mesh`'s axis `axis` (None without a mesh or
    a process group: the parallel paths' one-rank case)."""
    return None if mesh is None else mesh.group(axis)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The framework-wide mesh over the world's ranks.

    data_parallel == -1 means "every rank not claimed by model_parallel".
    A mesh that needs more ranks than the world has raises, and so does
    one that leaves ranks out (each rank is one device of the mesh). The
    mesh's device type follows the process group's backend: 'cuda' under
    NCCL, else 'cpu'.
    """
    config = config or MeshConfig()
    n = _world_size()
    mp = max(1, config.model_parallel)
    dp = config.data_parallel
    if dp == -1:
        dp = max(1, n // mp)
    if dp * mp > n:
        raise ValueError(f'mesh {dp}x{mp} needs {dp * mp} devices, have {n}')
    if dp * mp < n:
        raise ValueError(f'mesh {dp}x{mp} leaves {n - dp * mp} of {n} '
                         'ranks out: one rank runs one device of the mesh')
    shape = {config.data_axis: dp, config.model_axis: mp}
    if not dist.is_initialized():
        return Mesh(shape)
    from torch.distributed.device_mesh import DeviceMesh
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    grid = torch.arange(n).reshape(dp, mp)
    return Mesh(shape, DeviceMesh(device_type, grid,
                                  mesh_dim_names=tuple(shape)))


def data_sharding(mesh: Mesh, ndim: int = 1):
    """Placements of a tensor whose leading axis shards over `data` and
    that is replicated over `model`: DTensor's (Shard(0), Replicate())."""
    from torch.distributed.tensor import Replicate, Shard
    del ndim
    return (Shard(0), Replicate())


def replicated_sharding(mesh: Mesh):
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(mesh.axis_names)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    dp = mesh.shape[mesh.axis_names[0]]
    if global_batch % dp:
        raise ValueError(
            f'global batch {global_batch} not divisible by data axis {dp}')
    return global_batch // dp


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


class ShardedBatch(dict):
    """A dict batch as `shard_batch` returns it. `replicated` is True when
    every rank holds the whole global batch (a ragged axis), False when
    each holds its slice: the steps read it on the host, before they run,
    to choose their route."""

    replicated = False


def is_replicated(batch) -> bool:
    """True for a batch that `shard_batch` left whole on every rank."""
    return bool(getattr(batch, 'replicated', False))


def shard_batch(mesh: Mesh, tree, axis: int = 0):
    """This rank's slice of a host pytree of the global batch: `axis` is
    split over `data` into equal blocks, block i on the ranks with data
    index i. axis=0 shards the batch (data parallelism); axis=1 the time
    axis of (B, T, ...) clips (sequence parallelism, with a model built
    with time_shards > 1). A leaf with no such axis stays whole.

    If the data size does not divide `axis` of some leaf, the batch
    replicates: every rank keeps every leaf whole. That costs dp× the
    memory and transfer, so it warns once per shape. A dict comes back as
    a `ShardedBatch`, whose `replicated` tells the steps which it was.
    """
    dp = mesh.shape[mesh.axis_names[0]]
    i = mesh.index(mesh.axis_names[0])
    tree = _map(lambda x: x if isinstance(x, torch.Tensor)
                else np.asarray(x), tree)
    ragged = [tuple(x.shape) for x in _leaves(tree)
              if x.ndim > axis and x.shape[axis] % dp]
    for shape in ragged:
        key = (shape, axis, dp)
        if key not in _REPLICATION_WARNED:
            _REPLICATION_WARNED.add(key)
            logging.getLogger(__name__).warning(
                'shard_batch: axis %d of %s not divisible by data axis %d '
                '— replicating (a %dx memory/transfer cliff); pad or drop '
                'the ragged batch to restore sharding', axis, shape, dp, dp)

    def take(x):
        if ragged or x.ndim <= axis:
            return x
        per = x.shape[axis] // dp
        return x[(slice(None),) * axis + (slice(i * per, (i + 1) * per),)]

    out = _map(take, tree)
    if isinstance(out, dict):
        out = ShardedBatch(out)
        out.replicated = bool(ragged)
    return out


_REPLICATION_WARNED: set = set()

# (replicas,) while a step runs on a replicated batch: see `whole_batch`
_WHOLE_BATCH = contextvars.ContextVar('whole_batch', default=None)


@contextlib.contextmanager
def whole_batch(replicas=None):
    """Within the block every rank of the data group `replicas` (None: one
    process) holds the whole global batch: the data axis of every mesh
    has no group (`Mesh.group`, `in_whole_batch`), so BatchNorm, the
    losses and the MoE routing compute the one-rank step on each rank.
    The model axis keeps its groups."""
    token = _WHOLE_BATCH.set((replicas,))
    try:
        yield
    finally:
        _WHOLE_BATCH.reset(token)


def in_whole_batch() -> bool:
    return _WHOLE_BATCH.get() is not None


def replica_group():
    """Inside `whole_batch(replicas)`, `replicas`; else None."""
    state = _WHOLE_BATCH.get()
    return None if state is None else state[0]


def is_writer() -> bool:
    """True on the rank that writes logs and checkpoints: rank 0 of the
    world, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the world; nothing without a process group."""
    if dist.is_initialized():
        dist.barrier()
