"""Parallel paths of the port: one process per device, the ranks laid out
as a (data, model) mesh.

Port of `object_tracking_tpu/parallel/`: the mesh and the batch's slice
(`mesh.py`), the context-parallel scan (`context.py`), the pipeline
(`pipeline.py`) and the mixture-of-experts routing, dense and
expert-parallel (`expert.py`), and tensor parallelism over the model
axis (`sharding.py`), over `torch.distributed` process groups whose
collectives carry JAX's autograd rules (`collectives.py`).
"""

from object_tracking_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, ShardedBatch, make_mesh, data_sharding, distributed_init,
    is_replicated, replicated_sharding, shard_batch, local_batch_size,
    whole_batch,
)
from object_tracking_tpu_torch.parallel.context import (  # noqa: F401
    context_parallel_scan,
)
from object_tracking_tpu_torch.parallel.sharding import (  # noqa: F401
    gather_dense, plan_tp_specs, shard_variables, tp_sharding_summary,
)
from object_tracking_tpu_torch.parallel.pipeline import (  # noqa: F401
    gpipe, pipeline_scan,
)
from object_tracking_tpu_torch.parallel.expert import (  # noqa: F401
    expert_parallel_moe, init_moe_params, moe_apply, moe_capacity,
)
