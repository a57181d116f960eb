"""Parallel layers of the port over ``torch.distributed``: meshes of ranks
(``mesh.py``), sequence parallelism, ring and Ulysses attention
(``ring_attention.py``), the partitioners (``partitioner.py``), the
parameter-sharding rules (``sharding.py``), pipeline parallelism
(``pipeline.py``) and expert parallelism (``moe.py``), under the names the
JAX package's ``parallel`` exports.
"""

from raydp_tpu_torch.parallel.mesh import (
    Mesh,
    axis_env_size,
    bound_axes,
    data_parallel_mesh,
    make_mesh,
    mesh_axis_size,
    multihost_mesh,
)
from raydp_tpu_torch.parallel.moe import moe_apply, moe_sharded
from raydp_tpu_torch.parallel.partitioner import (
    DataParallelPartitioner,
    NullPartitioner,
    Partitioner,
)
from raydp_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_sharded
from raydp_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_attention_sharded,
    ulysses_attention,
)
from raydp_tpu_torch.parallel.sharding import (
    Placement,
    shard_params_by_rules,
    sharding_rules_fn,
)

__all__ = [
    "DataParallelPartitioner",
    "Mesh",
    "NullPartitioner",
    "Partitioner",
    "Placement",
    "axis_env_size",
    "bound_axes",
    "moe_apply",
    "moe_sharded",
    "pipeline_apply",
    "pipeline_sharded",
    "data_parallel_mesh",
    "full_attention",
    "make_mesh",
    "mesh_axis_size",
    "multihost_mesh",
    "ring_attention",
    "ring_attention_sharded",
    "shard_params_by_rules",
    "sharding_rules_fn",
    "ulysses_attention",
]
