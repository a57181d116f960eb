"""Parallel layers of the port over ``torch.distributed``: meshes of ranks
(``mesh.py``), sequence parallelism, ring and Ulysses attention
(``ring_attention.py``), the partitioners (``partitioner.py``) and the
parameter-sharding rules (``sharding.py``), under the names the JAX
package's ``parallel`` exports.

Mixture-of-experts and pipeline parallelism come with ROADMAP Queue 1
item 3c; until then those names raise ``NotImplementedError``.
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
from raydp_tpu_torch.parallel.partitioner import (
    DataParallelPartitioner,
    NullPartitioner,
    Partitioner,
)
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

_ITEM_3C = "ROADMAP Queue 1 item 3c (moe and pipeline)"


def _later_function(name: str, where: str):
    def later(*args, **kwargs):
        raise NotImplementedError(f"{name} is ported in {where}")

    later.__name__ = later.__qualname__ = name
    return later


moe_apply = _later_function("moe_apply", _ITEM_3C)
moe_sharded = _later_function("moe_sharded", _ITEM_3C)
pipeline_apply = _later_function("pipeline_apply", _ITEM_3C)
pipeline_sharded = _later_function("pipeline_sharded", _ITEM_3C)

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
