"""Parallel layers of the port over ``torch.distributed``: meshes of ranks
(``mesh.py``) and sequence parallelism, ring and Ulysses attention
(``ring_attention.py``), under the names the JAX package's ``parallel``
exports.

The partitioners and sharding rules come with ROADMAP Queue 1 item 3b,
mixture-of-experts and pipeline parallelism with item 3c; until then those
names raise ``NotImplementedError``.
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
from raydp_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_attention_sharded,
    ulysses_attention,
)

_ITEM_3B = "ROADMAP Queue 1 item 3b (partitioner, sharding, embedding)"
_ITEM_3C = "ROADMAP Queue 1 item 3c (moe and pipeline)"


def _later_function(name: str, where: str):
    def later(*args, **kwargs):
        raise NotImplementedError(f"{name} is ported in {where}")

    later.__name__ = later.__qualname__ = name
    return later


def _later_class(name: str, where: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is ported in {where}")

    return type(name, (), {"__init__": __init__})


Partitioner = _later_class("Partitioner", _ITEM_3B)
NullPartitioner = _later_class("NullPartitioner", _ITEM_3B)
DataParallelPartitioner = _later_class("DataParallelPartitioner", _ITEM_3B)
shard_params_by_rules = _later_function("shard_params_by_rules", _ITEM_3B)
sharding_rules_fn = _later_function("sharding_rules_fn", _ITEM_3B)
moe_apply = _later_function("moe_apply", _ITEM_3C)
moe_sharded = _later_function("moe_sharded", _ITEM_3C)
pipeline_apply = _later_function("pipeline_apply", _ITEM_3C)
pipeline_sharded = _later_function("pipeline_sharded", _ITEM_3C)

__all__ = [
    "DataParallelPartitioner",
    "Mesh",
    "NullPartitioner",
    "Partitioner",
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
