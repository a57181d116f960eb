"""Cluster runtime of the port: process actors, placement groups, virtual
nodes -- its own copy of ``raydp_tpu/cluster``, with the same ``__all__``.

See common.py for the wire protocol, head.py for the control-plane service,
worker.py for the actor host, zygote.py for the fork template, agent.py for
a node on another host and api.py for the client API. It imports no torch:
an actor's class brings torch and the card with it.
"""

from raydp_tpu_torch.cluster.api import (
    ActorHandle,
    PlacementGroup,
    add_node,
    available_resources,
    create_placement_group,
    dump_metrics,
    export_trace,
    get,
    get_actor,
    head_rpc,
    init,
    is_initialized,
    kill_all_matching,
    list_actors,
    nodes,
    placement_group_table,
    remove_node,
    remove_placement_group,
    session_dir,
    shutdown,
    spawn,
    total_resources,
)
from raydp_tpu_torch.cluster.common import (
    ActorDiedError,
    ActorState,
    ClusterError,
    OwnerDiedError,
)
from raydp_tpu_torch.cluster.worker import current_context, exit_actor

__all__ = [
    "ActorDiedError",
    "ActorHandle",
    "ActorState",
    "ClusterError",
    "OwnerDiedError",
    "PlacementGroup",
    "add_node",
    "available_resources",
    "create_placement_group",
    "current_context",
    "dump_metrics",
    "exit_actor",
    "export_trace",
    "get",
    "get_actor",
    "head_rpc",
    "init",
    "is_initialized",
    "kill_all_matching",
    "list_actors",
    "nodes",
    "placement_group_table",
    "remove_node",
    "remove_placement_group",
    "session_dir",
    "shutdown",
    "spawn",
    "total_resources",
]
