"""Process-group bootstrap: the counterpart of
``raydp_tpu/spmd/bootstrap.py``, with ``torch.distributed`` in place of
``jax.distributed``.

``initialize_from_env`` brings up the default process group from its
arguments or from the environment the rank launcher (``spmd/job.py``) or
another scheduler provides; after it ``parallel.make_mesh`` and
``multihost_mesh`` lay their axes over the group's ranks. The backend
follows the devices: gloo on the CPU, NCCL where every rank of the host
has a card of its own (rank r takes card ``r % device_count``), gloo
where ranks share one card (it takes CUDA tensors for its all-reduce and
broadcast, not for point-to-point).
"""

from __future__ import annotations

import os
from typing import Optional

COORD_ENV = "RAYDP_TPU_TORCH_COORDINATOR"
RANK_ENV = "RAYDP_TPU_TORCH_SPMD_RANK"
WORLD_ENV = "RAYDP_TPU_TORCH_SPMD_WORLD_SIZE"


def default_backend(world: int) -> str:
    """gloo without a card or with fewer cards than ranks, else NCCL."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        return "gloo"
    return "nccl"


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[str]:
    """Bring up ``torch.distributed`` from the arguments or the
    environment: the coordinator ``host:port`` (rank 0 listens there), the
    world size and this process's rank. Idempotent, and a no-op for one
    process or without a coordinator. Returns the backend of the default
    group (None when there is none)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    coordinator = coordinator_address or os.environ.get(COORD_ENV)
    world = num_processes if num_processes is not None else int(
        os.environ.get(WORLD_ENV, "1"))
    rank = process_id if process_id is not None else int(
        os.environ.get(RANK_ENV, "0"))
    if world <= 1 or coordinator is None:
        return None
    backend = default_backend(world)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return backend


def process_rank() -> int:
    return int(os.environ.get(RANK_ENV, "0"))


def world_size() -> int:
    return int(os.environ.get(WORLD_ENV, "1"))
