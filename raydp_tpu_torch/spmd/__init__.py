"""SPMD runtime of the port: the rank launcher on the cluster runtime
(``job.py``), the ``torch.distributed`` bootstrap (``bootstrap.py``) and
the elastic watchdog (``elastic.py``), under the JAX package's names."""

from raydp_tpu_torch.spmd.bootstrap import initialize_from_env, process_rank, world_size
from raydp_tpu_torch.spmd.elastic import elastic_fit
from raydp_tpu_torch.spmd.job import SpmdJob, SpmdWorker, WorkerContext, create_spmd_job

__all__ = [
    "SpmdJob",
    "SpmdWorker",
    "WorkerContext",
    "create_spmd_job",
    "elastic_fit",
    "initialize_from_env",
    "process_rank",
    "world_size",
]
