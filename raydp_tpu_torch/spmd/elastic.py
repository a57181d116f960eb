"""Elastic training across ranks: the counterpart of
``raydp_tpu/spmd/elastic.py``, the rebuild-from-checkpoint watchdog.

A rank that dies cannot rejoin a running process group, so the recovery
is: see the dead rank (``SpmdJob.run`` fails fast), tear the gang down,
start a fresh one, and resume from the newest committed checkpoint. A
rank's death mid-fit costs the steps since that checkpoint. A collective
of ``torch.distributed`` whose peer died raises on the surviving ranks
(where ``jax.distributed`` would hang until the gang is torn down), and
that error may reach the driver before the death does: any error of a gang
that lost a rank restarts it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

from raydp_tpu_torch.cluster.common import ClusterError


# a rank's death, as the driver sees it
_RANK_DIED = (ClusterError, ConnectionError, EOFError, TimeoutError)
# how long a peer's error waits for the head to record the death behind it
_DEATH_GRACE_S = 10.0


def _invoke(fit_fn, resume_from_epoch, ctx):
    return fit_fn(ctx, resume_from_epoch)


def elastic_fit(
    fit_fn: Callable[[Any, Optional[int]], Any],
    world_size: int,
    checkpoint_dir: str,
    max_failures: int = 2,
    job_name: str = "elastic",
    env: Optional[Dict[str, str]] = None,
    num_cpus_per_worker: float = 1.0,
    timeout: float = 300.0,
    bootstrap: bool = True,
) -> List[Any]:
    """Run ``fit_fn(ctx, resume_from_epoch)`` on every rank of an SPMD gang
    (with ``torch.distributed`` brought up first when ``bootstrap``),
    restarting the WHOLE gang from the newest committed checkpoint when a
    rank dies mid-fit.

    ``fit_fn`` writes its checkpoints under ``checkpoint_dir``
    (``Estimator(checkpoint_dir=...)`` does) and honours the resume value
    it is given: None for a fresh start, an epoch, or ``(epoch, step)``
    when the newest checkpoint is a ``save_every_steps`` one, as the
    estimator's ``resume_from_epoch`` takes them. Returns the per-rank
    results of the first attempt that succeeds."""
    from raydp_tpu_torch.estimator.checkpoint import latest_checkpoint
    from raydp_tpu_torch.spmd.job import create_spmd_job

    failures = 0
    while True:
        latest = latest_checkpoint(checkpoint_dir)
        if latest is None:
            resume = None
        elif latest[1] is None:
            resume = latest[0]  # epoch complete
        else:
            resume = latest  # (epoch, step): resume mid-epoch
        job = create_spmd_job(
            f"{job_name}-a{failures}",
            world_size=world_size,
            env=env,
            num_cpus_per_worker=num_cpus_per_worker,
            timeout=timeout,
        )
        try:
            job.start()
            if bootstrap:
                job.bootstrap_torch()
            return job.run(
                functools.partial(_invoke, fit_fn, resume), timeout=timeout
            )
        except Exception as exc:
            if not isinstance(exc, _RANK_DIED) and not job.dead_ranks(
                    _DEATH_GRACE_S):
                raise
            failures += 1
            if failures > max_failures:
                raise
            # the next attempt resumes at the newest checkpoint that landed
            # before the failure
        finally:
            job.stop()
