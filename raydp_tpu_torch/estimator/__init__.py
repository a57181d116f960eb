"""The port's estimator: ``Estimator``, the one-card counterpart of
the JAX package's ``JaxEstimator``, its checkpoints and its metric
registry."""

from raydp_tpu_torch.estimator.checkpoint import (
    latest_checkpoint,
    latest_checkpoint_epoch,
)
from raydp_tpu_torch.estimator.estimator import Estimator

__all__ = ["Estimator", "latest_checkpoint", "latest_checkpoint_epoch"]
