"""The port's estimator: ``Estimator``, the one-card counterpart of
``raydp_tpu.estimator.JaxEstimator``, and its metric registry."""

from raydp_tpu_torch.estimator.estimator import Estimator

__all__ = ["Estimator"]
