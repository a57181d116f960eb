"""Models of the port and their flax weight converters (``convert``):
``TransformerLM`` (decode serving, slice 1; training, slice 2; sequence
parallelism through ``sequence_parallel_apply``, slice 18), and ``DLRM``
with ``MLPRegressor`` and ``MLPClassifier`` (DLRM training through the
estimator, slice 3; its tables split over a mesh of ranks by
``dlrm_sharding_rules``)."""

from raydp_tpu_torch.models.dlrm import DLRM, dlrm_optimizer, dlrm_sharding_rules
from raydp_tpu_torch.models.mlp import MLPClassifier, MLPRegressor
from raydp_tpu_torch.models.transformer import TransformerLM, sequence_parallel_apply

__all__ = [
    "DLRM",
    "MLPClassifier",
    "MLPRegressor",
    "TransformerLM",
    "dlrm_optimizer",
    "dlrm_sharding_rules",
    "sequence_parallel_apply",
]
