"""Models of the port and their flax weight converters (``convert``):
``TransformerLM`` (decode serving, slice 1; training, slice 2; sequence
parallelism through ``sequence_parallel_apply``, slice 18), and ``DLRM``
with ``MLPRegressor`` and ``MLPClassifier`` (DLRM training through the
estimator, slice 3). ``dlrm_sharding_rules`` comes with ROADMAP Queue 1
item 3b and raises until then."""

from raydp_tpu_torch.models.dlrm import DLRM, dlrm_optimizer
from raydp_tpu_torch.models.mlp import MLPClassifier, MLPRegressor
from raydp_tpu_torch.models.transformer import TransformerLM, sequence_parallel_apply


def dlrm_sharding_rules(*args, **kwargs):
    raise NotImplementedError(
        "dlrm_sharding_rules is ported in ROADMAP Queue 1 item 3b (partitioner, "
        "sharding, embedding)")


__all__ = [
    "DLRM",
    "MLPClassifier",
    "MLPRegressor",
    "TransformerLM",
    "dlrm_optimizer",
    "dlrm_sharding_rules",
    "sequence_parallel_apply",
]
