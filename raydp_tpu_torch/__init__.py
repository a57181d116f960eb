"""PyTorch/CUDA port of ``raydp_tpu`` for NVIDIA Hopper.

The package mirrors ``raydp_tpu``'s layout (``ops``, ``models``, ``parallel``,
``serve``, ``estimator``, ``exchange``, ``obs``, ``cluster``, ``store``)
module for module, so each counterpart sits at the same path. It imports
``torch``, numpy, cloudpickle, pyarrow and pandas (the store, the ETL
engine and the exchange's ``Dataset``) and the stdlib only: nothing of JAX
and nothing of ``raydp_tpu``.
Every kernel that the JAX package wrote in Pallas is written here by hand in
CUDA C++ for ``sm_90a`` (``csrc/``), built at first use and bound with
``ctypes`` (``ops/_build.py``); beside each kernel sits a plain PyTorch
version that runs only for CPU tensors.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise
(``raydp_tpu_torch._device.resolve_device``, imported lazily: the cluster's
head, agents and zygote import this package without torch).

Ported so far:

1. decode serving of ``TransformerLM`` (``serve.decode``, ``serve.kvcache``);
2. training of ``TransformerLM`` (the flash backward, ``remat``);
3. DLRM training through the estimator on one card
   (``estimator.Estimator`` with ``models.dlrm.DLRM``, ``models.mlp``,
   ``optim`` and the dot-interaction kernel), staging from numpy
   (``exchange.dataset.ArrayDataset``) or from the store's ``Dataset``;
4. the int8 path (stochastic rounding, the int8 product);
5. the estimator's streamed, checkpointed and retried fit, and ``obs``;
6. the decode engine's obs;
7. the cluster runtime (``cluster``: head, actor workers, zygote, node
   agents, the client API) with obs shipped to the head, and the lockdep
   and leak sanitizers (``sanitize``);
8. the object store and block service (``store``: Arrow IPC blocks in
   shared memory, ownership at the head, the spill tier, the remote fetch
   and the per-host block service), with the head's object,
   block-service and tenant tables;
9. the ETL engine (``etl``: sessions, DataFrames, the planner and its
   executors, lineage), the store's ``exchange.dataset.Dataset`` and
   ``MLDataset``, ``utils``, the tenancy registry's session half, and
   ``Estimator.fit_on_etl``;
10. the ETL session's surfaces (``tenancy.fair_share_series``,
    ``ServeConf``'s session merge, ``explain_last_query``, the serving
    scenarios in ``chaos``) and sequence parallelism over
    ``torch.distributed`` (``parallel``: meshes of ranks, ring and Ulysses
    attention; ``models.sequence_parallel_apply``);
11. data and model parallelism: the partitioners and the sharding rules
    (``parallel``), the vocab-sharded embedding (``ops.embedding``), the
    estimator's ``mesh`` and ``param_sharding_rules``, and the rank
    launcher (``spmd``: ``create_spmd_job``, ``elastic_fit``);
12. pipeline and expert parallelism over ``torch.distributed``
    (``parallel.pipeline``, ``parallel.moe``);
13. the other estimators (``estimator.TorchEstimator``, DDP ranks on the
    card; ``estimator.XGBoostEstimator`` over the native GBDT and
    ``estimator.TFEstimator``, both on the hosts' CPUs), the estimator
    package's and this root's exports, and the submit CLI (``submit``,
    ``raydp-tpu-torch-submit``).
"""

# name -> (module, attribute); None = the module itself. Resolved at first
# access: the cluster's head, agents and zygote import modules of this
# package without torch or pyarrow
_LAZY = {
    "resolve_device": ("raydp_tpu_torch._device", "resolve_device"),
    "init_etl": ("raydp_tpu_torch.etl.session", "init_etl"),
    "stop_etl": ("raydp_tpu_torch.etl.session", "stop_etl"),
    # the names users of the Spark-based API know
    "init_spark": ("raydp_tpu_torch.etl.session", "init_etl"),
    "stop_spark": ("raydp_tpu_torch.etl.session", "stop_etl"),
    "dataframe_to_dataset": ("raydp_tpu_torch.exchange.dataset",
                             "dataframe_to_dataset"),
    "dataset_to_dataframe": ("raydp_tpu_torch.exchange.dataset",
                             "dataset_to_dataframe"),
    "from_etl_recoverable": ("raydp_tpu_torch.exchange.dataset",
                             "from_etl_recoverable"),
    "Dataset": ("raydp_tpu_torch.exchange.dataset", "Dataset"),
    "MLDataset": ("raydp_tpu_torch.exchange.ml_dataset", "MLDataset"),
    "tenancy": ("raydp_tpu_torch.tenancy", None),
    "explain_last_query": ("raydp_tpu_torch.obs", "explain_last_query"),
    # the flagship estimator, where the JAX package has JaxEstimator
    "Estimator": ("raydp_tpu_torch.estimator.estimator", "Estimator"),
    "create_spmd_job": ("raydp_tpu_torch.spmd.job", "create_spmd_job"),
    "elastic_fit": ("raydp_tpu_torch.spmd.elastic", "elastic_fit"),
    # client mode: attach a second driver to a running cluster
    "connect_cluster": ("raydp_tpu_torch.cluster.api", "connect_cluster"),
    # the observability plane: trace export and the cluster's metrics
    "export_trace": ("raydp_tpu_torch.obs", "export_trace"),
    "dump_metrics": ("raydp_tpu_torch.cluster.api", "dump_metrics"),
    "query_metrics": ("raydp_tpu_torch.cluster.api", "query_metrics"),
    # the serving plane, as a subpackage
    "serve": ("raydp_tpu_torch.serve", None),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        loaded = importlib.import_module(module)
        value = loaded if attr is None else getattr(loaded, attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
