"""Arrow-native distributed ETL engine on the cluster actor runtime.

The port's own copy of ``raydp_tpu/etl``. It replaces a Spark-on-Ray stack
(JVM AppMaster, executor actors, py4j gateway) with an all-Python-and-Arrow engine: lazy
DataFrames compile to fused per-partition pipelines scheduled onto restartable
executor actors; shuffles ride the shared-memory object store.
"""

from raydp_tpu_torch.etl import functions
from raydp_tpu_torch.etl.dataframe import DataFrame, GroupedData
from raydp_tpu_torch.etl.expressions import AggExpr, Expr
from raydp_tpu_torch.etl.functions import col, lit
from raydp_tpu_torch.etl.session import (
    EtlSession,
    active_session,
    init_etl,
    stop_etl,
)

__all__ = [
    "AggExpr",
    "DataFrame",
    "EtlSession",
    "Expr",
    "GroupedData",
    "active_session",
    "col",
    "functions",
    "init_etl",
    "lit",
    "stop_etl",
]
