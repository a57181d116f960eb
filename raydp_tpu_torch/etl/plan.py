"""Logical plan for the ETL engine.

A DataFrame is a tree of these nodes. Execution (planner.py) walks the tree,
fuses chains of narrow nodes into per-partition pipelines, and breaks stages at
wide (shuffle) boundaries — the same stage/shuffle split Spark performs inside
the reference's executors , but Arrow-native and
scheduled onto this framework's actor runtime.

All nodes are picklable dataclasses: plans ship to executor actors whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from raydp_tpu_torch.etl.expressions import AggExpr, Expr
from raydp_tpu_torch.store.object_store import ObjectRef


class PlanNode:
    """Base logical node. ``children`` drives generic tree traversal."""

    def children(self) -> List["PlanNode"]:
        return []


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


@dataclass
class ArrowSource(PlanNode):
    """Materialized partitions: Arrow IPC blocks already in the object store.
    This is also what cache() and shuffle outputs produce."""

    blocks: List[ObjectRef]
    schema: pa.Schema


@dataclass
class RangeSource(PlanNode):
    start: int
    end: int
    step: int
    num_partitions: int


@dataclass
class ParquetSource(PlanNode):
    """One partition per file group; executors read their groups directly."""

    file_groups: List[List[str]]
    columns: Optional[List[str]] = None


@dataclass
class CsvSource(PlanNode):
    file_groups: List[List[str]]
    read_options: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Narrow ops (per-partition, fused into one pipeline per stage)
# ---------------------------------------------------------------------------


@dataclass
class Project(PlanNode):
    """select / withColumn / drop, all normalized to (name, expr) pairs."""

    child: PlanNode
    columns: List[Tuple[str, Expr]]

    def children(self):
        return [self.child]


@dataclass
class Filter(PlanNode):
    child: PlanNode
    predicate: Expr

    def children(self):
        return [self.child]


@dataclass
class MapBatches(PlanNode):
    """Arbitrary table→table function (the mapInPandas analog)."""

    child: PlanNode
    fn: Callable[[pa.Table], pa.Table]

    def children(self):
        return [self.child]


@dataclass
class Sample(PlanNode):
    child: PlanNode
    fraction: float
    seed: Optional[int]

    def children(self):
        return [self.child]


@dataclass
class PartitionHead(PlanNode):
    """Per-partition head; the driver trims the concatenation to n globally."""

    child: PlanNode
    n: int

    def children(self):
        return [self.child]


@dataclass
class GlobalLimit(PlanNode):
    """Wraps PartitionHead to record the global n; execution is a passthrough
    (each partition already took its head), actions trim the final result."""

    child: PlanNode
    n: int

    def children(self):
        return [self.child]


@dataclass
class Union(PlanNode):
    """Concatenation of inputs' partitions (schemas must match)."""

    inputs: List[PlanNode]

    def children(self):
        return list(self.inputs)


# ---------------------------------------------------------------------------
# Wide ops (stage boundaries: hash / range / random shuffle)
# ---------------------------------------------------------------------------


@dataclass
class Repartition(PlanNode):
    child: PlanNode
    num_partitions: int
    by: Optional[List[str]] = None  # hash cols; None = round-robin rebalance
    shuffle_seed: Optional[int] = None  # set → random_shuffle semantics

    def children(self):
        return [self.child]


@dataclass
class GroupByAgg(PlanNode):
    """Two-phase hash aggregation (partial map-side, merge reduce-side)."""

    child: PlanNode
    keys: List[str]
    aggs: List[AggExpr]
    num_partitions: Optional[int] = None

    def children(self):
        return [self.child]


@dataclass
class Join(PlanNode):
    left: PlanNode
    right: PlanNode
    on: List[str]
    how: str = "inner"  # inner | left outer | right outer | full outer | left semi | left anti
    num_partitions: Optional[int] = None
    # "right" forces broadcasting the right side to every left partition (no
    # shuffle of either side); None lets the planner auto-broadcast when the
    # right side is materialized and under the size threshold
    broadcast: Optional[str] = None

    def children(self):
        return [self.left, self.right]


@dataclass
class Sort(PlanNode):
    """Sample-based range partitioning then per-partition sort: output
    partitions are globally ordered and non-overlapping."""

    child: PlanNode
    keys: List[str]
    ascending: List[bool]
    num_partitions: Optional[int] = None

    def children(self):
        return [self.child]


@dataclass
class Distinct(PlanNode):
    child: PlanNode
    num_partitions: Optional[int] = None

    def children(self):
        return [self.child]


@dataclass
class Window(PlanNode):
    """Window functions over (partition_by, order_by): hash-shuffle rows so
    each partition-key group lands whole on one reducer, sort within, and
    append the window columns (Spark window semantics; no frame clause —
    row_number/rank/lag/lead/cumulative)."""

    child: PlanNode
    partition_by: List[str]
    order_by: List[str]
    ascending: List[bool]
    exprs: List[Tuple[str, Any]]  # (output name, expressions.WindowExpr)
    num_partitions: Optional[int] = None

    def children(self):
        return [self.child]
