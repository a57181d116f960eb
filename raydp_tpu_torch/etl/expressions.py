"""Column expression language for the ETL engine.

The reference's ETL surface is Spark SQL (DataFrames executed by the
JVM); this framework's ETL engine is Arrow-native, so expressions are
a small picklable AST compiled to ``pyarrow.compute`` calls that run vectorized
on each partition. Covers the expression shapes the reference's examples and
tests actually exercise (projections, arithmetic, comparisons, casts, boolean
logic, null handling, string/time functions — e.g. the NYCTaxi feature
engineering in examples/data_process.py and the DLRM preprocessing notebook).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

# ---------------------------------------------------------------------------
# AST nodes. All picklable (plain dataclasses) so plans ship to executors.
# ---------------------------------------------------------------------------


class Expr:
    """Base class for expression nodes; evaluates against a RecordBatch/Table."""

    def evaluate(self, table: pa.Table) -> pa.ChunkedArray:
        raise NotImplementedError

    def name_hint(self) -> str:
        return "expr"

    def references(self) -> List[str]:
        """Column names this expression reads (for projection pushdown)."""
        return []

    # -- operator sugar (mirrors the pyspark Column operator surface) --

    def _bin(self, op: str, other) -> "Expr":
        return BinaryOp(op, self, _to_expr(other))

    def _rbin(self, op: str, other) -> "Expr":
        return BinaryOp(op, _to_expr(other), self)

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._rbin("add", o)

    def __sub__(self, o):
        return self._bin("subtract", o)

    def __rsub__(self, o):
        return self._rbin("subtract", o)

    def __mul__(self, o):
        return self._bin("multiply", o)

    def __rmul__(self, o):
        return self._rbin("multiply", o)

    def __truediv__(self, o):
        return self._bin("divide", o)

    def __rtruediv__(self, o):
        return self._rbin("divide", o)

    def __mod__(self, o):
        return self._bin("mod", o)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("equal", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("not_equal", o)

    def __lt__(self, o):
        return self._bin("less", o)

    def __le__(self, o):
        return self._bin("less_equal", o)

    def __gt__(self, o):
        return self._bin("greater", o)

    def __ge__(self, o):
        return self._bin("greater_equal", o)

    def __and__(self, o):
        return self._bin("and_kleene", o)

    def __rand__(self, o):
        return self._rbin("and_kleene", o)

    def __or__(self, o):
        return self._bin("or_kleene", o)

    def __ror__(self, o):
        return self._rbin("or_kleene", o)

    def __invert__(self):
        return UnaryOp("invert", self)

    def __neg__(self):
        return UnaryOp("negate", self)

    def __hash__(self):  # __eq__ is overloaded; keep Exprs usable in sets
        return id(self)

    # -- named methods --

    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    def cast(self, dtype) -> "Expr":
        return Cast(self, dtype)

    def astype(self, dtype) -> "Expr":
        return Cast(self, dtype)

    def is_null(self) -> "Expr":
        return UnaryOp("is_null", self)

    def is_not_null(self) -> "Expr":
        return UnaryOp("is_valid", self)

    # pyspark-style names
    def isNull(self) -> "Expr":
        return self.is_null()

    def isNotNull(self) -> "Expr":
        return self.is_not_null()

    def isin(self, *values) -> "Expr":
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return IsIn(self, list(values))

    def between(self, low, high) -> "Expr":
        return (self >= low) & (self <= high)

    def fill_null(self, value) -> "Expr":
        return Function("coalesce", [self, _to_expr(value)])

    def substr(self, start: int, length: int) -> "Expr":
        """1-based start (Spark convention; negative counts from the end)."""
        return substring_expr(self, start, length)


def _to_expr(value) -> Expr:
    return value if isinstance(value, Expr) else Literal(value)


def substring_expr(child: "Expr", pos: int, length: int) -> "Expr":
    """Spark ``substring`` semantics over arrow's slice kernel — the ONE
    place the position convention lives (``Expr.substr`` and
    ``F.substring`` both call it): 1-based start, 0 treated as 1, negative
    counts from the end (substring('hello', -2, 2) == 'lo')."""
    if pos > 0:
        start = pos - 1
    elif pos == 0:
        start = 0
    else:
        start = pos
    if start < 0 and length >= -start:
        # from-the-end slice reaching the end: a computed non-negative stop
        # would be read as an absolute position by arrow
        options = {"start": start}
    else:
        options = {"start": start, "stop": start + length}
    return Function("utf8_slice_codeunits", [child], options=options)


@dataclass(eq=False)
class ColumnRef(Expr):
    name: str

    def evaluate(self, table: pa.Table):
        try:
            return table.column(self.name)
        except KeyError:
            raise KeyError(
                f"column {self.name!r} not found; available: {table.column_names}"
            ) from None

    def name_hint(self) -> str:
        return self.name

    def references(self) -> List[str]:
        return [self.name]


@dataclass(eq=False)
class Literal(Expr):
    value: Any

    def evaluate(self, table: pa.Table):
        return pa.scalar(self.value)

    def name_hint(self) -> str:
        return str(self.value)


@dataclass(eq=False)
class Alias(Expr):
    child: Expr
    name: str

    def evaluate(self, table: pa.Table):
        return self.child.evaluate(table)

    def name_hint(self) -> str:
        return self.name

    def references(self) -> List[str]:
        return self.child.references()


@dataclass(eq=False)
class Cast(Expr):
    child: Expr
    dtype: Any  # pa.DataType or string name

    def evaluate(self, table: pa.Table):
        target = _resolve_dtype(self.dtype)
        return pc.cast(self.child.evaluate(table), target, safe=False)

    def name_hint(self) -> str:
        return self.child.name_hint()

    def references(self) -> List[str]:
        return self.child.references()


_DTYPE_ALIASES = {
    "int": pa.int64(),
    "long": pa.int64(),
    "bigint": pa.int64(),
    "int32": pa.int32(),
    "int64": pa.int64(),
    "float": pa.float32(),
    "float32": pa.float32(),
    "double": pa.float64(),
    "float64": pa.float64(),
    "bool": pa.bool_(),
    "boolean": pa.bool_(),
    "string": pa.string(),
    "str": pa.string(),
    "date": pa.date32(),
    "timestamp": pa.timestamp("us"),
}


def _resolve_dtype(dtype) -> pa.DataType:
    if isinstance(dtype, pa.DataType):
        return dtype
    key = str(dtype).lower()
    if key in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[key]
    raise ValueError(f"unknown dtype {dtype!r}")


@dataclass(eq=False)
class BinaryOp(Expr):
    op: str  # a pyarrow.compute function of two args
    left: Expr
    right: Expr

    def evaluate(self, table: pa.Table):
        left = self.left.evaluate(table)
        right = self.right.evaluate(table)
        if self.op == "mod":  # arrow has no mod kernel: x - (x // y) * y
            quotient = pc.divide(left, right)
            if pa.types.is_floating(_value_type(quotient)):
                quotient = pc.floor(quotient)
            return pc.subtract(left, pc.multiply(quotient, right))
        return getattr(pc, self.op)(left, right)

    def name_hint(self) -> str:
        return f"({self.left.name_hint()} {self.op} {self.right.name_hint()})"

    def references(self) -> List[str]:
        return self.left.references() + self.right.references()


@dataclass(eq=False)
class UnaryOp(Expr):
    op: str
    child: Expr

    def evaluate(self, table: pa.Table):
        return getattr(pc, self.op)(self.child.evaluate(table))

    def name_hint(self) -> str:
        return f"{self.op}({self.child.name_hint()})"

    def references(self) -> List[str]:
        return self.child.references()


@dataclass(eq=False)
class IsIn(Expr):
    child: Expr
    values: List[Any]

    def evaluate(self, table: pa.Table):
        return pc.is_in(self.child.evaluate(table), value_set=pa.array(self.values))

    def references(self) -> List[str]:
        return self.child.references()


@dataclass(eq=False)
class Function(Expr):
    """Call an arbitrary pyarrow.compute function over evaluated children."""

    fn: str
    args: List[Expr]
    options: Optional[Dict[str, Any]] = None

    def evaluate(self, table: pa.Table):
        evaluated = [a.evaluate(table) for a in self.args]
        return getattr(pc, self.fn)(*evaluated, **(self.options or {}))

    def name_hint(self) -> str:
        return f"{self.fn}({', '.join(a.name_hint() for a in self.args)})"

    def references(self) -> List[str]:
        out: List[str] = []
        for a in self.args:
            out.extend(a.references())
        return out


@dataclass(eq=False)
class When(Expr):
    """CASE WHEN chain: when(cond, val).when(...).otherwise(default)."""

    branches: List[Tuple[Expr, Expr]]
    default: Optional[Expr] = None

    def when(self, cond, value) -> "When":
        return When(self.branches + [(_to_expr(cond), _to_expr(value))], self.default)

    def otherwise(self, value) -> "When":
        return When(self.branches, _to_expr(value))

    def evaluate(self, table: pa.Table):
        conds = pa.StructArray.from_arrays(
            [_as_array(c.evaluate(table), table.num_rows) for c, _ in self.branches],
            names=[f"c{i}" for i in range(len(self.branches))],
        )
        cases = [v.evaluate(table) for _, v in self.branches]
        default = (
            self.default.evaluate(table)
            if self.default is not None
            else pa.scalar(None)
        )
        return pc.case_when(conds, *cases, default)

    def references(self) -> List[str]:
        out: List[str] = []
        for c, v in self.branches:
            out.extend(c.references())
            out.extend(v.references())
        if self.default is not None:
            out.extend(self.default.references())
        return out


@dataclass(eq=False)
class Udf(Expr):
    """Row-vectorized python UDF: fn(*numpy_or_arrow_arrays) -> array-like."""

    func: Callable
    args: List[Expr]
    dtype: Optional[Any] = None

    def evaluate(self, table: pa.Table):
        arrays = [
            _as_array(a.evaluate(table), table.num_rows) for a in self.args
        ]
        result = self.func(*arrays)
        if isinstance(result, (pa.Array, pa.ChunkedArray)):
            out = result
        else:
            out = pa.array(np.asarray(result))
        if self.dtype is not None:
            out = pc.cast(out, _resolve_dtype(self.dtype), safe=False)
        return out

    def references(self) -> List[str]:
        out: List[str] = []
        for a in self.args:
            out.extend(a.references())
        return out


def _value_type(value) -> pa.DataType:
    return value.type


# ---------------------------------------------------------------------------
# Fusion support: substitution + shared-subexpression evaluation.
#
# The planner's project-fusion pass collapses Project(Project(x)) chains into
# one Project by substituting the inner project's (name → expr) map into the
# outer expressions. A substituted expression can appear at several use sites
# (e.g. dx feeding both the dx output column and the dist formula), so
# substitution inserts ONE SharedExpr node per inner column and evaluation
# memoizes per use: the fused plan does exactly the work of the unfused one.
# ---------------------------------------------------------------------------

import threading as _threading

_shared_eval_tls = _threading.local()


class _SharedEvalCache:
    """Context manager scoping one memo dict to one Project application (the
    cache must not leak across tables or threads — executor actors run tasks
    concurrently, and thread-local scoping keeps each task's memo private)."""

    def __enter__(self):
        self._prev = getattr(_shared_eval_tls, "cache", None)
        _shared_eval_tls.cache = {}
        return self

    def __exit__(self, *exc):
        _shared_eval_tls.cache = self._prev
        return False


def shared_eval_cache() -> _SharedEvalCache:
    return _SharedEvalCache()


@dataclass(eq=False)
class SharedExpr(Expr):
    """A subexpression referenced from several places in a fused projection.
    Inside a ``shared_eval_cache()`` scope it evaluates its child once and
    serves every other use from the memo; outside one it is transparent."""

    child: Expr

    def evaluate(self, table: pa.Table):
        cache = getattr(_shared_eval_tls, "cache", None)
        if cache is None:
            return self.child.evaluate(table)
        key = id(self)
        if key not in cache:
            cache[key] = self.child.evaluate(table)
        return cache[key]

    def name_hint(self) -> str:
        return self.child.name_hint()

    def references(self) -> List[str]:
        return self.child.references()


class CannotSubstitute(TypeError):
    """Raised for expression node types substitution does not understand —
    the fusion pass catches it and leaves the chain unfused (correctness
    over fusion for user-defined Expr subclasses)."""


def substitute(expr: Expr, mapping: Dict[str, Expr]) -> Expr:
    """Rebuild ``expr`` with every ColumnRef replaced per ``mapping``
    (references absent from the mapping stay as-is). Mapping values are
    inserted by reference, NOT recursed into — they are already expressed
    over the base table, and sharing the node object is what lets
    SharedExpr de-duplicate their evaluation."""
    if isinstance(expr, ColumnRef):
        return mapping.get(expr.name, expr)
    if isinstance(expr, (Literal, SharedExpr)):
        return expr
    if isinstance(expr, Alias):
        return Alias(substitute(expr.child, mapping), expr.name)
    if isinstance(expr, Cast):
        return Cast(substitute(expr.child, mapping), expr.dtype)
    if isinstance(expr, BinaryOp):
        return BinaryOp(
            expr.op,
            substitute(expr.left, mapping),
            substitute(expr.right, mapping),
        )
    if isinstance(expr, UnaryOp):
        return UnaryOp(expr.op, substitute(expr.child, mapping))
    if isinstance(expr, IsIn):
        return IsIn(substitute(expr.child, mapping), expr.values)
    if isinstance(expr, Function):
        return Function(
            expr.fn, [substitute(a, mapping) for a in expr.args], expr.options
        )
    if isinstance(expr, When):
        return When(
            [
                (substitute(c, mapping), substitute(v, mapping))
                for c, v in expr.branches
            ],
            None if expr.default is None else substitute(expr.default, mapping),
        )
    if isinstance(expr, Udf):
        return Udf(expr.func, [substitute(a, mapping) for a in expr.args], expr.dtype)
    raise CannotSubstitute(type(expr).__name__)


def merge_projects(
    inner: List[Tuple[str, Expr]], outer: List[Tuple[str, Expr]]
) -> List[Tuple[str, Expr]]:
    """Compose two adjacent projections into one: the outer's expressions
    rewritten over the inner's inputs. Computed inner columns are wrapped in
    ONE SharedExpr each so multi-use sites evaluate them once."""
    mapping: Dict[str, Expr] = {}
    for name, expr in inner:
        if isinstance(expr, (ColumnRef, Literal, SharedExpr)):
            mapping[name] = expr
        elif isinstance(expr, Alias) and isinstance(expr.child, (ColumnRef, Literal)):
            mapping[name] = expr.child
        else:
            mapping[name] = SharedExpr(expr)
    return [(name, substitute(expr, mapping)) for name, expr in outer]


def _as_array(value, num_rows: int):
    """Broadcast scalars so struct/case_when see equal-length arrays."""
    if isinstance(value, pa.Scalar):
        return pa.repeat(value, num_rows)
    if isinstance(value, pa.ChunkedArray):
        return value.combine_chunks()
    return value


# ---------------------------------------------------------------------------
# Aggregate expressions (used by DataFrame.group_by().agg() and df.agg()).
# Two-phase: partial per partition, merge on the reducer — this is what makes
# the shuffle ship pre-aggregated blocks instead of raw rows.
# ---------------------------------------------------------------------------

# agg -> (map-side arrow agg, reduce-side arrow agg over partials)
_AGG_PHASES: Dict[str, Tuple[str, str]] = {
    "sum": ("sum", "sum"),
    "min": ("min", "min"),
    "max": ("max", "max"),
    "count": ("count", "sum"),
    "first": ("first", "first"),
    "last": ("last", "last"),
    "any": ("any", "any"),
    "all": ("all", "all"),
}


# aggregates that decompose into SEVERAL partials (mean → sum+count;
# var/stddev → sum+sum-of-squares+count, merged with the standard
# E[x²]−E[x]² identity and Bessel correction for the _samp variants)
_COMPOSITE_AGGS = ("mean", "var_samp", "var_pop", "stddev_samp", "stddev_pop")


@dataclass(eq=False)
class AggExpr:
    """Aggregation of one input column. Composite aggregates (``mean``,
    ``var_*``, ``stddev_*``) decompose into simple partials so the shuffle
    still ships pre-aggregated blocks."""

    agg: str  # sum | min | max | count | mean | var_* | stddev_* | first | ...
    column: str
    out_name: str

    def __post_init__(self):
        if self.agg not in _AGG_PHASES and self.agg not in _COMPOSITE_AGGS:
            raise ValueError(f"unsupported aggregate {self.agg!r}")

    def alias(self, name: str) -> "AggExpr":
        return AggExpr(self.agg, self.column, name)


@dataclass(eq=False)
class WindowExpr:
    """A window function bound to its (partition_by, order_by) spec via
    ``.over(...)`` in the F namespace. Executed by ``tasks.window_compute``
    after a hash shuffle on the partition keys (Spark window semantics;
    the reference gets these free from Spark SQL)."""

    kind: str  # row_number | rank | dense_rank | lag | lead | cum_sum
    column: Optional[str] = None  # input column (lag/lead/cum_sum)
    offset: int = 1  # lag/lead distance
    default: Any = None  # lag/lead fill for out-of-partition rows (None=null)
    partition_by: List[str] = None  # type: ignore[assignment]
    order_by: List[str] = None  # type: ignore[assignment]
    ascending: List[bool] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.kind not in (
            "row_number", "rank", "dense_rank", "lag", "lead", "cum_sum"
        ):
            raise ValueError(f"unsupported window function {self.kind!r}")

    @property
    def bound(self) -> bool:
        return self.partition_by is not None
