"""The user-facing distributed DataFrame.

Lazy: every method builds a logical plan (plan.py); actions drive the planner.
The method surface mirrors the Spark DataFrame API the reference exposes its
users to (pyspark names kept as aliases), so programs written against the
reference port mechanically — but execution is Arrow-native on this
framework's executor actors, not a JVM.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import pyarrow as pa

from raydp_tpu_torch.etl import plan as lp
from raydp_tpu_torch.etl import tasks as T
from raydp_tpu_torch.etl.expressions import AggExpr, Alias, ColumnRef, Expr
from raydp_tpu_torch.etl.planner import Materialized

ColumnLike = Union[str, Expr]


def _c(c: ColumnLike) -> Expr:
    return ColumnRef(c) if isinstance(c, str) else c


class DataFrame:
    def __init__(self, session, plan: lp.PlanNode):
        self._session = session
        self._plan = plan
        self._schema: Optional[pa.Schema] = None

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------

    @property
    def schema(self) -> pa.Schema:
        if self._schema is None:
            self._schema = self._session._planner.infer_schema(self._plan)
        return self._schema

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    @property
    def dtypes(self) -> List[Tuple[str, str]]:
        return [(f.name, str(f.type)) for f in self.schema]

    def __getitem__(self, name: str) -> Expr:
        return ColumnRef(name)

    def __repr__(self) -> str:
        cols = ", ".join(f"{f.name}: {f.type}" for f in self.schema)
        return f"DataFrame[{cols}]"

    # ------------------------------------------------------------------
    # narrow transformations
    # ------------------------------------------------------------------

    def _named(self, c: ColumnLike) -> Tuple[str, Expr]:
        expr = _c(c)
        if isinstance(expr, Alias):
            return expr.name, expr
        return expr.name_hint(), expr

    def select(self, *cols: ColumnLike) -> "DataFrame":
        flat: List[ColumnLike] = []
        for c in cols:
            if isinstance(c, (list, tuple)):
                flat.extend(c)
            elif isinstance(c, str) and c == "*":
                flat.extend(self.columns)
            else:
                flat.append(c)
        named = [self._named(c) for c in flat]
        return DataFrame(self._session, lp.Project(self._plan, named))

    def with_column(self, name: str, expr: ColumnLike) -> "DataFrame":
        from raydp_tpu_torch.etl.expressions import WindowExpr

        if isinstance(expr, WindowExpr):
            if not expr.bound:
                raise ValueError(
                    "window function must be bound with .over(...) before use"
                )
            child = self._plan
            if name in self.columns:
                # withColumn replaces: the window compute appends (which
                # would duplicate the name), and the expr may READ the old
                # column — compute into a temp name, then project-rename
                tmp = f"__window__{name}"
                win = lp.Window(
                    child, list(expr.partition_by), list(expr.order_by),
                    list(expr.ascending), [(tmp, expr)],
                )
                named = [
                    (c, ColumnRef(c)) for c in self.columns if c != name
                ] + [(name, ColumnRef(tmp))]
                return DataFrame(self._session, lp.Project(win, named))
            if (
                isinstance(child, lp.Window)
                and child.partition_by == list(expr.partition_by)
                and child.order_by == list(expr.order_by)
                and child.ascending == list(expr.ascending)
                and name not in {n for n, _ in child.exprs}
                and (
                    expr.column is None
                    or expr.column not in {n for n, _ in child.exprs}
                )
            ):
                # same window spec back-to-back: batch into ONE shuffle+sort
                return DataFrame(
                    self._session,
                    lp.Window(
                        child.child, child.partition_by, child.order_by,
                        child.ascending, list(child.exprs) + [(name, expr)],
                        child.num_partitions,
                    ),
                )
            return DataFrame(
                self._session,
                lp.Window(
                    child, list(expr.partition_by), list(expr.order_by),
                    list(expr.ascending), [(name, expr)],
                ),
            )
        named = [(c, ColumnRef(c)) for c in self.columns if c != name]
        named.append((name, _c(expr)))
        return DataFrame(self._session, lp.Project(self._plan, named))

    withColumn = with_column

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        named = [
            (new if c == old else c, ColumnRef(c)) for c in self.columns
        ]
        return DataFrame(self._session, lp.Project(self._plan, named))

    withColumnRenamed = with_column_renamed

    def drop(self, *names: str) -> "DataFrame":
        dropped = set(names)
        named = [(c, ColumnRef(c)) for c in self.columns if c not in dropped]
        return DataFrame(self._session, lp.Project(self._plan, named))

    def filter(self, predicate: Expr) -> "DataFrame":
        return DataFrame(self._session, lp.Filter(self._plan, predicate))

    where = filter

    def dropna(self, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        cols = list(subset) if subset else self.columns
        pred: Optional[Expr] = None
        for c in cols:
            term = ColumnRef(c).is_not_null()
            pred = term if pred is None else (pred & term)
        return self.filter(pred) if pred is not None else self

    def fillna(self, value, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        targets = set(subset) if subset else set(self.columns)
        named = []
        for c in self.columns:
            if c in targets:
                named.append((c, ColumnRef(c).fill_null(value)))
            else:
                named.append((c, ColumnRef(c)))
        return DataFrame(self._session, lp.Project(self._plan, named))

    def limit(self, n: int) -> "DataFrame":
        # per-partition head; actions trim the concatenation to exactly n
        return DataFrame(
            self._session, lp.GlobalLimit(lp.PartitionHead(self._plan, n), n)
        )

    def sample(self, fraction: float, seed: Optional[int] = None) -> "DataFrame":
        return DataFrame(self._session, lp.Sample(self._plan, fraction, seed))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._session, lp.Union([self._plan, other._plan]))

    unionAll = union

    def map_batches(self, fn: Callable[[pa.Table], pa.Table]) -> "DataFrame":
        """Arbitrary per-partition transform (the mapInPandas analog; fn may
        return a Table, RecordBatch, or pandas DataFrame)."""
        return DataFrame(self._session, lp.MapBatches(self._plan, fn))

    def map_in_pandas(self, fn: Callable) -> "DataFrame":
        def adapter(table: pa.Table) -> pa.Table:
            import pandas as pd

            result = fn(table.to_pandas())
            return pa.Table.from_pandas(result, preserve_index=False)

        return self.map_batches(adapter)

    def explode(self, column: str) -> "DataFrame":
        """One output row per element of a list column, other columns
        repeated (Spark ``explode`` semantics: rows with null/empty lists
        are dropped). A narrow per-partition transform — no shuffle."""

        def _explode(table: pa.Table) -> pa.Table:
            import pyarrow.compute as pc

            col = table.column(column)
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            parents = pc.list_parent_indices(col)
            flat = pc.list_flatten(col)
            arrays = []
            for name in table.column_names:
                if name == column:
                    arrays.append(flat)
                else:
                    arrays.append(pc.take(table.column(name), parents))
            return pa.Table.from_arrays(arrays, names=table.column_names)

        return self.map_batches(_explode)


    mapInPandas = map_in_pandas

    # ------------------------------------------------------------------
    # wide transformations
    # ------------------------------------------------------------------

    def repartition(self, num_partitions: int, *cols: str) -> "DataFrame":
        return DataFrame(
            self._session,
            lp.Repartition(self._plan, num_partitions, by=list(cols) or None),
        )

    def random_shuffle(self, seed: int = 0, num_partitions: Optional[int] = None) -> "DataFrame":
        n = num_partitions or self._session.default_parallelism
        return DataFrame(
            self._session, lp.Repartition(self._plan, n, shuffle_seed=seed)
        )

    def group_by(self, *cols: str) -> "GroupedData":
        return GroupedData(self, [c if isinstance(c, str) else c.name_hint() for c in cols])

    groupBy = group_by
    groupby = group_by

    def agg(self, *aggs: AggExpr) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(
        self,
        other: "DataFrame",
        on: Union[str, Sequence[str]],
        how: str = "inner",
        broadcast: Optional[str] = None,
    ) -> "DataFrame":
        """``broadcast="right"`` forces a broadcast join (no shuffle of
        either side; the right side ships whole to every left partition);
        ``broadcast="none"`` forces the hash-shuffle path; the default
        (None) lets the planner auto-broadcast a small materialized right
        side (Spark autoBroadcastJoinThreshold parity)."""
        if broadcast not in (None, "right", "none"):
            raise ValueError(
                f"broadcast must be None, 'right', or 'none', got {broadcast!r}"
            )
        keys = [on] if isinstance(on, str) else list(on)
        how = {
            "inner": "inner",
            "left": "left outer",
            "left_outer": "left outer",
            "right": "right outer",
            "right_outer": "right outer",
            "outer": "full outer",
            "full": "full outer",
            "full_outer": "full outer",
            "semi": "left semi",
            "left_semi": "left semi",
            "anti": "left anti",
            "left_anti": "left anti",
        }.get(how, how)
        return DataFrame(
            self._session,
            lp.Join(self._plan, other._plan, keys, how, broadcast=broadcast),
        )

    def sort(self, *cols, ascending: Union[bool, Sequence[bool]] = True) -> "DataFrame":
        keys = [c if isinstance(c, str) else c.name_hint() for c in cols]
        if isinstance(ascending, bool):
            asc = [ascending] * len(keys)
        else:
            asc = list(ascending)
        return DataFrame(self._session, lp.Sort(self._plan, keys, asc))

    orderBy = sort
    order_by = sort

    def distinct(self) -> "DataFrame":
        return DataFrame(self._session, lp.Distinct(self._plan))

    def drop_duplicates(self) -> "DataFrame":
        return self.distinct()

    dropDuplicates = drop_duplicates

    def random_split(
        self, weights: Sequence[float], seed: Optional[int] = None
    ) -> List["DataFrame"]:
        """Weighted row-level random split (reference raydp.utils.random_split,
        utils.py:67-83). Materializes once, splits into len(weights) frames."""
        from raydp_tpu_torch.utils import normalize_weights

        norm = normalize_weights(weights)
        planner = self._session._planner
        results = planner.execute_action(
            self._plan,
            T.OutputSpec(
                "random_split",
                num_splits=len(norm),
                weights=norm,
                seed=seed if seed is not None else 0,
                owner=planner.owner,
            ),
        )
        schema = self.schema
        out = []
        for i in range(len(norm)):
            blocks = [
                res.blocks[i]
                for res in results
                if i < len(res.blocks) and res.blocks[i] is not None
            ]
            if not blocks:
                source = lp.ArrowSource([], schema)
            else:
                source = lp.ArrowSource(blocks, schema)
            out.append(DataFrame(self._session, source))
        return out

    randomSplit = random_split

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------

    def _limit_n(self) -> Optional[int]:
        return self._plan.n if isinstance(self._plan, lp.GlobalLimit) else None

    def count(self) -> int:
        n = self._limit_n()
        results = self._session._planner.execute_action(
            self._plan, T.OutputSpec("count")
        )
        total = sum(r.count for r in results)
        return min(total, n) if n is not None else total

    def to_arrow(self) -> pa.Table:
        results = self._session._planner.execute_action(
            self._plan, T.OutputSpec("inline")
        )
        tables = [T.ipc_bytes_to_table(r.inline_ipc) for r in results if r.inline_ipc]
        if not tables:
            return self.schema.empty_table()
        merged = pa.concat_tables(tables, promote_options="permissive")
        n = self._limit_n()
        return merged.slice(0, n) if n is not None else merged

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    toPandas = to_pandas

    def collect(self) -> List[Dict[str, Any]]:
        return self.to_arrow().to_pylist()

    def take(self, n: int) -> List[Dict[str, Any]]:
        return self.limit(n).to_arrow().to_pylist()

    def first(self) -> Optional[Dict[str, Any]]:
        rows = self.take(1)
        return rows[0] if rows else None

    def head(self, n: int = 5):
        return self.take(n)

    def show(self, n: int = 20) -> None:
        # deliberate console output (Spark's DataFrame.show parity), not a
        # runtime diagnostic
        print(  # user-facing output
            self.limit(n).to_pandas().to_string()
        )

    def describe(self, *cols: str) -> "DataFrame":
        """count/mean/stddev/min/max per numeric column, one row per statistic
        with a leading ``summary`` column (Spark describe shape)."""
        import pyarrow.types as pat

        from raydp_tpu_torch.etl import functions as F

        if cols:
            unknown = [c for c in cols if c not in self.schema.names]
            if unknown:
                raise KeyError(f"describe: unknown columns {unknown}")
        numeric = [
            f.name
            for f in self.schema
            if (not cols or f.name in cols)
            and (pat.is_integer(f.type) or pat.is_floating(f.type))
        ]
        if not numeric:
            raise ValueError(
                "describe: no numeric columns"
                + (f" among {list(cols)}" if cols else f" in {self.columns}")
            )
        import pandas as pd

        # single source for the statistic rows: each entry builds its
        # aggregate AND names the partial it reads back
        stat_aggs = [
            ("count", F.count),
            ("mean", F.avg),
            ("stddev", F.stddev),
            ("min", F.min),
            ("max", F.max),
        ]
        aggs = [
            fn(c).alias(f"__{stat}_{c}")
            for c in numeric
            for stat, fn in stat_aggs
        ]
        row = self.agg(*aggs).collect()[0]
        # values are STRINGS, like Spark's describe: one pandas column holds
        # five mixed statistics, and float64 coercion would silently round
        # int64 count/min/max beyond 2^53. The label column dodges a data
        # column literally named "summary" (dict-merge would overwrite it).
        label_col = "summary"
        while label_col in numeric:
            label_col += "_"
        pdf = pd.DataFrame(
            {
                label_col: [stat for stat, _ in stat_aggs],
                **{
                    c: [
                        None
                        if row[f"__{stat}_{c}"] is None
                        else str(row[f"__{stat}_{c}"])
                        for stat, _ in stat_aggs
                    ]
                    for c in numeric
                },
            }
        )
        return self._session.from_pandas(pdf, num_partitions=1)

    def cache(self) -> "DataFrame":
        """Materialize to object-store blocks and replace the plan with the
        materialized source (Spark .cache parity; blocks die with the session
        unless ownership is transferred via the exchange layer)."""
        mat = self._session._planner.materialize(self._plan)
        self._plan = lp.ArrowSource(
            [b for b in mat.blocks if b is not None], mat.schema
        )
        self._schema = mat.schema
        return self

    persist = cache

    def materialize(self) -> Materialized:
        plan = self._plan
        mat = self._session._planner.materialize(plan)
        n = self._limit_n()
        if n is not None and mat.num_rows > n:
            # trim: cheap local fix-up pass over blocks
            kept, counts, total = [], [], 0
            for b, c in zip(mat.blocks, mat.counts):
                if total >= n or b is None:
                    continue
                if total + c <= n:
                    kept.append(b)
                    counts.append(c)
                else:
                    table = T.read_table_block(b).slice(0, n - total)
                    ref, cnt = T.write_table_block(
                        table, owner=self._session._planner.owner
                    )
                    kept.append(ref)
                    counts.append(cnt)
                total += counts[-1]
            mat = Materialized(mat.schema, kept, counts)
        return mat

    def num_partitions(self) -> int:
        return self._session._planner.partition_count(self._plan)

    def explain(self, mode: str = "text"):
        """Inspectable physical plan: how the narrow chain fuses and where
        stages break. ``mode="info"`` returns the structured dict (stage
        tree with ``narrow_ops``/``fused_ops``/``output_partitions``);
        ``"text"`` (default) prints and returns the formatted tree."""
        planner = self._session._planner
        if mode == "info":
            return planner.explain_info(self._plan)
        text = planner.format_explain(self._plan)
        print(text)  # user-facing output
        return text

    def write_parquet(self, path: str) -> int:
        results = self._session._planner.execute_action(
            self._plan, T.OutputSpec("parquet", path=path)
        )
        return sum(r.count for r in results)

    # exchange-layer hook (implemented in raydp_tpu_torch.exchange.dataset)
    def to_dataset(self, parallelism: Optional[int] = None, _use_owner: bool = False):
        from raydp_tpu_torch.exchange.dataset import dataframe_to_dataset

        return dataframe_to_dataset(self, parallelism=parallelism, _use_owner=_use_owner)


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[str]):
        self._df = df
        self._keys = keys

    def pivot(self, column: str, values: Optional[Sequence] = None) -> "PivotedData":
        """Spark ``pivot``: the subsequent ``.agg`` spreads ``column``'s
        values into output columns. ``values=None`` discovers the distinct
        values with an extra query (capped like Spark's
        spark.sql.pivotMaxValues)."""
        return PivotedData(self._df, self._keys, column, values)

    def agg(self, *aggs, **named) -> DataFrame:
        resolved: List[AggExpr] = []
        for a in aggs:
            if isinstance(a, AggExpr):
                resolved.append(a)
            elif isinstance(a, dict):
                from raydp_tpu_torch.etl import functions as F

                for col_name, agg_name in a.items():
                    resolved.append(getattr(F, agg_name)(col_name))
            else:
                raise TypeError(f"agg expects AggExpr or dict, got {type(a)}")
        from raydp_tpu_torch.etl import functions as F

        for out_name, spec in named.items():
            if isinstance(spec, AggExpr):
                resolved.append(spec.alias(out_name))
            else:
                agg_name, col_name = spec
                resolved.append(getattr(F, agg_name)(col_name).alias(out_name))
        return DataFrame(
            self._df._session, lp.GroupByAgg(self._df._plan, self._keys, resolved)
        )

    def count(self) -> DataFrame:
        from raydp_tpu_torch.etl import functions as F

        return self.agg(F.count("*"))

    def sum(self, *cols: str) -> DataFrame:  # noqa: A003
        from raydp_tpu_torch.etl import functions as F

        return self.agg(*[F.sum(c) for c in cols])

    def avg(self, *cols: str) -> DataFrame:
        from raydp_tpu_torch.etl import functions as F

        return self.agg(*[F.avg(c) for c in cols])

    mean = avg

    def min(self, *cols: str) -> DataFrame:  # noqa: A003
        from raydp_tpu_torch.etl import functions as F

        return self.agg(*[F.min(c) for c in cols])

    def max(self, *cols: str) -> DataFrame:  # noqa: A003
        from raydp_tpu_torch.etl import functions as F

        return self.agg(*[F.max(c) for c in cols])


class PivotedData:
    """group_by(keys).pivot(col).agg(...) — Spark pivot semantics: the
    aggregation runs DISTRIBUTED over (keys + pivot column), and only the
    already-aggregated result (#key-combos × #pivot-values rows) is
    reshaped wide on the driver, exactly the size Spark's own pivot
    collects into its literal column list."""

    MAX_VALUES = 10_000  # parity: spark.sql.pivotMaxValues default

    def __init__(self, df: DataFrame, keys: List[str], column: str,
                 values: Optional[Sequence]):
        self._df = df
        self._keys = keys
        self._column = column
        self._values = list(values) if values is not None else None

    def agg(self, *aggs, **named) -> DataFrame:
        import pandas as pd

        values = self._values
        if values is None:
            distinct = (
                self._df.select(self._column).distinct().collect()
            )
            values = sorted(
                (r[self._column] for r in distinct),
                key=lambda v: (v is None, str(v)),
            )
            if len(values) > self.MAX_VALUES:
                raise ValueError(
                    f"pivot column {self._column!r} has {len(values)} "
                    f"distinct values (cap {self.MAX_VALUES}); pass an "
                    "explicit values=[...] list"
                )
        inner = GroupedData(self._df, self._keys + [self._column]).agg(
            *aggs, **named
        )
        pdf = inner.to_pandas()
        agg_cols = [c for c in pdf.columns if c not in self._keys + [self._column]]
        single = len(agg_cols) == 1

        # wide frame built BY HAND (not pivot_table): explicit values with
        # no matching rows become all-null columns instead of disappearing,
        # null pivot values become a "null" column (Spark naming), and the
        # keyless (global pivot) case yields one row
        def _colname(v, a):
            base = "null" if v is None else str(v)
            return base if single else f"{base}_{a}"

        if self._keys:
            wide = pdf[self._keys].drop_duplicates().reset_index(drop=True)
        else:
            wide = pd.DataFrame(index=[0])
        for v in values:
            mask = (
                pdf[self._column].isna()
                if v is None
                else pdf[self._column] == v
            )
            sub = pdf[mask]
            if self._keys:
                # pandas merge matches null keys to null keys, so null-key
                # GROUPS survive the reshape too
                merged = wide[self._keys].merge(
                    sub[self._keys + agg_cols], on=self._keys, how="left"
                )
                for a in agg_cols:
                    wide[_colname(v, a)] = merged[a].to_numpy()
            else:
                for a in agg_cols:
                    wide[_colname(v, a)] = (
                        [sub[a].iloc[0]] if len(sub) else [None]
                    )
        return self._df._session.from_pandas(wide, num_partitions=1)
