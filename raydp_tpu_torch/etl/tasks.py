"""Physical tasks of the ETL engine.

A ``TaskSpec`` is one unit of work an executor actor runs: read inputs
(object-store blocks, parquet/csv file groups, or a range), optionally merge
them (shuffle-reduce: final aggregation / join / sort), apply a fused chain of
narrow ops, and emit output (a sealed Arrow block, hash/range/random splits for
the next shuffle, a sample of sort keys, or inline rows back to the driver).

This file is pure functions over ``pyarrow.Table`` plus the picklable specs —
it runs identically on the driver (local fallback) and inside executors. It
plays the role of the reference's JVM partition loop (Spark task execution
inside RayDPExecutor actors + ObjectStoreWriter's per-partition Arrow
serialization, reference ObjectStoreWriter.scala:99-171) in Arrow-native form.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from raydp_tpu_torch.etl import plan as lp
from raydp_tpu_torch.etl.expressions import AggExpr, _AGG_PHASES, _as_array
from raydp_tpu_torch.store import object_store as store

# ---------------------------------------------------------------------------
# Arrow kernel threading
# ---------------------------------------------------------------------------

# pyarrow's group_by/join kernels can fan out over arrow's internal thread
# pool. Default OFF: executors are sized by their CPU resource (often 1-2
# cores, like the CI box) and arrow's pool would oversubscribe the host.
# Multi-core deployments opt in via the ``planner.arrow_threads`` session
# conf (plumbed here by EtlSession/EtlExecutor).
_ARROW_THREADS = False


def set_arrow_threads(enabled: bool) -> None:
    """Process-wide toggle for arrow kernel threading on the group_by/join
    hot paths (the ``planner.arrow_threads`` session conf lands here, on the
    driver AND in every executor)."""
    global _ARROW_THREADS
    _ARROW_THREADS = bool(enabled)


def arrow_threads() -> bool:
    return _ARROW_THREADS


# ---------------------------------------------------------------------------
# Block IO helpers
# ---------------------------------------------------------------------------

DEFAULT_MAX_RECORDS_PER_BATCH = 1 << 15


def write_table_block(
    table: pa.Table,
    owner: Optional[str] = None,
    max_records: int = DEFAULT_MAX_RECORDS_PER_BATCH,
    storage: str = "auto",
) -> Tuple[store.ObjectRef, int]:
    """Serialize a Table as an Arrow IPC stream straight into a shared-memory
    block (no staging copy on the happy path; spills to disk when shm is
    full, or always with storage="disk"). Returns (ref, num_rows)."""
    table = table.combine_chunks()
    capacity = int(table.nbytes) + (1 << 16) + 512 * max(1, table.num_columns)
    block = store.create_block(capacity, storage=storage)
    try:
        sink = block.arrow_sink()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table, max_chunksize=max_records)
        written = sink.tell()
        sink.close()
        ref = block.seal(written, owner=owner)
        return ref, table.num_rows
    except Exception:
        block.abort()
        # conservative fallback: serialize to memory, then one copy into the
        # store — FORWARDING the tier request (a DISK_ONLY write must not
        # silently land in shm because the capacity estimate was short)
        out = pa.BufferOutputStream()
        with pa.ipc.new_stream(out, table.schema) as writer:
            writer.write_table(table, max_chunksize=max_records)
        ref = store.put(out.getvalue(), owner=owner, storage=storage)
        return ref, table.num_rows


def read_table_block(ref: store.ObjectRef) -> pa.Table:
    """Zero-copy read of an Arrow-IPC block back into a Table."""
    schema, batches = store.read_arrow_batches(ref)
    return pa.Table.from_batches(batches, schema=schema)


def read_table_block_slice(
    ref: store.ObjectRef, offset: int, length: int, meta: Optional[dict] = None
) -> pa.Table:
    """Read ONE split of an indexed shuffle block: the ``[offset,
    offset+length)`` range is a self-contained Arrow IPC stream (see
    ``write_indexed_splits``). Local blocks stay zero-copy (the slice is a
    window over the shm/spill mapping); remote blocks pull only the slice."""
    schema, batches = store.read_arrow_batches(ref, offset, length, meta=meta)
    return pa.Table.from_batches(batches, schema=schema)


def decode_segment(
    ref: store.ObjectRef,
    start: int,
    stop: int,
    feature_groups,
    label_column: Optional[str],
    label_dtype,
):
    """Streaming-ingest decode, run EXECUTOR-side: Arrow block (row span
    ``[start, stop)``) → one numpy matrix per ``(columns, dtype)`` feature
    group + the label vector. This is the per-segment CPU work (column
    stacking, dtype casts, null checks) the training driver's consumer
    thread used to pay inline; as an executor task it runs where the block
    lives (shm-local read) and the driver only sequences uploads. Returns
    ``(parts, labels)`` — ``None`` when the span is empty."""
    # lazy: exchange imports tasks at module load; the converter is the ONE
    # implementation both driver- and executor-side decode share
    from raydp_tpu_torch.exchange.dataset import _table_to_numpy_grouped

    table = read_table_block(ref)
    if start != 0 or stop != table.num_rows:
        table = table.slice(start, stop - start)
    if table.num_rows == 0:
        return None
    feats, labels = _table_to_numpy_grouped(
        table, feature_groups, label_column, label_dtype
    )
    return list(feats), labels


# Indexed shuffle block layout (one object per MAP TASK, not per split):
#
#   [split 0 IPC stream][split 1 IPC stream]...[split R-1 IPC stream]
#   [footer: R × (u64 offset, u64 length)] [u32 R] [8-byte magic]
#
# Empty splits occupy zero bytes (their footer entry is (0, 0)). Each split
# is a COMPLETE Arrow IPC stream (schema + batches + EOS), so any reducer
# can decode its range with a plain stream reader. The footer makes the
# block self-describing (``read_split_index``); the fast path never touches
# it — the producing TaskResult carries the same offsets inline.
SPLIT_INDEX_MAGIC = b"RTPUIDX1"
_FOOTER_ENTRY = struct.Struct("<QQ")
_FOOTER_TAIL = struct.Struct("<I8s")


def write_indexed_splits(
    splits: Sequence[pa.Table],
    owner: Optional[str] = None,
    max_records: int = DEFAULT_MAX_RECORDS_PER_BATCH,
    storage: str = "auto",
) -> Tuple[Optional[store.ObjectRef], List[Optional[Tuple[int, int]]], List[int]]:
    """Write ALL of a map task's R shuffle splits as ONE object-store block
    (concatenated IPC streams + offset-index footer) — M blocks per shuffle
    instead of M×R, and one metadata registration instead of R. Returns
    ``(ref, slices, counts)`` where ``slices[r]`` is the ``(offset, length)``
    window reducer r range-reads, or None for an empty split; ``ref`` is
    None when every split is empty."""
    tables = [t.combine_chunks() if t.num_rows else t for t in splits]
    if not any(t.num_rows for t in tables):
        return None, [None] * len(tables), [0] * len(tables)

    def _write_splits_to(sink):
        """The ONE serializer of the block layout (both tiers write through
        it — a layout change can't silently diverge between the shm path
        and the memory-buffer fallback). Returns (slices, counts)."""
        slices: List[Optional[Tuple[int, int]]] = []
        counts: List[int] = []
        for t in tables:
            if t.num_rows == 0:
                slices.append(None)
                counts.append(0)
                continue
            start = sink.tell()
            with pa.ipc.new_stream(sink, t.schema) as writer:
                writer.write_table(t, max_chunksize=max_records)
            slices.append((start, sink.tell() - start))
            counts.append(t.num_rows)
        for s in slices:
            sink.write(_FOOTER_ENTRY.pack(*(s or (0, 0))))
        sink.write(_FOOTER_TAIL.pack(len(tables), SPLIT_INDEX_MAGIC))
        return slices, counts

    capacity = sum(
        int(t.nbytes) + (1 << 16) + 512 * max(1, t.num_columns)
        for t in tables
        if t.num_rows
    ) + _FOOTER_ENTRY.size * len(tables) + _FOOTER_TAIL.size
    block = store.create_block(capacity, storage=storage)
    try:
        sink = block.arrow_sink()
        slices, counts = _write_splits_to(sink)
        written = sink.tell()
        sink.close()
        ref = block.seal(written, owner=owner)
        return ref, slices, counts
    except Exception:
        block.abort()
        # conservative fallback (capacity estimate short / shm pressure):
        # serialize to memory, then one put of the identical layout
        out = pa.BufferOutputStream()
        slices, counts = _write_splits_to(out)
        ref = store.put(out.getvalue(), owner=owner, storage=storage)
        return ref, slices, counts


def read_split_index(ref: store.ObjectRef) -> List[Optional[Tuple[int, int]]]:
    """Decode an indexed shuffle block's footer into the per-split
    ``(offset, length)`` windows (None for empty splits) — the
    self-describing path for consumers that only hold the ref."""
    size = ref.size
    tail = store.get_arrow_buffer(
        ref, size - _FOOTER_TAIL.size, _FOOTER_TAIL.size
    )
    num_splits, magic = _FOOTER_TAIL.unpack(tail.to_pybytes())
    if magic != SPLIT_INDEX_MAGIC:
        raise ValueError(f"object {ref.object_id} is not an indexed shuffle block")
    footer_len = _FOOTER_ENTRY.size * num_splits
    entries = store.get_arrow_buffer(
        ref, size - _FOOTER_TAIL.size - footer_len, footer_len
    ).to_pybytes()
    out: List[Optional[Tuple[int, int]]] = []
    for i in range(num_splits):
        offset, length = _FOOTER_ENTRY.unpack_from(entries, i * _FOOTER_ENTRY.size)
        out.append((offset, length) if length else None)
    return out


def table_to_ipc_bytes(table: pa.Table) -> bytes:
    out = pa.BufferOutputStream()
    with pa.ipc.new_stream(out, table.schema) as writer:
        writer.write_table(table)
    return out.getvalue().to_pybytes()


def ipc_bytes_to_table(data: bytes) -> pa.Table:
    with pa.ipc.open_stream(pa.py_buffer(data)) as reader:
        return reader.read_all()


# ---------------------------------------------------------------------------
# Task specification
# ---------------------------------------------------------------------------


@dataclass
class ReadSpec:
    """One input of a task."""

    kind: str  # "block" | "parquet" | "csv" | "range" | "inline"
    blocks: List[store.ObjectRef] = field(default_factory=list)
    files: List[str] = field(default_factory=list)
    columns: Optional[List[str]] = None
    range_args: Optional[Tuple[int, int, int]] = None  # start, end, step
    inline_ipc: Optional[bytes] = None
    csv_options: Dict[str, Any] = field(default_factory=dict)
    schema_ipc: Optional[bytes] = None  # schema to use when inputs are empty
    # indexed-shuffle inputs: (ref, offset, length) windows range-read out
    # of map tasks' single-block outputs (write_indexed_splits); readable
    # alongside ``blocks`` (legacy whole-block inputs)
    slices: List[Tuple[store.ObjectRef, int, int]] = field(default_factory=list)
    # head-bypass: lease-stamped location records for this read's blocks,
    # pushed by the dispatching driver ({object_id: (meta, age_s)}) — the
    # executor seeds its location cache from these, so resolving sibling
    # map outputs costs ZERO head RPCs on the warm path (store.lookup_many
    # falls back to the head only for entries absent or past their lease)
    metas: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MergeSpec:
    """Shuffle-reduce step applied to the concatenated input."""

    kind: str  # "none" | "final_agg" | "join" | "sort" | "distinct"
    keys: List[str] = field(default_factory=list)
    aggs: List[AggExpr] = field(default_factory=list)
    right: Optional[ReadSpec] = None
    join_how: str = "inner"
    ascending: List[bool] = field(default_factory=list)


@dataclass
class OutputSpec:
    kind: str  # "block" | "hash_split" | "range_split" | "random_split" | "inline" | "count" | "sample"
    num_splits: int = 1
    keys: List[str] = field(default_factory=list)
    boundaries_ipc: Optional[bytes] = None  # for range_split: single-col table per key
    ascending: List[bool] = field(default_factory=list)
    seed: Optional[int] = None
    weights: Optional[List[float]] = None  # random_split probabilities
    sample_limit: int = 1000
    path: Optional[str] = None  # parquet output directory
    owner: Optional[str] = None  # ownership target for produced blocks
    max_records: int = DEFAULT_MAX_RECORDS_PER_BATCH
    storage: str = "auto"  # block tier: "auto" | "shm" | "disk" (spill)
    # *_split outputs: write ONE indexed block holding all splits (M blocks
    # per shuffle instead of M×R) — the planner turns this on; the spec-level
    # default keeps direct task construction on the legacy per-split layout
    indexed_splits: bool = False


@dataclass
class TaskSpec:
    reads: List[ReadSpec]
    chain: List[lp.PlanNode] = field(default_factory=list)  # childless narrow nodes
    merge: MergeSpec = field(default_factory=lambda: MergeSpec("none"))
    output: OutputSpec = field(default_factory=lambda: OutputSpec("block"))
    partition_index: int = 0


@dataclass
class TaskResult:
    """blocks[i] is the output for reducer i (block/…_split) or the single
    output (block). ``None`` marks an empty split the reducer may skip.
    Indexed split outputs instead carry ONE block plus ``split_slices``:
    ``split_slices[r]`` is reducer r's ``(offset, length)`` window into
    ``blocks[0]`` (None = empty split)."""

    blocks: List[Optional[store.ObjectRef]] = field(default_factory=list)
    num_rows: List[int] = field(default_factory=list)
    split_slices: Optional[List[Optional[Tuple[int, int]]]] = None
    # location records for the produced blocks, parallel to ``blocks`` —
    # the WRITER knows where its output lives, so downstream reads (reduce
    # tasks, driver-side slicing) can resolve them head-bypass
    block_metas: Optional[List[Optional[Any]]] = None
    inline_ipc: Optional[bytes] = None
    count: int = 0
    # server-side wall time of the task body (read→compute→emit), for query
    # stats: lets the driver tell executor compute from dispatch/transport
    server_seconds: float = 0.0
    # per-phase breakdown of server_seconds (read+merge / narrow chain /
    # output emit) — aggregated per stage into last_query_stats so ETL
    # regressions are attributable to a layer, not just a total
    read_seconds: float = 0.0
    compute_seconds: float = 0.0
    emit_seconds: float = 0.0


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _read_one(read: ReadSpec) -> pa.Table:
    if read.kind == "block":
        if read.metas:
            # adopt the dispatcher's lease-stamped locations BEFORE any
            # lookup: warm reads resolve peer blocks without the head
            store.seed_locations(read.metas)
        tables = [read_table_block(r) for r in read.blocks if r is not None]
        if read.slices:
            # one vectorized metadata lookup for every input slice's block,
            # then a range read per slice (local: zero-copy window; remote:
            # only the slice's bytes cross the wire)
            from raydp_tpu_torch.obs import metrics

            metas = store.lookup_many([r for r, _, _ in read.slices])
            metrics.counter("etl.shuffle.slice_fetches").inc(len(read.slices))
            tables.extend(
                read_table_block_slice(r, off, ln, meta=metas[r.object_id])
                for r, off, ln in read.slices
            )
        tables = [t for t in tables if t.num_rows > 0] or tables[:1]
        if not tables:
            if read.schema_ipc is not None:
                return _empty_table(read.schema_ipc)
            raise ValueError("block read with no blocks and no schema")
        return pa.concat_tables(tables, promote_options="permissive")
    if read.kind == "parquet":
        import pyarrow.parquet as pq

        tables = [pq.read_table(f, columns=read.columns) for f in read.files]
        return pa.concat_tables(tables, promote_options="permissive")
    if read.kind == "csv":
        from pyarrow import csv as pacsv

        opts = dict(read.csv_options)
        convert = pacsv.ConvertOptions(
            column_types=opts.get("column_types"),
        )
        read_opts = pacsv.ReadOptions(
            column_names=opts.get("column_names"),
            autogenerate_column_names=opts.get("autogenerate_column_names", False),
        )
        parse = pacsv.ParseOptions(delimiter=opts.get("delimiter", ","))
        tables = [
            pacsv.read_csv(
                f, read_options=read_opts, parse_options=parse, convert_options=convert
            )
            for f in read.files
        ]
        return pa.concat_tables(tables, promote_options="permissive")
    if read.kind == "range":
        start, end, step = read.range_args
        return pa.table({"id": pa.array(np.arange(start, end, step, dtype=np.int64))})
    if read.kind == "inline":
        return ipc_bytes_to_table(read.inline_ipc)
    raise ValueError(f"unknown read kind {read.kind!r}")


def _empty_table(schema_ipc: bytes) -> pa.Table:
    schema = pa.ipc.read_schema(pa.py_buffer(schema_ipc))
    return schema.empty_table()


def schema_ipc_bytes(schema: pa.Schema) -> bytes:
    return schema.serialize().to_pybytes()


def build_shuffle_reads(
    map_results: Sequence[Optional["TaskResult"]],
    num_reducers: int,
    schema_ipc: bytes,
) -> List["ReadSpec"]:
    """Transpose map-side outputs into per-reducer ReadSpecs — the ONE
    implementation shared by the driver planner, the barrier-free reduce
    launcher, and the executor-side fused map→reduce dispatch. Handles both
    layouts: indexed single-block outputs (``split_slices`` windows) and
    legacy per-split blocks. Map order is preserved (reducer input
    concatenation order is part of the engine's determinism contract —
    first/last aggregates depend on it)."""
    reads: List[ReadSpec] = []

    def _meta_of(res: "TaskResult", idx: int):
        if res.block_metas is not None and idx < len(res.block_metas):
            return res.block_metas[idx]
        return None

    for r in range(num_reducers):
        blocks: List[store.ObjectRef] = []
        slices: List[Tuple[store.ObjectRef, int, int]] = []
        metas: Dict[str, Any] = {}
        for res in map_results:
            if res is None:
                continue
            if res.split_slices is not None:
                ref = res.blocks[0] if res.blocks else None
                s = (
                    res.split_slices[r]
                    if r < len(res.split_slices)
                    else None
                )
                if ref is not None and s is not None:
                    slices.append((ref, s[0], s[1]))
                    meta = _meta_of(res, 0)
                    if meta is not None:
                        metas[ref.object_id] = meta
            elif r < len(res.blocks) and res.blocks[r] is not None:
                blocks.append(res.blocks[r])
                meta = _meta_of(res, r)
                if meta is not None:
                    metas[res.blocks[r].object_id] = meta
        reads.append(
            ReadSpec(
                "block", blocks=blocks, slices=slices,
                schema_ipc=schema_ipc, metas=metas,
            )
        )
    return reads


# ---------------------------------------------------------------------------
# Narrow chain application
# ---------------------------------------------------------------------------


def apply_narrow(table: pa.Table, node: lp.PlanNode, partition_index: int) -> pa.Table:
    if isinstance(node, lp.Project):
        from raydp_tpu_torch.etl.expressions import shared_eval_cache

        arrays, names = [], []
        n = table.num_rows
        # the memo scope makes fused projections evaluate each shared
        # subexpression (a column consumed by several later formulas) once
        with shared_eval_cache():
            for name, expr in node.columns:
                value = expr.evaluate(table)
                arrays.append(_as_array(value, n))
                names.append(name)
        return pa.Table.from_arrays(arrays, names=names)
    if isinstance(node, lp.Filter):
        mask = node.predicate.evaluate(table)
        if isinstance(mask, pa.Scalar):
            return table if mask.as_py() else table.slice(0, 0)
        return table.filter(mask)
    if isinstance(node, lp.MapBatches):
        result = node.fn(table)
        if isinstance(result, pa.RecordBatch):
            result = pa.Table.from_batches([result])
        elif not isinstance(result, pa.Table):
            import pandas as pd

            if isinstance(result, pd.DataFrame):
                result = pa.Table.from_pandas(result, preserve_index=False)
            else:
                raise TypeError(
                    f"map_batches fn must return Table/RecordBatch/DataFrame, got {type(result)}"
                )
        return result
    if isinstance(node, lp.Sample):
        rng = np.random.default_rng(
            None if node.seed is None else node.seed + partition_index
        )
        mask = rng.random(table.num_rows) < node.fraction
        return table.filter(pa.array(mask))
    if isinstance(node, lp.PartitionHead):
        return table.slice(0, node.n)
    raise TypeError(f"not a narrow node: {type(node).__name__}")


# ---------------------------------------------------------------------------
# Window functions
# ---------------------------------------------------------------------------


def window_compute(
    table: pa.Table,
    partition_by: Sequence[str],
    order_by: Sequence[str],
    ascending: Sequence[bool],
    exprs: Sequence[Tuple[str, Any]],
) -> pa.Table:
    """Append window columns to one reducer's rows. Every partition-key group
    is whole here (the planner hash-shuffles on partition_by first), so the
    computation is local: sort by (partition, order) keys, find group/run
    boundaries vectorized, and emit each window function from them. Output
    rows are ordered by (partition_by, order_by) — Spark makes the same
    within-partition ordering guarantee and no global one."""
    n = table.num_rows
    sort_spec = [(k, "ascending") for k in partition_by] + [
        (k, "ascending" if asc else "descending")
        for k, asc in zip(order_by, ascending)
    ]
    if n and sort_spec:
        table = table.sort_by(sort_spec)

    def np_col(name):
        return table.column(name).to_numpy(zero_copy_only=False)

    def key_codes(name):
        """Equality-preserving int codes for a key column. Dictionary
        encoding makes nulls (→ -1) and NaNs compare equal to themselves —
        a raw numpy != would make every null row its own group (NaN != NaN)."""
        enc = table.column(name).combine_chunks().dictionary_encode()
        return (
            enc.indices.fill_null(-1)
            .to_numpy(zero_copy_only=False)
            .astype(np.int64)
        )

    part_change = np.zeros(n, bool)
    run_change = np.zeros(n, bool)
    if n:
        part_change[0] = run_change[0] = True
        for k in partition_by:
            a = key_codes(k)
            part_change[1:] |= a[1:] != a[:-1]
        run_change |= part_change
        for k in order_by:
            a = key_codes(k)
            run_change[1:] |= a[1:] != a[:-1]
    gstart_idx = np.flatnonzero(part_change)  # [num_groups]
    gid = np.cumsum(part_change) - 1  # group id per row
    group_start = gstart_idx[gid] if n else np.zeros(0, np.int64)
    glen = np.diff(np.append(gstart_idx, n))
    group_end = (gstart_idx + glen)[gid] if n else np.zeros(0, np.int64)
    rstart_idx = np.flatnonzero(run_change)  # tie runs (rank/dense_rank)
    rid = np.cumsum(run_change) - 1
    run_first = rstart_idx[rid] if n else np.zeros(0, np.int64)
    rid_at_gstart = rid[group_start] if n else np.zeros(0, np.int64)
    idx = np.arange(n)

    out = table
    for name, e in exprs:
        if e.kind == "row_number":
            vals = pa.array((idx - group_start + 1).astype(np.int64))
        elif e.kind == "rank":
            vals = pa.array((run_first - group_start + 1).astype(np.int64))
        elif e.kind == "dense_rank":
            vals = pa.array((rid - rid_at_gstart + 1).astype(np.int64))
        elif e.kind in ("lag", "lead"):
            colv = table.column(e.column).combine_chunks()
            if e.kind == "lag":
                src = idx - e.offset
                valid = src >= group_start
            else:
                src = idx + e.offset
                valid = src < group_end
            taken = colv.take(
                pa.array(np.clip(src, 0, max(n - 1, 0)).astype(np.int64))
            )
            fill = pa.scalar(e.default, colv.type)
            vals = pc.if_else(pa.array(valid), taken, fill)
        elif e.kind == "cum_sum":
            # Spark sum().over() ignores nulls (a null row gets the running
            # sum of prior non-nulls; rows before the first non-null get
            # null) — a naive cumsum would NaN-poison every later row AND
            # every later group on the same reducer via the base subtraction
            colv = table.column(e.column).combine_chunks()
            null_mask = np.asarray(colv.is_null())
            # float64 ALWAYS: a nullable int column becomes float64 on
            # reducers that hold a null but int64 on ones that don't,
            # which would give output partitions divergent schemas
            a = np_col(e.column).astype(np.float64)
            filled = np.where(null_mask, 0.0, a)
            cs = np.cumsum(filled)
            valid = np.cumsum(~null_mask)
            if n:
                run = cs - (cs[group_start] - filled[group_start])
                seen = valid - (valid[group_start] - (~null_mask)[group_start])
                vals = pa.array(run, mask=seen == 0)
            else:
                vals = pa.array(cs)
        else:
            raise TypeError(f"unsupported window function {e.kind!r}")
        out = out.append_column(name, vals)
    return out


class WindowApply:
    """Picklable reduce-side closure applying one Window node's functions."""

    def __init__(self, partition_by, order_by, ascending, exprs):
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.ascending = list(ascending)
        self.exprs = list(exprs)

    def __call__(self, table: pa.Table) -> pa.Table:
        return window_compute(
            table, self.partition_by, self.order_by, self.ascending, self.exprs
        )


# ---------------------------------------------------------------------------
# Aggregation (two-phase)
# ---------------------------------------------------------------------------


def _is_moment_agg(agg: str) -> bool:
    return agg in ("var_samp", "var_pop", "stddev_samp", "stddev_pop")


def _expand_phases(aggs: Sequence[AggExpr]) -> List[Tuple[str, str, str]]:
    """(input_col, map_agg, partial_name) triples; mean → sum + count parts;
    var/stddev → sum + M2 + count, where M2 = n·var_pop is each partition's
    centered second moment (computed by arrow's own stable variance kernel —
    the naive Σx² − (Σx)²/n identity catastrophically cancels for
    large-mean/small-variance data). Partials merge Chan-style in
    final_agg: ΣM2 plus a between-partials correction."""
    out = []
    for i, a in enumerate(aggs):
        if a.agg == "mean":
            out.append((a.column, "sum", f"__p{i}_sum"))
            out.append((a.column, "count", f"__p{i}_cnt"))
        elif _is_moment_agg(a.agg):
            out.append((a.column, "sum", f"__p{i}_sum"))
            out.append((a.column, "m2", f"__p{i}_m2"))
            out.append((a.column, "count", f"__p{i}_cnt"))
        else:
            out.append((a.column, _AGG_PHASES[a.agg][0], f"__p{i}"))
    return out


def _grouped_positional(grouped: pa.Table, keys: List[str], agg_names: List[str]) -> pa.Table:
    """Normalize a group_by().aggregate() result to [keys..., agg_names...]:
    agg columns are positional (spec order); keys sit first or last depending
    on the arrow version."""
    names = grouped.column_names
    if names[: len(keys)] == keys:
        key_idx = list(range(len(keys)))
        agg_idx = list(range(len(keys), len(names)))
    else:
        agg_idx = list(range(len(names) - len(keys)))
        key_idx = list(range(len(names) - len(keys), len(names)))
    cols = [grouped.column(i) for i in key_idx] + [grouped.column(i) for i in agg_idx]
    return pa.Table.from_arrays(cols, names=keys + agg_names)


def partial_agg(table: pa.Table, keys: List[str], aggs: Sequence[AggExpr]) -> pa.Table:
    phases = _expand_phases(aggs)
    if keys:
        specs = []
        for col_name, map_agg, pname in phases:
            if col_name == "*":
                specs.append(([], "count_all"))
            elif map_agg == "m2":
                # per-group population variance (arrow's numerically stable
                # kernel); scaled to M2 = n·var below
                specs.append((col_name, "variance", pc.VarianceOptions(ddof=0)))
            else:
                specs.append((col_name, map_agg))
        grouped = table.group_by(keys, use_threads=arrow_threads()).aggregate(specs)
        result = _grouped_positional(grouped, keys, [p for _, _, p in phases])
        for i, a in enumerate(aggs):
            if _is_moment_agg(a.agg):
                m2 = pc.multiply(
                    pc.cast(result.column(f"__p{i}_m2"), pa.float64()),
                    pc.cast(result.column(f"__p{i}_cnt"), pa.float64()),
                )
                result = result.set_column(
                    result.column_names.index(f"__p{i}_m2"), f"__p{i}_m2", m2
                )
        return result
    # global aggregation: single partial row
    arrays, names = [], []
    for col_name, map_agg, pname in phases:
        if col_name == "*":
            value = pa.scalar(table.num_rows, pa.int64())
        else:
            column = table.column(col_name)
            if map_agg == "count":
                value = pa.scalar(len(column) - column.null_count, pa.int64())
            elif map_agg == "m2":
                n = len(column) - column.null_count
                var = pc.variance(column, ddof=0).as_py() if n else None
                value = pa.scalar(
                    var * n if var is not None else None, pa.float64()
                )
            elif map_agg == "first":
                value = column[0] if len(column) else pa.scalar(None, column.type)
            elif map_agg == "last":
                value = column[-1] if len(column) else pa.scalar(None, column.type)
            else:
                value = getattr(pc, map_agg)(column)
        arrays.append(pa.array([value.as_py()], type=value.type))
        names.append(pname)
    return pa.Table.from_arrays(arrays, names=names)


# shared sentinel standing in for float NaN inside group-key tuples (NaN is
# unusable as a dict key: distinct NaN objects hash by id and compare unequal)
_NAN_KEY = object()


def _moment_between_terms(
    partials: pa.Table, merged: pa.Table, keys: List[str],
    aggs: Sequence[AggExpr],
) -> Dict[int, List[float]]:
    """Per-merged-row between-partials term Σ n_i·(mean_i − mean̄)² for each
    moment aggregate. Mean DELTAS keep this numerically safe where
    Σ(sum_i²/n_i) − (Σsum)²/N destroys all significant digits (the deltas
    are on the spread-of-means scale, not the squared-raw-sum scale). The
    grouping runs over PARTIAL rows (#partitions × #groups, not data rows)
    with tuple keys, so null-key groups — which an arrow join would drop —
    merge correctly."""
    moment_idx = [i for i, a in enumerate(aggs) if _is_moment_agg(a.agg)]
    if not moment_idx:
        return {}

    def _key_rows(table: pa.Table):
        if not keys:
            return [()] * table.num_rows
        cols = [table.column(k).to_pylist() for k in keys]
        # Canonicalize float NaN: Python hashes each NaN object by identity
        # (and NaN != NaN), so tuple keys containing NaN from two to_pylist()
        # calls would never match in the dict below even though arrow's
        # group_by merged them into one group.
        return [
            tuple(_NAN_KEY if isinstance(v, float) and v != v else v for v in row)
            for row in (zip(*cols) if table.num_rows else [])
        ]

    merged_pos = {t: j for j, t in enumerate(_key_rows(merged))}
    partial_keys = _key_rows(partials)
    out: Dict[int, List[float]] = {}
    for i in moment_idx:
        sums = partials.column(f"__p{i}_sum").to_pylist()
        cnts = partials.column(f"__p{i}_cnt").to_pylist()
        g_sums = merged.column(f"__p{i}_sum").to_pylist()
        g_cnts = merged.column(f"__p{i}_cnt").to_pylist()
        between = [0.0] * merged.num_rows
        for row, key in enumerate(partial_keys):
            n_i = cnts[row]
            if not n_i or sums[row] is None:
                continue
            j = merged_pos[key]
            if not g_cnts[j] or g_sums[j] is None:
                continue
            delta = sums[row] / n_i - g_sums[j] / g_cnts[j]
            between[j] += n_i * delta * delta
        out[i] = between
    return out


def final_agg(partials: pa.Table, keys: List[str], aggs: Sequence[AggExpr]) -> pa.Table:
    """Merge partial rows: re-aggregate with each aggregate's merge function.
    Moment (var/stddev) partials merge Chan-style: the total M2 is
    ΣM2_i plus the between-partials term Σ(sum_i²/n_i) − (Σsum)²/N, which
    only cancels between PARTIAL MEANS (similar magnitudes) — not between
    raw sums of squares."""
    phases = _expand_phases(aggs)
    if keys:
        merge_specs = [
            (pname, merge_fn)
            for (_, _, pname), merge_fn in zip(phases, _merge_fns(aggs))
        ]
        merged = partials.group_by(keys, use_threads=arrow_threads()).aggregate(merge_specs)
        merged = _grouped_positional(merged, keys, [p for _, _, p in phases])
    else:
        arrays, names = [], []
        for (col_name, map_agg, pname), merge_fn in zip(phases, _merge_fns(aggs)):
            column = partials.column(pname)
            if merge_fn == "first":
                value = column[0] if len(column) else pa.scalar(None, column.type)
            else:
                value = getattr(pc, merge_fn)(column)
            arrays.append(pa.array([value.as_py()], type=value.type))
            names.append(pname)
        merged = pa.Table.from_arrays(arrays, names=names)
    between = _moment_between_terms(partials, merged, keys, aggs)
    # finalize: mean = sum/cnt; var/stddev from the moment identity;
    # rename partials to out names
    out_arrays = [merged.column(k) for k in keys]
    out_names = list(keys)
    for i, a in enumerate(aggs):
        if a.agg == "mean":
            total = merged.column(f"__p{i}_sum")
            cnt = pc.cast(merged.column(f"__p{i}_cnt"), pa.float64())
            out_arrays.append(pc.divide(pc.cast(total, pa.float64()), cnt))
        elif _is_moment_agg(a.agg):
            m2_within = pc.cast(merged.column(f"__p{i}_m2"), pa.float64())
            cnt = pc.cast(merged.column(f"__p{i}_cnt"), pa.float64())
            # Chan merge: M2 = ΣM2_i + Σ n_i·(mean_i − mean̄)², with the
            # between term computed from MEAN DELTAS per partial row
            # (_moment_between_terms) — squared raw sums would cancel
            # catastrophically for large-mean/small-variance data
            m2 = pc.add(m2_within, pa.array(between[i], pa.float64()))
            if a.agg.endswith("_samp"):
                # Bessel correction; n < 2 → null (Spark stddev/var default)
                denom = pc.subtract(cnt, pa.scalar(1.0, pa.float64()))
                denom = pc.if_else(
                    pc.greater(denom, 0.0), denom, pa.scalar(None, pa.float64())
                )
            else:
                denom = cnt
            var = pc.divide(m2, denom)
            out_arrays.append(
                pc.sqrt(var) if a.agg.startswith("stddev") else var
            )
        elif a.agg == "count":
            # count over zero partials must be 0, not null (sum of empty = null)
            out_arrays.append(
                pc.coalesce(merged.column(f"__p{i}"), pa.scalar(0, pa.int64()))
            )
        else:
            out_arrays.append(merged.column(f"__p{i}"))
        out_names.append(a.out_name)
    return pa.Table.from_arrays(
        [_as_array(a, merged.num_rows) for a in out_arrays], names=out_names
    )


def _merge_fns(aggs: Sequence[AggExpr]) -> List[str]:
    out = []
    for a in aggs:
        if a.agg == "mean":
            out.extend(["sum", "sum"])
        elif _is_moment_agg(a.agg):
            out.extend(["sum", "sum", "sum"])
        else:
            out.append(_AGG_PHASES[a.agg][1])
    return out


# ---------------------------------------------------------------------------
# Splitting (shuffle map-side)
# ---------------------------------------------------------------------------


def _hash_numeric(values: np.ndarray) -> np.ndarray:
    """pandas.util.hash_array's numeric path, bit-exact, without pandas: a
    splitmix64-style mixer over the raw 8-byte view. Numeric hashing is the
    shuffle/F.hash hot path, and importing pandas for it cost each executor
    ~0.3s on its first task (the zygote warms pandas AFTER serving
    first-session forks)."""
    if values.dtype.kind == "b":
        u = values.astype("u8")
    elif values.dtype.itemsize == 8:
        u = values.view("u8").copy()
    else:
        u = values.view(f"u{values.dtype.itemsize}").astype("u8")
    u ^= u >> np.uint64(30)
    u *= np.uint64(0xBF58476D1CE4E5B9)
    u ^= u >> np.uint64(27)
    u *= np.uint64(0x94D049BB133111EB)
    u ^= u >> np.uint64(31)
    return u


def stable_hash_column(column) -> np.ndarray:
    """Cross-process-deterministic per-row uint64 hash (the shuffle contract:
    the same key must land on the same reducer no matter which executor hashed
    it). Matches pandas hash_array everywhere: numerics via the pandas-free
    mixer above, strings/objects via pandas' keyed siphash."""
    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    if isinstance(column, pa.Array) and (
        pa.types.is_integer(column.type)
        or pa.types.is_floating(column.type)
        or pa.types.is_boolean(column.type)
    ):
        if not column.null_count:
            return _hash_numeric(column.to_numpy(zero_copy_only=False))
        # nulls: hash the values in their ORIGINAL dtype and stamp null
        # positions with a fixed constant. Routing null-bearing partitions
        # through pandas instead would hash a nullable int column as
        # float64 (to_pandas converts) while null-free partitions hash int
        # bits — the same key would land on different reducers.
        mask = column.is_null().to_numpy(zero_copy_only=False)
        filled = column.fill_null(
            False if pa.types.is_boolean(column.type) else 0
        ).to_numpy(zero_copy_only=False)
        hashed = _hash_numeric(filled)
        hashed[mask] = np.uint64(0x9E3779B97F4A7C15)
        return hashed
    if isinstance(column, np.ndarray) and column.dtype.kind in "biuf":
        return _hash_numeric(column)
    import pandas as pd

    values = column.to_pandas() if not isinstance(column, np.ndarray) else column
    return pd.util.hash_array(np.asarray(values)).astype(np.uint64)


def _hash_indices(table: pa.Table, keys: List[str], num_splits: int) -> np.ndarray:
    combined = np.zeros(table.num_rows, dtype=np.uint64)
    for k in keys:
        combined = combined * np.uint64(31) + stable_hash_column(table.column(k))
    return (combined % np.uint64(num_splits)).astype(np.int64)


def _range_indices(
    table: pa.Table, keys: List[str], boundaries: pa.Table, ascending: List[bool]
) -> np.ndarray:
    """Assign each row to a range partition via searchsorted on the first key
    (boundaries were sampled on the same basis, nulls excluded).

    Null keys sort LAST in either direction (matching the merge step's
    ``null_placement="at_end"``), so null rows route to the LAST partition —
    on object arrays searchsorted would raise comparing None, and on floats
    NaN's ordering was direction-dependent garbage before this."""
    key = keys[0]
    column = table.column(key).combine_chunks()
    null_mask = column.is_null().to_numpy(zero_copy_only=False)
    values = column.to_numpy(zero_copy_only=False)
    bounds = boundaries.column(key).to_numpy(zero_copy_only=False)
    idx = np.full(len(values), len(bounds), dtype=np.int64)  # nulls → last
    valid = ~null_mask
    if valid.any():
        pos = np.searchsorted(bounds, values[valid], side="right")
        if not ascending[0]:
            pos = len(bounds) - pos
        idx[valid] = pos
    return idx


def _split_table(table: pa.Table, indices: np.ndarray, num_splits: int) -> List[pa.Table]:
    order = np.argsort(indices, kind="stable")
    sorted_idx = indices[order]
    taken = table.take(pa.array(order))
    out = []
    starts = np.searchsorted(sorted_idx, np.arange(num_splits), side="left")
    ends = np.searchsorted(sorted_idx, np.arange(num_splits), side="right")
    for s, e in zip(starts, ends):
        out.append(taken.slice(s, e - s))
    return out


# ---------------------------------------------------------------------------
# Task execution
# ---------------------------------------------------------------------------


def _read_and_merge(spec: TaskSpec) -> pa.Table:
    """Read inputs and apply the stage's merge step (join/final_agg/sort/
    distinct) — shared by the plain and traced task runners so the trace
    path can never diverge from real execution."""
    tables = [_read_one(r) for r in spec.reads]
    if spec.merge.kind == "join":
        left = (
            pa.concat_tables(tables, promote_options="permissive")
            if len(tables) > 1
            else tables[0]
        )
        right = _read_one(spec.merge.right)
        return left.join(
            right, keys=spec.merge.keys, join_type=spec.merge.join_how,
            use_threads=arrow_threads(),
        )
    table = (
        pa.concat_tables(tables, promote_options="permissive")
        if len(tables) > 1
        else tables[0]
    )
    if spec.merge.kind == "final_agg":
        table = final_agg(table, spec.merge.keys, spec.merge.aggs)
    elif spec.merge.kind == "sort":
        # nulls sort LAST in either direction — explicit so the within-
        # partition order provably matches the range router's nulls-to-last-
        # partition placement (global order would silently break otherwise)
        table = table.sort_by(
            [
                (k, "ascending" if asc else "descending")
                for k, asc in zip(spec.merge.keys, spec.merge.ascending)
            ],
            null_placement="at_end",
        )
    elif spec.merge.kind == "distinct":
        table = table.group_by(
            table.column_names, use_threads=arrow_threads()
        ).aggregate([])
    return table


def run_task(spec: TaskSpec) -> TaskResult:
    if os.environ.get("RAYDP_TPU_TASK_TRACE"):
        return _run_task_traced(spec)
    from raydp_tpu_torch import obs

    # The spans ARE the timers: the same records that ship to the trace
    # timeline (executor tracks in Perfetto) also fill the TaskResult phase
    # fields last_query_stats aggregates — one instrumentation plane, no
    # parallel hand-rolled perf_counter bookkeeping. The collect() scope
    # forces real spans even with tracing disabled, so query stats always
    # work; with tracing on they additionally buffer for the head.
    with obs.collect():
        with obs.span(
            "task.run",
            partition=spec.partition_index,
            merge=spec.merge.kind,
            output=spec.output.kind,
        ):
            with obs.span("task.read", inputs=len(spec.reads)) as s_read:
                table = _read_and_merge(spec)
            with obs.span("task.compute", ops=len(spec.chain)) as s_compute:
                for node in spec.chain:
                    table = apply_narrow(table, node, spec.partition_index)
            with obs.span("task.emit", rows=table.num_rows) as s_emit:
                result = _emit(table, spec)
    obs.metrics.counter("etl.tasks_run").inc()
    result.read_seconds = s_read.duration
    result.compute_seconds = s_compute.duration
    result.emit_seconds = s_emit.duration
    return result


_TRACE_SEQ = iter(range(1 << 62))  # per-process trace-file sequence


def _run_task_traced(spec: TaskSpec) -> TaskResult:
    """Debug-only (RAYDP_TPU_TASK_TRACE=<path-prefix>): per-phase wall times
    and newly-imported modules, one JSON file per task. Execution is the
    SAME code as run_task (shared _read_and_merge/apply_narrow/_emit)."""
    import json
    import sys
    import time

    t = {}
    before = set(sys.modules)
    t0 = time.perf_counter()
    table = _read_and_merge(spec)
    t["read_merge"] = round(time.perf_counter() - t0, 3)
    for i, node in enumerate(spec.chain):
        t0 = time.perf_counter()
        table = apply_narrow(table, node, spec.partition_index)
        t[f"chain{i}:{type(node).__name__}"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    result = _emit(table, spec)
    t["emit"] = round(time.perf_counter() - t0, 3)
    t["new_mods"] = sorted(
        m for m in (set(sys.modules) - before) if "." not in m
    )[:20]
    path = (
        os.environ["RAYDP_TPU_TASK_TRACE"]
        + f".{os.getpid()}.{next(_TRACE_SEQ)}"
    )
    with open(path, "w") as f:
        json.dump(t, f)
    return result


def _emit(table: pa.Table, spec: TaskSpec) -> TaskResult:
    out = spec.output
    if out.kind == "count":
        return TaskResult(count=table.num_rows)
    if out.kind == "inline":
        return TaskResult(inline_ipc=table_to_ipc_bytes(table), count=table.num_rows)
    if out.kind == "block":
        ref, n = write_table_block(
            table, owner=out.owner, max_records=out.max_records,
            storage=out.storage,
        )
        return TaskResult(
            blocks=[ref], num_rows=[n],
            block_metas=[store.local_meta(ref.object_id)],
        )
    if out.kind == "parquet":
        import pyarrow.parquet as pq

        os.makedirs(out.path, exist_ok=True)
        path = os.path.join(out.path, f"part-{spec.partition_index:05d}.parquet")
        pq.write_table(table, path)
        return TaskResult(count=table.num_rows)
    if out.kind == "sample":
        n = table.num_rows
        if n > out.sample_limit:
            rng = np.random.default_rng(out.seed or 0)
            idx = np.sort(rng.choice(n, size=out.sample_limit, replace=False))
            table = table.take(pa.array(idx))
        keep = table.select(out.keys)
        return TaskResult(inline_ipc=table_to_ipc_bytes(keep), count=n)

    if out.kind == "hash_split":
        if table.num_rows == 0:
            indices = np.zeros(0, dtype=np.int64)
        else:
            indices = _hash_indices(table, out.keys, out.num_splits)
    elif out.kind == "range_split":
        boundaries = ipc_bytes_to_table(out.boundaries_ipc)
        indices = (
            _range_indices(table, out.keys, boundaries, out.ascending)
            if table.num_rows
            else np.zeros(0, dtype=np.int64)
        )
    elif out.kind == "random_split":
        rng = np.random.default_rng(
            (out.seed if out.seed is not None else 0) + spec.partition_index
        )
        if out.weights is not None:
            indices = rng.choice(out.num_splits, p=out.weights, size=table.num_rows)
        else:
            indices = rng.integers(0, out.num_splits, size=table.num_rows)
    elif out.kind == "round_robin_split":
        indices = (
            np.arange(table.num_rows, dtype=np.int64) + spec.partition_index
        ) % out.num_splits
    else:
        raise ValueError(f"unknown output kind {out.kind!r}")

    splits = _split_table(table, indices.astype(np.int64), out.num_splits)
    if out.indexed_splits:
        # ONE block holds every split (+ offset-index footer): block count
        # per shuffle drops from M×R to M and metadata registers in one RPC
        ref, slices, counts = write_indexed_splits(
            splits, owner=out.owner, max_records=out.max_records,
        )
        return TaskResult(
            blocks=[ref] if ref is not None else [],
            num_rows=counts,
            split_slices=slices,
            block_metas=(
                [store.local_meta(ref.object_id)] if ref is not None else []
            ),
        )
    refs: List[Optional[store.ObjectRef]] = []
    counts: List[int] = []
    # legacy per-split blocks still register their metadata in ONE frame
    with store.batched_registration():
        for sub in splits:
            if sub.num_rows == 0:
                refs.append(None)
                counts.append(0)
            else:
                ref, n = write_table_block(
                    sub, owner=out.owner, max_records=out.max_records
                )
                refs.append(ref)
                counts.append(n)
    return TaskResult(
        blocks=refs,
        num_rows=counts,
        block_metas=[
            store.local_meta(r.object_id) if r is not None else None
            for r in refs
        ],
    )
