"""The exchange layer's datasets: the port's copy of
``raydp_tpu/exchange/dataset.py``, with ``ArrayDataset`` beside it.

The exchange currency is the Arrow IPC block in the shared-memory object
store, with its ownership semantics:

- ``dataframe_to_dataset(df)``: materialize the frame's partitions as
  blocks; with ``_use_owner=True`` ownership is transferred to the
  session's master actor, so the data outlives the ETL engine
  (``stop_etl(cleanup_data=False)``).
- ``dataset_to_dataframe(session, ds)``: zero-copy re-entry into the ETL
  engine.
- ``from_etl_recoverable(df)``: blocks carry a recompute lineage; if a
  block's owner died, the plan is re-executed to re-materialize it.
- ``dataset_from_parquet(paths)``: driver-local parquet, one block a file.

``Dataset`` stages to numpy (``to_numpy``, ``to_numpy_grouped``) or
streams block by block (``iter_batches(streaming=True)``,
``StreamingBatchIterator``), with the span decode on the session's
executors while the session lives. Rank sharding uses ``divide_blocks``
(``utils.py``) so every rank sees the same sample count.

``ArrayDataset`` is the numpy source the estimator also takes: named
columns in blocks of rows, with ``Dataset``'s staging methods and its
staging rules (an integer target refuses non-finite floats and ids outside
its range, with the same messages), its blocks (``num_blocks``,
``counts``, ``get_block``) and ``iter_batches(streaming=True)``'s batch
order. A block here is a row range of the columns, returned as numpy
views, so nothing is decoded and no executor is involved.
"""

from __future__ import annotations

import uuid as _uuid
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import pyarrow as pa

from raydp_tpu_torch import sanitize
from raydp_tpu_torch.cluster.common import ClusterError
from raydp_tpu_torch.etl import plan as lp
from raydp_tpu_torch.etl import tasks as T
from raydp_tpu_torch.store import object_store as store
from raydp_tpu_torch.utils import divide_blocks


class Dataset:
    """Distributed dataset over Arrow blocks in the object store."""

    def __init__(
        self,
        blocks: List[store.ObjectRef],
        schema: pa.Schema,
        counts: List[int],
        dataset_uuid: Optional[str] = None,
        session: Any = None,
        recover_plan: Optional[lp.PlanNode] = None,
    ):
        self.blocks = list(blocks)
        self.schema = schema
        self.counts = list(counts)
        self.uuid = dataset_uuid or _uuid.uuid4().hex
        self._session = session
        self._recover_plan = recover_plan

    # ------------------------------------------------------------------
    # basics
    # ------------------------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def count(self) -> int:
        return sum(self.counts)

    def __len__(self) -> int:
        return self.count()

    def __repr__(self) -> str:
        return (
            f"Dataset(blocks={self.num_blocks}, rows={self.count()}, "
            f"schema=[{', '.join(self.schema.names)}])"
        )

    def get_block(self, index: int) -> pa.Table:
        """Read one block (zero-copy). A lost block (owner died / deleted)
        recovers through the planner's LINEAGE first — re-execute just the
        producing task and rebind the regenerated block under the same ref
 — and only falls back to the coarse
        whole-plan re-materialization ``from_etl_recoverable`` datasets
        carry. Recovery requires a LIVE session: after ``stop_etl`` the
        ownership contract holds (non-transferred data is gone —
        test_ownership_dies_with_session)."""
        try:
            return T.read_table_block(self.blocks[index])
        except ClusterError as exc:
            return self._recover_block(index, exc)

    def _recover_block(self, index: int, exc: ClusterError) -> pa.Table:
        from raydp_tpu_torch.etl import lineage as _lineage

        session = self._session
        live = session is not None and not getattr(session, "_stopped", True)
        if live and _lineage.is_lost_block_error(exc):
            planner = getattr(session, "_planner", None)
            if planner is not None and planner.lineage_recovery:
                try:
                    planner.recover_blocks([self.blocks[index]])
                    return T.read_table_block(self.blocks[index])
                except ClusterError:  # no lineage entry / re-execution failed: fall through to plan re-materialization, original error re-raised below when absent
                    pass
        if self._recover_plan is None or session is None:
            raise exc
        self._recover_all()
        return T.read_table_block(self.blocks[index])

    def _recover_all(self) -> None:
        """Re-execute the producing plan and swap in fresh blocks (coarse
        re-materialization — the analog of RecacheRDD re-running rdd.count).
        The deep fallback behind lineage recovery: it handles even total
        loss of every block AND its lineage (e.g. a new driver process)."""
        mat = self._session._planner.materialize(self._recover_plan)
        self.blocks = [b for b in mat.blocks if b is not None]
        self.counts = [c for b, c in zip(mat.blocks, mat.counts) if b is not None]

    def to_arrow(self) -> pa.Table:
        tables = [self.get_block(i) for i in range(self.num_blocks)]
        tables = [t for t in tables if t.num_rows] or [self.schema.empty_table()]
        return pa.concat_tables(tables, promote_options="permissive")

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def take(self, n: int) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for i in range(self.num_blocks):
            if len(out) >= n:
                break
            out.extend(self.get_block(i).slice(0, n - len(out)).to_pylist())
        return out

    # ------------------------------------------------------------------
    # transforms (executed through the session's executor pool when present)
    # ------------------------------------------------------------------

    def _as_plan(self) -> lp.PlanNode:
        return lp.ArrowSource(self.blocks, self.schema)

    def _run(self, node: lp.PlanNode) -> "Dataset":
        planner = self._planner()
        mat = planner.materialize(node)
        return Dataset(
            [b for b in mat.blocks if b is not None],
            mat.schema,
            [c for b, c in zip(mat.blocks, mat.counts) if b is not None],
            session=self._session,
        )

    def _planner(self):
        if self._session is not None:
            return self._session._planner
        from raydp_tpu_torch.etl.planner import Planner

        return Planner(default_parallelism=max(1, self.num_blocks))

    def map_batches(self, fn: Callable[[pa.Table], pa.Table]) -> "Dataset":
        return self._run(lp.MapBatches(self._as_plan(), fn))

    def filter(self, predicate) -> "Dataset":
        return self._run(lp.Filter(self._as_plan(), predicate))

    def select(self, columns: Sequence[str]) -> "Dataset":
        from raydp_tpu_torch.etl.expressions import ColumnRef

        return self._run(
            lp.Project(self._as_plan(), [(c, ColumnRef(c)) for c in columns])
        )

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._run(lp.Repartition(self._as_plan(), num_blocks))

    def random_shuffle(self, seed: int = 0) -> "Dataset":
        return self._run(
            lp.Repartition(
                self._as_plan(),
                max(1, self.num_blocks),
                shuffle_seed=seed,
            )
        )

    def split(self, n: int, equal: bool = True) -> List["Dataset"]:
        """Split into n datasets block-wise (for per-worker feeds). With
        ``equal=True`` uses divide_blocks so every shard has the same row
        count (oversampling, reference utils.py:149-222)."""
        if equal:
            # empty blocks (a filter can zero out a partition) carry no rows
            # and would trip divide_blocks' every-block-nonempty invariant
            nonzero = [
                (i, c) for i, c in enumerate(self.counts) if c > 0
            ]
            if len(nonzero) < n:
                return self._split_rebalanced(n)
            assignment = divide_blocks([c for _, c in nonzero], n)
            shards = []
            for rank in range(n):
                refs, counts = [], []
                for local_index, take_rows in assignment[rank]:
                    block_index = nonzero[local_index][0]
                    if take_rows == self.counts[block_index]:
                        refs.append(self.blocks[block_index])
                        counts.append(take_rows)
                    else:  # prefix slice materialized as a fresh block
                        ref, cnt = self._slice_block(block_index, take_rows)
                        refs.append(ref)
                        counts.append(cnt)
                shards.append(
                    Dataset(refs, self.schema, counts, session=self._session)
                )
            return shards
        shards = []
        per = -(-self.num_blocks // n)
        for rank in range(n):
            refs = self.blocks[rank * per : (rank + 1) * per]
            counts = self.counts[rank * per : (rank + 1) * per]
            shards.append(Dataset(refs, self.schema, counts, session=self._session))
        return shards

    def _slice_block(self, block_index: int, take_rows: int):
        """Prefix-slice one block into a fresh block. With a live executor
        pool the slice runs EXECUTOR-side (locality-dispatched read → trim →
        write; the rows never touch the driver); otherwise driver-local."""
        planner = getattr(self._session, "_planner", None) if self._session else None
        if planner is not None and planner.executors:
            node = lp.GlobalLimit(
                lp.PartitionHead(
                    lp.ArrowSource([self.blocks[block_index]], self.schema),
                    take_rows,
                ),
                take_rows,
            )
            mat = planner.materialize(node)
            blocks = [b for b in mat.blocks if b is not None]
            if len(blocks) == 1:
                from raydp_tpu_torch.store import object_store as store

                # the slice must live and die with its SOURCE block, not with
                # the executor that happened to produce it (executor-owned
                # slices would be GC'd on scale-down/stop while the rest of
                # the shard survives)
                src_owner = store.owner_of(self.blocks[block_index])
                if src_owner:
                    store.transfer([blocks[0]], src_owner)
                return blocks[0], sum(mat.counts)
            if blocks:  # unexpected multi-block output: don't leak it
                from raydp_tpu_torch.store import object_store as store

                store.delete(blocks)
        table = self.get_block(block_index).slice(0, take_rows)
        return T.write_table_block(table)

    def _split_rebalanced(self, n: int) -> List["Dataset"]:
        """Fewer non-empty blocks than ranks: materialize once and re-slice
        into n equal fresh blocks (wrapping to oversample the remainder).
        Driver-side by design — this path only triggers when the dataset has
        fewer non-empty blocks than ranks, i.e. it is small (the 6-rows/
        3-workers odd-shape case of reference test_torch_sequential.py)."""
        table = self.to_arrow()
        total = table.num_rows
        per = max(1, -(-total // n)) if total else 0
        shards = []
        for rank in range(n):
            if total == 0:
                sliced = self.schema.empty_table()
            else:
                start = (rank * per) % total
                sliced = table.slice(start, per)
                while sliced.num_rows < per:  # wrap-around top-up
                    sliced = pa.concat_tables(
                        [sliced, table.slice(0, per - sliced.num_rows)]
                    )
            ref, cnt = T.write_table_block(sliced)
            shards.append(Dataset([ref], self.schema, [cnt], session=self._session))
        return shards

    # ------------------------------------------------------------------
    # training-side feeding
    # ------------------------------------------------------------------

    def to_numpy(
        self,
        feature_columns: Sequence[str],
        label_column: Optional[str] = None,
        feature_dtype=np.float32,
        label_dtype=np.float32,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Materialize as a dense feature matrix [N, F] (+ label vector).
        Deliberately O(dataset) in THIS process's memory — it exists to stage
        training data host-side once. For datasets that must not be
        materialized whole, use ``iter_batches(streaming=True)`` or
        ``Estimator(streaming=True)`` (O(block) memory)."""
        return _table_to_numpy(
            self.to_arrow(), feature_columns, label_column,
            feature_dtype, label_dtype,
        )

    def to_numpy_grouped(
        self,
        feature_groups: Sequence[Tuple[Sequence[str], Any]],
        label_column: Optional[str] = None,
        label_dtype=np.float32,
    ) -> Tuple[Tuple[np.ndarray, ...], Optional[np.ndarray]]:
        """Like ``to_numpy`` but stages SEVERAL feature matrices in one
        Arrow pass, one per ``(columns, dtype)`` group — the mixed-dtype
        path (e.g. DLRM: dense float32 + categorical ids int32, where one
        float matrix would silently collapse ids beyond float32's exact-
        integer range and double the H2D bytes as float64)."""
        return _table_to_numpy_grouped(
            self.to_arrow(), feature_groups, label_column, label_dtype
        )

    def iter_batches(
        self,
        batch_size: int,
        feature_columns: Sequence[str],
        label_column: Optional[str] = None,
        shuffle: bool = False,
        seed: Optional[int] = None,
        drop_last: bool = False,
        feature_dtype=np.float32,
        label_dtype=np.float32,
        streaming: bool = False,
        block_plan: Optional[List[Tuple[int, int, int]]] = None,
        feature_groups: Optional[Sequence[Tuple[Sequence[str], Any]]] = None,
        executor_decode: bool = True,
    ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Batches of (features [B, F], labels [B]).

        ``streaming=False`` (default): stage the whole dataset once, shuffle
        globally — fastest when it fits in host memory.
        ``streaming=True``: O(block) host memory — blocks are staged one at
        a time with one block prefetched in a background thread (double
        buffering); shuffling is block-order + within-block (the standard
        streaming trade vs a global shuffle). Batches straddle block
        boundaries via a carryover, so batch shapes are identical to the
        staged path. ``block_plan`` (streaming only) restricts the pass to
        ``streaming_shard_plan`` spans without materializing slices.
        ``feature_groups`` (overrides feature_columns/feature_dtype): stage
        one matrix per (columns, dtype) group — batches yield a TUPLE of
        feature arrays (the mixed-dtype path).
        ``executor_decode`` (streaming only, default on): when the dataset's
        ETL session is still alive, per-span Arrow→numpy decode runs in the
        session's EXECUTOR processes instead of this one (graceful local
        fallback when the session is stopped or an executor dies).
        """
        if streaming:
            return StreamingBatchIterator(
                self, batch_size, feature_columns, label_column,
                shuffle, seed, drop_last, feature_dtype, label_dtype,
                block_plan=block_plan, feature_groups=feature_groups,
                executor_decode=executor_decode,
            )
        return self._iter_batches_staged(
            batch_size, feature_columns, label_column, shuffle, seed,
            drop_last, feature_dtype, label_dtype, feature_groups,
        )

    def _iter_batches_staged(
        self, batch_size, feature_columns, label_column, shuffle, seed,
        drop_last, feature_dtype, label_dtype, feature_groups=None,
    ):
        if feature_groups is not None:
            features, labels = self.to_numpy_grouped(
                feature_groups, label_column, label_dtype
            )
            first = features[0]
        else:
            features, labels = self.to_numpy(
                feature_columns, label_column, feature_dtype, label_dtype
            )
            first = features
        n = len(first)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = (n // batch_size) * batch_size if drop_last else n
        for start in range(0, stop, batch_size):
            idx = order[start : start + batch_size]
            if feature_groups is not None:
                yield tuple(g[idx] for g in features), (
                    labels[idx] if labels is not None else None
                )
            else:
                yield features[idx], (
                    labels[idx] if labels is not None else None
                )

    def to_torch(
        self,
        feature_columns: Sequence[str],
        label_column: Optional[str] = None,
        batch_size: int = 32,
        shuffle: bool = False,
        seed: Optional[int] = None,
    ):
        """A torch IterableDataset over this dataset's batches (parity:
        RayMLDataset.to_torch, reference dataset.py:498-581)."""
        import torch

        outer = self

        class _Iterable(torch.utils.data.IterableDataset):
            def __iter__(self):
                for features, labels in outer.iter_batches(
                    batch_size, feature_columns, label_column, shuffle, seed
                ):
                    # the tensors share the batch's arrays
                    sanitize.note_external_host_buffer(features, "Dataset.to_torch")
                    x = torch.from_numpy(features)
                    if labels is None:
                        yield x
                    else:
                        sanitize.note_external_host_buffer(labels, "Dataset.to_torch")
                        yield x, torch.from_numpy(labels)

            def __len__(self):
                return -(-outer.count() // batch_size)

        return _Iterable()

    # ------------------------------------------------------------------
    # ownership
    # ------------------------------------------------------------------

    def transfer_to_master(self) -> None:
        """Pin blocks in the session's master/holder actor so they survive
        ``stop_etl(cleanup_data=False)`` (reference _use_owner path)."""
        if self._session is None:
            raise ClusterError("dataset has no session to transfer ownership to")
        self._session.master.add_objects(self.uuid, self.blocks)

    def owners(self) -> List[Optional[str]]:
        return [store.owner_of(b) for b in self.blocks]


def _table_to_numpy(
    table: pa.Table,
    feature_columns: Sequence[str],
    label_column: Optional[str],
    feature_dtype,
    label_dtype,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Single-matrix staging — the one-group case of the grouped path."""
    features, labels = _table_to_numpy_grouped(
        table, [(feature_columns, feature_dtype)], label_column, label_dtype
    )
    return features[0], labels


def _table_to_numpy_grouped(
    table: pa.Table,
    feature_groups: Sequence[Tuple[Sequence[str], Any]],
    label_column: Optional[str],
    label_dtype,
) -> Tuple[Tuple[np.ndarray, ...], Optional[np.ndarray]]:
    """One matrix per (columns, dtype) group, staged from ONE arrow table
    pass — the mixed-dtype feeding path (dense floats + integer ids)."""

    def _col(c, dtype):
        arr = table.column(c).combine_chunks().to_numpy(zero_copy_only=False)
        target = np.dtype(dtype)
        if np.issubdtype(target, np.integer):
            if np.issubdtype(arr.dtype, np.floating):
                # arrow surfaces nullable int columns as float64+NaN; a
                # silent astype would turn NaN (or inf) into INT_MIN and
                # gather-clamp every such row onto embedding 0 — fail loudly
                if not np.isfinite(arr).all():
                    raise ValueError(
                        f"column {c!r} contains nulls or non-finite values "
                        f"and cannot stage as {target}; fill or drop them "
                        "in ETL first"
                    )
            if arr.size and np.issubdtype(arr.dtype, np.integer):
                info = np.iinfo(target)
                lo, hi = arr.min(), arr.max()
                # astype wraps out-of-range ids negative — the same silent-
                # collision class as lossy floats; demand a wider dtype
                if lo < info.min or hi > info.max:
                    raise ValueError(
                        f"column {c!r} has ids outside {target} range "
                        f"[{info.min}, {info.max}]; use a wider "
                        "categorical_dtype (e.g. np.int64)"
                    )
        return arr

    features = tuple(
        np.stack([_col(c, dtype) for c in cols], axis=1).astype(dtype)
        for cols, dtype in feature_groups
    )
    labels = None
    if label_column is not None:
        labels = (
            table.column(label_column)
            .combine_chunks()
            .to_numpy(zero_copy_only=False)
            .astype(label_dtype)
        )
    return features, labels


class ArrayDataset:
    """Named columns of equal length, held as numpy arrays, in blocks of
    rows (one block unless built by ``from_blocks``).

    ``uuid`` identifies the dataset, as ``Dataset.uuid`` does, so a staging
    cache keyed on it tells two datasets apart."""

    def __init__(self, columns: Mapping[str, Any],
                 counts: Optional[Sequence[int]] = None):
        self.columns = {name: np.asarray(col) for name, col in columns.items()}
        lengths = {name: len(col) for name, col in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"columns differ in length: {lengths}")
        n = next(iter(lengths.values()), 0)
        self.counts = [n] if counts is None else [int(c) for c in counts]
        if sum(self.counts) != n or min(self.counts, default=0) < 0:
            raise ValueError(f"block counts {self.counts} do not cover {n} rows")
        self._starts = np.cumsum([0] + self.counts)
        self.uuid = _uuid.uuid4().hex

    @classmethod
    def from_blocks(cls, blocks: Sequence[Mapping[str, Any]]) -> "ArrayDataset":
        """One block per mapping of columns (the same names in each)."""
        if not blocks:
            raise ValueError("from_blocks needs at least one block")
        names = list(blocks[0])
        for block in blocks[1:]:
            if list(block) != names:
                raise ValueError(f"blocks differ in columns: {list(block)} "
                                 f"vs {names}")
        counts = [len(np.asarray(block[names[0]])) for block in blocks]
        columns = {c: np.concatenate([np.asarray(b[c]) for b in blocks])
                   for c in names}
        return cls(columns, counts)

    @property
    def num_blocks(self) -> int:
        return len(self.counts)

    def count(self) -> int:
        return int(self._starts[-1])

    def get_block(self, index: int) -> "ArrayDataset":
        """Block ``index`` as a one-block dataset of views of the columns."""
        lo, hi = int(self._starts[index]), int(self._starts[index + 1])
        return ArrayDataset({c: a[lo:hi] for c, a in self.columns.items()})

    def iter_batches(
        self,
        batch_size: int,
        feature_columns: Sequence[str],
        label_column: Optional[str] = None,
        shuffle: bool = False,
        seed: Optional[int] = None,
        drop_last: bool = False,
        feature_dtype=np.float32,
        label_dtype=np.float32,
        block_plan: Optional[List[Tuple[int, int, int]]] = None,
        feature_groups: Optional[Sequence[Tuple[Sequence[str], Any]]] = None,
        streaming: bool = True,
        executor_decode: bool = True,
    ) -> Iterator[Tuple[Any, Optional[np.ndarray]]]:
        """Batches of (features, labels) in ``StreamingBatchIterator``'s
        order, block by block: host memory holds one block and a carryover
        of less than a batch. ``feature_groups`` (overrides
        ``feature_columns``/``feature_dtype``) yields a tuple of matrices,
        one per ``(columns, dtype)`` group. ``block_plan`` restricts the
        pass to ``(block, start, stop)`` spans (``streaming_shard_plan``).
        This is ``Dataset.iter_batches(streaming=True)``'s order; the
        staged order of ``streaming=False`` is the estimator's own
        (``_HostArrays``), so ``streaming=False`` is refused here.
        ``executor_decode`` is taken for ``Dataset``'s signature: the
        columns are numpy already and no executor decodes them."""
        if not streaming:
            raise ValueError("ArrayDataset.iter_batches streams only; stage "
                             "with to_numpy/to_numpy_grouped")
        grouped = feature_groups is not None
        groups = ([(list(c), d) for c, d in feature_groups] if grouped
                  else [(list(feature_columns), feature_dtype)])
        rng = np.random.default_rng(seed)
        plan = (list(block_plan) if block_plan is not None
                else [(i, 0, c) for i, c in enumerate(self.counts)])
        order = np.arange(len(plan))
        if shuffle:
            rng.shuffle(order)

        def emit(parts, labels):
            return (tuple(parts) if grouped else parts[0]), labels

        left_p = left_l = None
        for oi in order:
            bi, row_start, row_stop = plan[int(oi)]
            if row_stop <= row_start:
                continue
            lo = int(self._starts[bi])
            span = ArrayDataset({c: a[lo + row_start:lo + row_stop]
                                 for c, a in self.columns.items()})
            parts, labels = span.to_numpy_grouped(groups, label_column,
                                                  label_dtype)
            parts = list(parts)
            if shuffle:
                perm = rng.permutation(len(parts[0]))
                parts = [p[perm] for p in parts]
                labels = labels[perm] if labels is not None else None
            if left_p is not None and len(left_p[0]):
                parts = [np.concatenate([lp, p]) for lp, p in zip(left_p, parts)]
                if labels is not None:
                    labels = np.concatenate([left_l, labels])
            full = (len(parts[0]) // batch_size) * batch_size
            for s in range(0, full, batch_size):
                yield emit([p[s:s + batch_size] for p in parts],
                           labels[s:s + batch_size] if labels is not None
                           else None)
            left_p = [p[full:] for p in parts]
            left_l = labels[full:] if labels is not None else None
        if left_p is not None and len(left_p[0]) and not drop_last:
            yield emit(left_p, left_l)

    def to_numpy(
        self,
        feature_columns: Sequence[str],
        label_column: Optional[str] = None,
        feature_dtype=np.float32,
        label_dtype=np.float32,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """A dense feature matrix [N, F] (+ label vector)."""
        features, labels = self.to_numpy_grouped(
            [(feature_columns, feature_dtype)], label_column, label_dtype
        )
        return features[0], labels

    def to_numpy_grouped(
        self,
        feature_groups: Sequence[Tuple[Sequence[str], Any]],
        label_column: Optional[str] = None,
        label_dtype=np.float32,
    ) -> Tuple[Tuple[np.ndarray, ...], Optional[np.ndarray]]:
        """One matrix per ``(columns, dtype)`` group -- the mixed-dtype path
        (dense float32 + integer ids, which one float matrix would collapse
        past float32's exact-integer range), by ``Dataset``'s staging rules
        over the columns as an Arrow table (numeric columns convert without
        a copy)."""
        return _table_to_numpy_grouped(pa.table(self.columns), feature_groups,
                                       label_column, label_dtype)


def streaming_shard_plan(
    counts: Sequence[int], num_shards: int, rank: int
) -> List[Tuple[int, int, int]]:
    """Block-level plan for one rank's equal-rows shard: a list of
    ``(block_index, start_row, stop_row)`` spans covering the contiguous
    global row interval ``[rank·per, (rank+1)·per)`` with wraparound
    oversampling (``per = ceil(total/num_shards)``) — the divide_blocks
    equal-count invariant WITHOUT materializing any slice, so streaming
    consumers stay O(block) in memory."""
    counts = list(counts)
    total = sum(counts)
    if total == 0:
        return []
    per = -(-total // num_shards)
    bounds = np.cumsum([0] + counts)
    spans: List[Tuple[int, int, int]] = []
    pos = (rank * per) % total
    remaining = per
    while remaining > 0:
        b = int(np.searchsorted(bounds, pos, side="right") - 1)
        off = pos - int(bounds[b])
        take = min(counts[b] - off, remaining)
        spans.append((b, off, off + take))
        remaining -= take
        pos = (pos + take) % total
    return spans


class StreamingBatchIterator:
    """Block-streaming batch iterator: host memory is O(largest block), not
    O(dataset). A background thread stages the NEXT block (Arrow → numpy)
    while batches are served from the current one; a carryover joins rows
    across block boundaries so every batch is full-size.

    ``peak_staged_rows`` records the high-water mark of rows resident at
    once (current + carryover + the one prefetched block) — tests assert it
    stays far below the dataset size.

    Iterable AND iterator: ``iter(it)`` starts a fresh pass; ``next(it)``
    lazily starts (and continues) a single pass.

    ``block_plan`` optionally restricts the pass to ``(block, start, stop)``
    spans (see ``streaming_shard_plan``) — the multi-process shard path.

    ``executor_decode`` (default on): with a live ETL session, the per-span
    Arrow→numpy decode (column stacking, dtype casts, null checks) runs as
    ``decode_segment`` calls on the session's EXECUTOR processes — pipelined
    two spans deep, round-robin over the pool — and this thread only
    receives ready arrays. Stopped session / dead executor falls back to
    local decode mid-pass without losing a span;
    ``executor_decode_active`` records whether any span actually decoded
    remotely.
    """

    def __init__(
        self, ds: "Dataset", batch_size: int,
        feature_columns: Sequence[str], label_column: Optional[str],
        shuffle: bool, seed: Optional[int], drop_last: bool,
        feature_dtype, label_dtype,
        block_plan: Optional[List[Tuple[int, int, int]]] = None,
        feature_groups: Optional[Sequence[Tuple[Sequence[str], Any]]] = None,
        executor_decode: bool = True,
    ):
        self._ds = ds
        self._batch_size = batch_size
        self._feature_columns = list(feature_columns)
        self._label_column = label_column
        self._shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        self._feature_dtype = feature_dtype
        self._label_dtype = label_dtype
        self._block_plan = block_plan
        # grouped mode: one matrix per (columns, dtype) group; batches yield
        # a TUPLE of feature arrays (internally everything is a list of
        # group parts — single-matrix mode is the 1-element case)
        self._feature_groups = (
            [(list(c), d) for c, d in feature_groups]
            if feature_groups is not None
            else None
        )
        self._executor_decode = bool(executor_decode)
        self.executor_decode_active = False
        self._active_gen = None
        self.peak_staged_rows = 0

    def _decode_handles(self):
        """The live session's executor pool, or None (toggle off, no
        session, stopped session — the post-``stop_etl`` training flow)."""
        if not self._executor_decode:
            return None
        session = getattr(self._ds, "_session", None)
        if session is None or getattr(session, "_stopped", True):
            return None
        planner = getattr(session, "_planner", None)
        handles = list(getattr(planner, "executors", None) or [])
        return handles or None

    def _total_rows(self) -> int:
        if self._block_plan is not None:
            return sum(stop - start for _, start, stop in self._block_plan)
        return self._ds.count()

    def __len__(self) -> int:
        total = self._total_rows()
        if self._drop_last:
            return total // self._batch_size
        return -(-total // self._batch_size)

    def __next__(self):
        if self._active_gen is None:
            self._active_gen = self.__iter__()
        return next(self._active_gen)

    def __iter__(self):
        import queue
        import threading

        ds = self._ds
        rng = np.random.default_rng(self._seed)
        if self._block_plan is not None:
            plan = list(self._block_plan)
        else:
            plan = [(i, 0, c) for i, c in enumerate(ds.counts)]
        order = np.arange(len(plan))
        if self._shuffle:
            rng.shuffle(order)

        # maxsize=1 → exactly one block staged ahead (double buffering)
        staged: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        grouped = self._feature_groups is not None

        # single- and mixed-dtype decode share ONE converter: the single-
        # matrix mode is the 1-group case (and executor-side decode_segment
        # speaks exactly this spec)
        decode_groups = (
            self._feature_groups
            if grouped
            else [(list(self._feature_columns), self._feature_dtype)]
        )

        def _decode_local(span):
            bi, row_start, row_stop = span
            table = ds.get_block(int(bi))
            if row_start != 0 or row_stop != table.num_rows:
                table = table.slice(row_start, row_stop - row_start)
            if table.num_rows == 0:
                return None
            feats, labels = _table_to_numpy_grouped(
                table, decode_groups, self._label_column, self._label_dtype
            )
            return list(feats), labels

        def _decoded_spans():
            """One (parts, labels) per span, in order. With a live executor
            pool the decode runs EXECUTOR-side (``decode_segment``),
            pipelined two spans deep and round-robined over the pool; any
            dispatch/RPC failure downgrades to local decode mid-pass
            without losing the failed span."""
            from collections import deque

            from raydp_tpu_torch.obs import metrics

            handles = self._decode_handles()
            spans = [plan[int(oi)] for oi in order]
            futures: "deque" = deque()
            k = 0  # next span not yet dispatched (or, pool-less, not served)
            served = 0
            while served < len(spans):
                if stop.is_set():
                    return
                if handles is not None:
                    while k < len(spans) and len(futures) < 2:
                        bi, row_start, row_stop = spans[k]
                        try:
                            futures.append((
                                k,
                                handles[k % len(handles)].decode_segment.remote(
                                    ds.blocks[int(bi)], int(row_start),
                                    int(row_stop), decode_groups,
                                    self._label_column, self._label_dtype,
                                ),
                            ))
                        except Exception:  # executor gone: downgrade to local decode
                            handles = None
                            break
                        k += 1
                if futures:
                    j, future = futures.popleft()
                    try:
                        item = future.result()
                    except Exception:  # executor died mid-pass: redo this span locally
                        handles = None
                        item = _decode_local(spans[j])
                    else:
                        self.executor_decode_active = True
                        metrics.counter("exchange.executor_decode_spans").inc()
                else:
                    item = _decode_local(spans[k])
                    k += 1
                served += 1
                if item is not None:
                    yield item

        def producer():
            try:
                for item in _decoded_spans():
                    if stop.is_set():
                        return
                    staged.put(item)
                # the sentinel must not park the thread forever: a stopped
                # consumer drains at most ONE slot, and a stop-triggered
                # early return from _decoded_spans lands here with the
                # queue possibly full
                while not stop.is_set():
                    try:
                        staged.put(None, timeout=0.2)
                        return
                    except queue.Full:  # bounded retry: re-check stop, then re-offer the sentinel
                        continue
            except BaseException as e:  # surface in the consumer
                staged.put(e)

        def _emit(parts, labels):
            return (tuple(parts) if grouped else parts[0]), labels

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            batch = self._batch_size
            left_p = left_l = None
            while True:
                item = staged.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                parts, labels = item
                if self._shuffle:
                    perm = rng.permutation(len(parts[0]))
                    parts = [p[perm] for p in parts]
                    labels = labels[perm] if labels is not None else None
                if left_p is not None and len(left_p[0]):
                    parts = [
                        np.concatenate([lp, p]) for lp, p in zip(left_p, parts)
                    ]
                    if labels is not None:
                        labels = np.concatenate([left_l, labels])
                resident = len(parts[0])
                if staged.qsize():  # safe peek: only this thread consumes
                    head = staged.queue[0]
                    if head is not None and not isinstance(head, BaseException):
                        resident += len(head[0][0])
                self.peak_staged_rows = max(self.peak_staged_rows, resident)
                full = (len(parts[0]) // batch) * batch
                for s in range(0, full, batch):
                    yield _emit(
                        [p[s : s + batch] for p in parts],
                        labels[s : s + batch] if labels is not None else None,
                    )
                left_p = [p[full:] for p in parts]
                left_l = labels[full:] if labels is not None else None
            if left_p is not None and len(left_p[0]) and not self._drop_last:
                yield _emit(left_p, left_l)
        finally:
            stop.set()
            # unblock a producer waiting on a full queue
            try:
                staged.get_nowait()
            except Exception:  # queue drain at close
                pass


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def dataframe_to_dataset(
    df,
    parallelism: Optional[int] = None,
    _use_owner: bool = False,
) -> Dataset:
    """ETL DataFrame → Dataset (reference spark_dataframe_to_ray_dataset,
    dataset.py:174-184, incl. the optional repartition at :178-181). The
    partition-count probe is structural (an upper bound for limit plans), so
    a requested parallelism that matches it skips the shuffle."""
    if parallelism is not None and parallelism != df.num_partitions():
        df = df.repartition(parallelism)
    mat = df.materialize()
    blocks = [b for b in mat.blocks if b is not None]
    counts = [c for b, c in zip(mat.blocks, mat.counts) if b is not None]
    ds = Dataset(blocks, mat.schema, counts, session=df._session)
    if _use_owner:
        ds.transfer_to_master()
    return ds


def dataset_to_dataframe(session, ds: Dataset, parallelism: Optional[int] = None):
    """Dataset → ETL DataFrame, zero-copy over the same blocks (reference
    ray_dataset_to_spark_dataframe, dataset.py:265-283)."""
    from raydp_tpu_torch.etl.dataframe import DataFrame

    df = DataFrame(session, lp.ArrowSource(ds.blocks, ds.schema))
    if parallelism is not None:
        df = df.repartition(parallelism)
    return df


def dataset_from_parquet(paths) -> Dataset:
    """Driver-local parquet → Dataset (one block per file). Accepts a
    directory, a file path, or a list of either."""
    import glob
    import os

    import pyarrow.parquet as pq

    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*.parquet"))))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no parquet files in {paths}")
    blocks, counts, schema = [], [], None
    for f in files:
        table = pq.read_table(f)
        schema = table.schema
        ref, n = T.write_table_block(table)
        blocks.append(ref)
        counts.append(n)
    return Dataset(blocks, schema, counts)


def from_etl_recoverable(
    df, storage_level: str = "MEMORY_AND_DISK", _use_owner: bool = False
) -> Dataset:
    """Fault-tolerant conversion: the dataset remembers the producing plan and
    re-materializes lost blocks through the (restartable) executor pool —
    reference from_spark_recoverable semantics (dataset.py:189-209, §3.6).

    ``storage_level`` mirrors the reference's persist level
    (ObjectStoreWriter.scala:229-231): "MEMORY_AND_DISK" (default) keeps
    blocks in shm, auto-spilling to disk when shm fills; "DISK_ONLY" writes
    the blocks to the DISK spill tier — EXECUTOR-side when a live pool
    exists (each node's own spill dir; the bytes never cross to the driver,
    and without ``_use_owner`` they stay executor-owned, relying on lineage
    recovery past executor death), else migrated through the driver to its
    spill dir; "MEMORY" is accepted for API parity and behaves as
    MEMORY_AND_DISK — this store spills rather than dropping blocks
    (lineage recovery still exists for lost blocks, so durability is
    strictly ≥ the reference's)."""
    import copy

    if storage_level not in ("MEMORY", "MEMORY_AND_DISK", "DISK_ONLY"):
        raise ValueError(f"unknown storage_level {storage_level!r}")
    plan_snapshot = copy.deepcopy(df._plan)
    planner = getattr(df._session, "_planner", None)
    executor_side = (
        storage_level == "DISK_ONLY"
        and planner is not None
        and bool(planner.executors)
    )
    mat = (
        planner.materialize(df._plan, storage="disk")
        if executor_side
        else df.materialize()
    )
    blocks = [b for b in mat.blocks if b is not None]
    counts = [c for b, c in zip(mat.blocks, mat.counts) if b is not None]
    if storage_level == "DISK_ONLY" and not executor_side:
        # no live executor pool: migrate through the driver to its spill dir
        from raydp_tpu_torch.store import object_store as store

        migrated = []
        for ref in blocks:
            data = bytes(store.get_buffer(ref).memoryview())
            migrated.append(store.put(data, storage="disk"))
        store.delete(blocks)
        blocks = migrated
    ds = Dataset(
        blocks,
        mat.schema,
        counts,
        session=df._session,
        recover_plan=plan_snapshot,
    )
    if _use_owner:
        ds.transfer_to_master()
    return ds
