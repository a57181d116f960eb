"""``ArrayDataset``: the port's training data source until it has its store.

The JAX package trains from ``raydp_tpu.exchange.dataset.Dataset``, Arrow
blocks in the cluster's object store. The port has no store, cluster or ETL
engine yet, so it stages from numpy through this stand-in, which keeps what
the estimator calls of ``Dataset``:

- the two staging methods (``to_numpy`` and ``to_numpy_grouped``, with the
  same signatures) and the staging rules of ``_table_to_numpy_grouped``: an
  integer target refuses non-finite floats and ids outside its range, with
  the same messages;
- blocks (``num_blocks``, ``counts``, ``get_block``), the unit a streamed
  fit reads, and ``iter_batches(streaming=True)``'s batch order
  (``StreamingBatchIterator``): blocks in ``default_rng(seed)`` order, the
  rows of each block permuted by the same generator, a carryover joining
  rows across block boundaries; ``streaming_shard_plan`` restricts a pass to
  one rank's rows. A block here is a row range of the columns, returned as
  numpy views, so nothing is decoded.

Executor-side decode (``stream_executor_decode``) waits for the ETL slice.
The real ``Dataset`` replaces this class when the store is ported.
"""

from __future__ import annotations

import uuid
from typing import Any, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np


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
        self.uuid = uuid.uuid4().hex

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
    ) -> Iterator[Tuple[Any, Optional[np.ndarray]]]:
        """Batches of (features, labels) in ``StreamingBatchIterator``'s
        order, block by block: host memory holds one block and a carryover
        of less than a batch. ``feature_groups`` (overrides
        ``feature_columns``/``feature_dtype``) yields a tuple of matrices,
        one per ``(columns, dtype)`` group. ``block_plan`` restricts the
        pass to ``(block, start, stop)`` spans (``streaming_shard_plan``).
        This is ``iter_batches(streaming=True)``'s order; the staged order
        of ``streaming=False`` is the estimator's own (``_HostArrays``)."""
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
        past float32's exact-integer range)."""
        features = tuple(
            np.stack([self._col(c, dtype) for c in cols], axis=1).astype(dtype)
            for cols, dtype in feature_groups
        )
        labels = None
        if label_column is not None:
            labels = self.columns[label_column].astype(label_dtype)
        return features, labels

    def _col(self, c: str, dtype) -> np.ndarray:
        arr = self.columns[c]
        target = np.dtype(dtype)
        if np.issubdtype(target, np.integer):
            if np.issubdtype(arr.dtype, np.floating):
                # a silent astype would turn NaN (or inf) into INT_MIN and
                # gather-clamp every such row onto embedding 0
                if not np.isfinite(arr).all():
                    raise ValueError(
                        f"column {c!r} contains nulls or non-finite values "
                        f"and cannot stage as {target}; fill or drop them "
                        "in ETL first"
                    )
            if arr.size and np.issubdtype(arr.dtype, np.integer):
                info = np.iinfo(target)
                lo, hi = arr.min(), arr.max()
                # astype wraps out-of-range ids negative: demand a wider dtype
                if lo < info.min or hi > info.max:
                    raise ValueError(
                        f"column {c!r} has ids outside {target} range "
                        f"[{info.min}, {info.max}]; use a wider "
                        "categorical_dtype (e.g. np.int64)"
                    )
        return arr


def streaming_shard_plan(
    counts: Sequence[int], num_shards: int, rank: int
) -> List[Tuple[int, int, int]]:
    """Block-level plan for one rank's equal-rows shard: ``(block_index,
    start_row, stop_row)`` spans covering the contiguous global row
    interval ``[rank*per, (rank+1)*per)`` with wraparound oversampling
    (``per = ceil(total/num_shards)``), so every rank streams the same
    number of rows and nothing is materialized."""
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
