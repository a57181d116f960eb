"""``ArrayDataset``: the port's training data source until it has its store.

The JAX package trains from ``raydp_tpu.exchange.dataset.Dataset``, Arrow
blocks in the cluster's object store. The port has no store, cluster or ETL
engine yet, so it stages from numpy through this stand-in, which keeps the
two staging methods the estimator calls (``to_numpy`` and
``to_numpy_grouped``, with the same signatures) and the staging rules of
``_table_to_numpy_grouped``: an integer target refuses non-finite floats
and ids outside its range, with the same messages. The real ``Dataset``
replaces it when the store is ported.
"""

from __future__ import annotations

import uuid
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np


class ArrayDataset:
    """Named columns of equal length, held as numpy arrays.

    ``uuid`` identifies the dataset, as ``Dataset.uuid`` does, so a staging
    cache keyed on it tells two datasets apart."""

    def __init__(self, columns: Mapping[str, Any]):
        self.columns = {name: np.asarray(col) for name, col in columns.items()}
        lengths = {name: len(col) for name, col in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"columns differ in length: {lengths}")
        self.uuid = uuid.uuid4().hex

    def count(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

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
