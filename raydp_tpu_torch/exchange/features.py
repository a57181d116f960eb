"""The feature-container convention: the port's copy of
``raydp_tpu/exchange/features.py``, for staging, the estimator and the
serving plane's batch assembly.

Features are either ONE array or a TUPLE of arrays (the mixed-dtype path,
e.g. DLRM's (dense float32, ids int32)). These helpers give code that
handles either form one shape, for numpy arrays and tensors alike.
"""

from __future__ import annotations

import numpy as np


def fmap(fn, x):
    """Apply ``fn`` to each feature part (identity structure for one array)."""
    if isinstance(x, tuple):
        return tuple(fn(a) for a in x)
    return fn(x)


def f0(x):
    """The first (or only) feature part -- for len/shape bookkeeping."""
    return x[0] if isinstance(x, tuple) else x


def f_nbytes(x) -> int:
    if isinstance(x, tuple):
        return sum(a.nbytes for a in x)
    return x.nbytes


def f_stack(items):
    """np.stack over per-step feature batches (arrays or tuples of arrays)."""
    if items and isinstance(items[0], tuple):
        return tuple(
            np.stack([it[i] for it in items]) for i in range(len(items[0]))
        )
    return np.stack(items)


# ---------------------------------------------------------------------------
# batch assembly (the serving plane's admission queue -> replica dispatch):
# per-request feature rows concatenate into one batch, pad to a bucket so a
# replica runs few shapes, and split back per request. One implementation
# here so the batcher, the replica and the tests can never disagree about
# row accounting.
# ---------------------------------------------------------------------------


def f_rows(x) -> int:
    """Row count of a feature batch (first axis of the first part)."""
    return int(len(f0(x)))


def f_concat(items):
    """np.concatenate over per-request feature batches along axis 0 (arrays
    or tuples of arrays -- every item must share the container structure)."""
    if not items:
        raise ValueError("f_concat needs at least one feature batch")
    if isinstance(items[0], tuple):
        return tuple(
            np.concatenate([it[i] for it in items]) for i in range(len(items[0]))
        )
    return np.concatenate(items)


def f_slice(x, start: int, stop: int):
    """Row slice [start:stop) of a feature batch (per part)."""
    return fmap(lambda a: a[start:stop], x)


def pad_rows(x, bucket: int):
    """Pad a feature batch up to ``bucket`` rows by REPEATING the last valid
    row (always in-domain -- zero-fill would hand embedding models synthetic
    ids and can denormal-stall float paths). Returns the padded batch; the
    caller tracks the valid row count and slices responses back."""
    n = f_rows(x)
    if n > bucket:
        raise ValueError(f"batch of {n} rows exceeds bucket {bucket}")
    if n == bucket:
        return x
    return fmap(
        lambda a: np.concatenate(
            [a, np.repeat(a[-1:], bucket - n, axis=0)]
        ),
        x,
    )


def as_feature_rows(obj, feature_columns=None, feature_dtype=np.float32):
    """Normalize a serving request's payload into the feature-container
    convention: a 1-D numpy row becomes a (1, F) batch, 2-D arrays and
    tuples-of-arrays pass through, and an Arrow table / pandas frame is
    assembled column-wise via ``feature_columns`` (required for tabular
    input). Tabular payloads are recognised by their attributes, so neither
    pyarrow nor pandas is imported here. Always returns an array or tuple
    with a leading row axis."""
    if isinstance(obj, tuple):
        return tuple(np.atleast_2d(np.asarray(a)) for a in obj)
    if isinstance(obj, np.ndarray):
        return obj[None, :] if obj.ndim == 1 else obj
    # tabular payloads: Arrow table or pandas frame
    to_pandas = getattr(obj, "to_pandas", None)
    if to_pandas is not None and type(obj).__module__.startswith("pyarrow"):
        obj = to_pandas()
    if hasattr(obj, "columns") and hasattr(obj, "__getitem__"):
        if feature_columns is None:
            raise ValueError(
                "tabular serving payloads need feature_columns to fix the "
                "column order"
            )
        return np.stack(
            [np.asarray(obj[c], dtype=feature_dtype) for c in feature_columns],
            axis=1,
        )
    return np.atleast_2d(np.asarray(obj, dtype=feature_dtype))
