"""The feature-container convention: the port's copy of the helpers of
``raydp_tpu/exchange/features.py`` that staging and the estimator need.

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
