"""Shared utilities: the port's copy of ``raydp_tpu/utils.py``.

Memory-size parsing, ``random_split`` of an ETL DataFrame, and
``divide_blocks``' block-to-rank partitioning with oversampling: blocks are
Arrow record batches feeding one rank each, and the partitioner's invariant
(every rank sees exactly the same number of samples, by oversampling rather
than dropping) keeps ranks that step together from waiting on ragged final
batches.
"""

from __future__ import annotations

import atexit
import math
import re
import signal
from typing import Dict, List, Sequence, Tuple

import numpy as np

_MEMORY_UNITS = {
    "": 1,
    "K": 1 << 10,
    "M": 1 << 20,
    "G": 1 << 30,
    "T": 1 << 40,
    "P": 1 << 50,
}

_MEMORY_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([KMGTP]?)I?B?\s*$", re.IGNORECASE)


def parse_memory_size(memory_size) -> int:
    """Parse a human-readable memory size ("500M", "2GB", "1.5g", 1024) to bytes."""
    if isinstance(memory_size, (int, float)) and not isinstance(memory_size, bool):
        return int(memory_size)
    match = _MEMORY_RE.match(str(memory_size))
    if not match:
        raise ValueError(f"cannot parse memory size: {memory_size!r}")
    number, unit = match.groups()
    return int(float(number) * _MEMORY_UNITS[unit.upper()])


def memory_size_string(num_bytes: int) -> str:
    """Exact inverse of :func:`parse_memory_size`, for logs and config echo."""
    num_bytes = int(num_bytes)
    for unit in ("P", "T", "G", "M", "K"):
        size = _MEMORY_UNITS[unit]
        if num_bytes >= size and num_bytes % size == 0:
            return f"{num_bytes // size}{unit}B"
    return str(num_bytes)


def register_exit_handler(func) -> None:
    """Run ``func`` once at interpreter exit or on SIGTERM/SIGINT (reference utils.py:61-64)."""
    done = False

    def _once():
        nonlocal done
        if not done:
            done = True
            func()

    atexit.register(_once)

    def _handler(signum, frame):  # noqa: ARG001 - signal signature
        _once()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)


def normalize_weights(weights: Sequence[float]) -> List[float]:
    weights = [float(w) for w in weights]
    if any(w < 0 for w in weights) or sum(weights) <= 0:
        raise ValueError(f"weights must be non-negative and sum > 0: {weights}")
    total = sum(weights)
    return [w / total for w in weights]


def random_split(df, weights: Sequence[float], seed: int | None = None):
    """Randomly split an ETL DataFrame by normalized ``weights``.

    Parity: reference ``random_split`` (utils.py:67-83) delegating to Spark's
    ``randomSplit``; here the DataFrame engine implements the split natively.
    """
    from raydp_tpu_torch.etl.dataframe import DataFrame  # local import: keep utils light

    if not isinstance(df, DataFrame):
        raise TypeError(
            f"random_split expects a raydp_tpu_torch DataFrame, got {type(df).__name__}"
        )
    return df.random_split(weights, seed=seed)


def df_type_check(df) -> bool:
    """True if ``df`` is an ETL DataFrame this framework can train from."""
    from raydp_tpu_torch.etl.dataframe import DataFrame

    if isinstance(df, DataFrame):
        return True
    raise TypeError(
        f"type {type(df)} is not supported; expected raydp_tpu_torch.etl.DataFrame"
    )


# Each (block, offset) pair is packed into one int64: the low 32 bits address a
# row within a block, matching the reference's BLOCK_SIZE_BIT=32 (utils.py:31).
BLOCK_SIZE_BIT = 32
_BLOCK_OFFSET_MASK = (1 << BLOCK_SIZE_BIT) - 1


def pack_index(block_index: int, row_offset: int) -> int:
    return (block_index << BLOCK_SIZE_BIT) | row_offset


def unpack_index(packed: int) -> Tuple[int, int]:
    return packed >> BLOCK_SIZE_BIT, packed & _BLOCK_OFFSET_MASK


def divide_blocks(
    blocks: Sequence[int],
    world_size: int,
    shuffle: bool = False,
    shuffle_seed: int | None = None,
) -> Dict[int, List[Tuple[int, int]]]:
    """Assign data blocks to ranks so every rank gets the same sample count.

    ``blocks`` holds the row count of each block. Returns ``{rank: [(block_index,
    rows_to_take), ...]}`` where ``sum(rows_to_take)`` is identical for every
    rank, so a global batch split over the ranks always has a static per-rank
    shape. A rank reads a *prefix* of each assigned block; ranks
    that come up short top up by re-reading prefixes of randomly chosen blocks
    (oversampling). As in the reference, the tail of the block that straddles a
    rank's quota boundary is not read during that epoch — pass ``shuffle=True``
    with a fresh ``shuffle_seed`` per epoch to vary which rows those are.

    Capability parity: reference ``divide_blocks`` (utils.py:149-222) — blocks
    are striped round-robin across ranks after optional shuffle, short ranks top
    up from random blocks.
    """
    blocks = list(blocks)
    if len(blocks) < world_size:
        raise ValueError(
            f"not enough blocks ({len(blocks)}) to divide over world_size={world_size}"
        )
    if any(b <= 0 for b in blocks):
        raise ValueError("every block must contain at least one row")

    num_blocks_per_rank = math.ceil(len(blocks) / world_size)
    samples_per_rank = math.ceil(sum(blocks) / world_size)
    total_slots = num_blocks_per_rank * world_size

    # Pad the index list cyclically so striping is even, then stripe.
    order = list(range(len(blocks)))
    order += order[: total_slots - len(order)]
    # unseeded shuffle must actually vary between calls (epochs)
    rng = np.random.default_rng(shuffle_seed)
    if shuffle:
        rng.shuffle(order)

    results: Dict[int, List[Tuple[int, int]]] = {}
    for rank in range(world_size):
        assigned = order[rank:total_slots:world_size]
        taken = 0
        selected: List[Tuple[int, int]] = []

        def take(block_index: int) -> None:
            nonlocal taken
            want = min(blocks[block_index], samples_per_rank - taken)
            if want > 0:
                selected.append((block_index, want))
                taken += want

        for block_index in assigned:
            take(block_index)
            if taken == samples_per_rank:
                break
        while taken < samples_per_rank:  # top up by oversampling random blocks
            take(int(rng.choice(order)))

        results[rank] = selected
    return results


def expand_block_selection(
    selection: List[Tuple[int, int]], blocks: Sequence[int]
) -> np.ndarray:
    """Expand a rank's ``divide_blocks`` selection into packed (block, row) indices."""
    out = []
    for block_index, count in selection:
        if count > blocks[block_index]:
            raise ValueError(
                f"selection takes {count} rows from block {block_index} "
                f"of size {blocks[block_index]}"
            )
        rows = np.arange(count, dtype=np.int64)
        out.append((np.int64(block_index) << BLOCK_SIZE_BIT) | rows)
    return np.concatenate(out) if out else np.empty(0, dtype=np.int64)
