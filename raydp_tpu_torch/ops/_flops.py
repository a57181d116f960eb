"""The FLOPs the port's own kernels report while a count is armed.

A kernel launched through ``ctypes`` is not a dispatched torch op, so
``torch.utils.flop_counter.FlopCounterMode`` cannot see it. Each wrapper's
CUDA branch therefore reports the FLOPs of its launch here, and
``obs.costmodel.count_flops`` arms the tally around the step it counts and
adds what was reported. The tally is thread-local: a count covers the
launches of the thread that runs the counted step.

The conventions, the same as the bounds of ``chip_smoke.py``: 4 * D per
live (query, key) pair for the attention forward (q k^T and p v), 6 * D
for dq (s, dp and ds k) and 8 * D for dk/dv (s, dp, p^T do and ds^T q),
2 * K per output of the int8 product, 2 * D per output of the dot
interaction. A wrapper computes its FLOPs only while the tally is armed
(:func:`armed`), so an unarmed launch costs one attribute read; where the
count depends on lengths held on the card (decode's ``kv_len``), reading
them syncs the host, inside the count only.

A backward that launches kernels runs on autograd's own thread for CUDA
tensors, where this thread's tally is not armed: an autograd Function
saves :func:`current_tally` in its forward and reports its backward's
launches to it (:class:`reporting_to`), so a count of a training step sees
the backward kernels too.

This module imports nothing of ``obs``: the kernel layer reports, and obs
reads (obs -> ops, never ops -> obs).
"""

from __future__ import annotations

import threading

_tls = threading.local()


def current_tally():
    """This thread's armed tally, or None: what a Function's forward saves
    for its backward."""
    return getattr(_tls, "tally", None)


def armed() -> bool:
    """Is a count running on this thread?"""
    return current_tally() is not None


def note_flops(n: int) -> None:
    """Add the FLOPs of one launch to this thread's tally, if armed."""
    tally = current_tally()
    if tally is not None:
        tally[0] += int(n)


class reporting_to:
    """Report this thread's launches to ``tally`` (a :func:`current_tally`
    taken on another thread; None reports nothing) for the ``with``
    body."""

    def __init__(self, tally):
        self._tally = tally
        self._saved = None

    def __enter__(self):
        self._saved = current_tally()
        _tls.tally = self._tally
        return self

    def __exit__(self, *exc):
        _tls.tally = self._saved
        return False


class counting(reporting_to):
    """Arm a fresh tally on this thread for the ``with`` body; ``total``
    holds the FLOPs reported meanwhile, which an enclosing count also
    receives."""

    def __init__(self):
        super().__init__([0])

    @property
    def total(self) -> int:
        return self._tally[0]

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._saved is not None:
            self._saved[0] += self._tally[0]
        return False


def causal_pairs(t: int, tk: int, q_offset: int, k_offset: int,
                 causal: bool) -> int:
    """Live (query, key) pairs of one (batch, head) block: all ``t * tk``,
    or, causal, those with k_offset + j <= q_offset + i and j < tk."""
    if not causal:
        return t * tk
    total = 0
    # row i sees min(tk, max(0, q_offset + i - k_offset + 1)) keys: a ramp
    # clipped at 0 and tk, summed in closed form over its three parts
    lo = k_offset - q_offset  # first row with one live key is i = lo
    first = max(0, lo)
    full_from = max(first, lo + tk - 1)  # rows at or past here see all tk
    last = t  # exclusive
    ramp_end = min(full_from, last)
    if ramp_end > first:
        a = first - lo + 1
        b = ramp_end - 1 - lo + 1
        total += (a + b) * (ramp_end - first) // 2
    if last > full_from:
        total += (last - full_from) * tk
    return total


def attention_fwd_flops(bh: int, t: int, tk: int, d: int, q_offset: int,
                        k_offset: int, causal: bool) -> int:
    """One forward launch: 4 * D a live pair."""
    return 4 * d * bh * causal_pairs(t, tk, q_offset, k_offset, causal)


def attention_bwd_flops(name: str, bh: int, t: int, tk: int, d: int,
                        q_offset: int, k_offset: int, causal: bool) -> int:
    """One backward launch: 6 * D a live pair for ``flash_bwd_dq``, 8 * D
    for ``flash_bwd_dkv``."""
    per_pair = {"flash_bwd_dq": 6, "flash_bwd_dkv": 8}[name] * d
    return per_pair * bh * causal_pairs(t, tk, q_offset, k_offset, causal)


def decode_flops(heads: int, tq: int, d: int, kv_len) -> int:
    """One decode launch: 4 * D a live pair; query row r of a sequence of
    length L sits at L - tq + r and sees keys 0 .. L - tq + r."""
    pairs = 0
    for length in kv_len:
        pairs += causal_pairs(tq, int(length), int(length) - tq, 0, True)
    return 4 * d * heads * pairs


def int8_gemm_flops(n: int, m: int, k: int) -> int:
    """One int8 product launch: 2 * K an output."""
    return 2 * n * m * k
