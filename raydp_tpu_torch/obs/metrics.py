"""Process-local metrics registry: counters, gauges, histograms -- the
port's copy of ``raydp_tpu/obs/metrics.py``.

Always on (the instruments are dict updates, far cheaper than any call site
they sit in). Each process accumulates locally; the port has no cluster
head yet, so a snapshot is read in the process (``metrics.snapshot()``).

Metric names are dotted strings; docs/observability.md has the table of
the names the runtime emits (the estimator's ``estimator.*`` names are the
same in the port).
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-set value, with an OPT-IN high-watermark mode: call
    ``set_watermark`` instead of ``set`` and the snapshot additionally
    carries ``max`` — the peak ever set — which the time-series layer fans
    out as a ``<name>.max`` series (the memory plane's watermark gauges).
    Plain ``set`` leaves the snapshot byte-identical to the old shape."""

    __slots__ = ("value", "_max")

    def __init__(self):
        self.value = 0.0
        self._max = None  # armed by the first set_watermark

    def set(self, value: float) -> None:
        self.value = float(value)

    def set_watermark(self, value: float) -> None:
        value = float(value)
        self.value = value
        if self._max is None or value > self._max:
            self._max = value

    def snapshot(self):
        if self._max is None:
            return {"type": "gauge", "value": self.value}
        return {"type": "gauge", "value": self.value, "max": self._max}


class Histogram:
    """count/sum/min/max summary plus bounded-reservoir quantiles.

    The summary fields answer "how many, how much, how bad" without
    per-observation storage; p50/p99 come from a fixed-size uniform
    reservoir (algorithm R) so SLO gauges — the serving plane's latency
    histograms foremost — get tail shape in O(1) memory. The reservoir is
    OFF until the first ``observe`` (no allocation for the many histograms
    that exist only so dump_metrics carries their keys), and the pre-existing
    snapshot fields are unchanged for old readers — ``p50``/``p99`` are
    purely additive keys."""

    __slots__ = ("count", "sum", "min", "max", "_reservoir")

    RESERVOIR_SIZE = 512

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._reservoir = None  # allocated on first observe

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        reservoir = self._reservoir
        if reservoir is None:
            reservoir = self._reservoir = []
        if len(reservoir) < self.RESERVOIR_SIZE:
            reservoir.append(value)
        else:
            # uniform replacement keeps every past observation equally
            # likely to be resident; like the other instruments this is
            # lock-free — a racing observe's worst case is one lost sample
            slot = random.randrange(self.count)
            if slot < self.RESERVOIR_SIZE:
                reservoir[slot] = value

    def quantile(self, q: float):
        """Nearest-rank quantile over the resident reservoir (exact while
        count <= RESERVOIR_SIZE, a uniform-sample estimate beyond). None
        before the first observation."""
        reservoir = self._reservoir
        if not reservoir:
            return None
        ordered = sorted(reservoir)
        rank = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[rank]

    def snapshot(self):
        if not self.count:
            return {"type": "histogram", "count": 0, "sum": 0.0}
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


class Registry:
    """The per-process registry. Instruments are created on first use and
    live for the process; lookups are one dict hit under a lock (creation
    only — the instrument methods themselves are lock-free, fine for
    float-add races whose worst case is a lost increment)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(name, cls())
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(inst).__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


metrics = Registry()
