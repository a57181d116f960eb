"""Windowed time-series over the metrics registry: the port's copy of
the process-local half of ``raydp_tpu/obs/timeseries.py``.

A :class:`SeriesStore` turns successive cumulative registry snapshots into
bounded per-``(metric, labels)`` point rings:

- **counters** keep their cumulative value per point (the Prometheus
  convention; ``windowed()`` computes the delta over a window),
- **gauges** keep the sampled value (and a ``<name>.max`` series for the
  memory plane's watermark gauges),
- **histograms** fan out into ``<name>.count`` / ``<name>.sum``
  (cumulative) plus ``<name>.p50`` / ``<name>.p99`` / ``<name>.max`` gauge
  series from the reservoir snapshot.

Labels come from the metric name and the process: ``tenant.<ns>.<metric>``
series normalize to name ``tenant.<metric>`` with a ``tenant="<ns>"`` label
(:func:`split_labels`), and every series carries ``role`` and ``proc``
(``role:pid``). ``prometheus_text`` renders the newest points in the text
exposition format and :func:`parse_prometheus_text` reads it back.

The **process-local mirror** (``local_store``) is fed by this process's own
``tracing.flush()``; ``query_local`` / ``windowed_local`` read it. The head's
store and its scrape endpoint (``ScrapeServer``, ``scrape``) wait for the
port's cluster runtime.

Stdlib only.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# points kept per series: at the ~1s flush cadence this is ~10 minutes of
# history — enough for any windowed controller read or scrape, bounded
# regardless of how chatty the cluster is
DEFAULT_POINTS_CAP = 600

# a process flushing faster than this (executors flush per dispatch) does
# not grow the rings faster: extra snapshots within the interval are folded
# into the latest point instead of appended
MIN_POINT_INTERVAL_S = 0.25

# series whose newest point is older than this are dropped (swept
# opportunistically during ingest): a long-lived cluster with executor /
# replica / tenant churn mints new per-proc label sets continuously, and
# without retention the store — and every scrape response — would grow
# monotonically with each dead pid
SERIES_RETENTION_S = 900.0
_RETENTION_SWEEP_EVERY = 256  # ingests between sweeps


def split_labels(name: str, role: str, proc_key: str) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """(series name, sorted label items) for one raw metric name.

    ``tenant.<ns>.<metric>`` becomes (``tenant.<metric>``,
    ``tenant=<ns>``); every series carries ``role`` (the class part of the
    process role — ``worker:actor-ab12`` ships as role ``worker``) and
    ``proc`` (the full ``role:pid`` key, the per-process axis)."""
    labels = {"role": role.split(":", 1)[0] or "proc", "proc": proc_key}
    if name.startswith("tenant.") and name.count(".") >= 2:
        _, ns, rest = name.split(".", 2)
        if rest and ns != "":
            name = f"tenant.{rest}"
            labels["tenant"] = ns
    return name, tuple(sorted(labels.items()))


class _Series:
    __slots__ = ("name", "labels", "kind", "points")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, cap: int):
        self.name = name
        self.labels = labels
        self.kind = kind  # "counter" | "gauge"
        self.points: collections.deque = collections.deque(maxlen=cap)

    def add(self, ts: float, value: float, fold: bool) -> None:
        if self.kind == "counter" and self.points and value < self.points[-1][1]:
            # counters are monotone by construction, so a LOWER incoming
            # value is a stale snapshot that lost the ingest race (two
            # flushes from one process interleaving after the RPC) — drop
            # it rather than write a non-monotone point that would corrupt
            # windowed deltas; a genuine registry reset self-heals once the
            # counter catches back up
            return
        if fold and self.points and ts - self.points[-1][0] < MIN_POINT_INTERVAL_S:
            self.points[-1] = (self.points[-1][0], value)
        else:
            self.points.append((ts, value))


class SeriesStore:
    """Bounded ring TSDB keyed ``(metric, labels)``; see module docstring."""

    def __init__(self, points_cap: int = DEFAULT_POINTS_CAP):
        self._lock = threading.Lock()
        self._cap = int(points_cap)
        self._series: Dict[Tuple[str, tuple], _Series] = {}  # guarded-by: self._lock
        self._ingests = 0

    # -- write side ------------------------------------------------------

    def ingest(self, proc_key: str, role: str, snapshot: Dict[str, dict],
               ts: Optional[float] = None) -> None:
        """Fold one process's cumulative registry snapshot into the rings.
        Cheap: one dict walk; histogram snapshots fan out into 4 scalar
        series. Thread-safe (flush paths from any thread may land here)."""
        if not snapshot:
            return
        ts = time.time() if ts is None else ts
        flat: List[Tuple[str, str, float]] = []
        for raw_name, snap in snapshot.items():
            kind = snap.get("type")
            if kind == "counter":
                flat.append((raw_name, "counter", float(snap.get("value", 0.0))))
            elif kind == "gauge":
                flat.append((raw_name, "gauge", float(snap.get("value", 0.0))))
                if snap.get("max") is not None:
                    # high-watermark gauges (memory plane) fan a .max peak
                    # series out alongside the live value
                    flat.append((f"{raw_name}.max", "gauge",
                                 float(snap["max"])))
            elif kind == "histogram":
                flat.append((f"{raw_name}.count", "counter",
                             float(snap.get("count", 0))))
                flat.append((f"{raw_name}.sum", "counter",
                             float(snap.get("sum", 0.0))))
                # max is the watermark axis (per-step H2D spikes, memory
                # highs): a gauge series like the quantiles
                for q in ("p50", "p99", "max"):
                    if snap.get(q) is not None:
                        flat.append((f"{raw_name}.{q}", "gauge",
                                     float(snap[q])))
        with self._lock:
            self._ingests += 1
            for raw_name, kind, value in flat:
                name, labels = split_labels(raw_name, role, proc_key)
                key = (name, labels)
                series = self._series.get(key)
                if series is None:
                    series = self._series[key] = _Series(
                        name, labels, kind, self._cap
                    )
                series.add(ts, value, fold=True)
            if self._ingests % _RETENTION_SWEEP_EVERY == 0:
                cutoff = ts - SERIES_RETENTION_S
                for key in [
                    k for k, s in self._series.items()
                    if not s.points or s.points[-1][0] < cutoff
                ]:
                    del self._series[key]

    # -- read side -------------------------------------------------------

    def query(self, name: str, window_s: float = 60.0,
              labels: Optional[Dict[str, str]] = None) -> List[dict]:
        """Every series matching ``name`` (and the label filter), with its
        points clipped to the trailing window plus derived values: ``last``
        (newest point), and for counters ``delta`` (increase over the
        window — the rate numerator controllers want)."""
        cutoff = time.time() - float(window_s)
        out: List[dict] = []
        with self._lock:
            # points are copied UNDER the lock: a concurrent ingest appending
            # to a deque mid-iteration would raise (and lose the read)
            matches = [
                (s, list(s.points))
                for (n, _), s in self._series.items() if n == name
            ]
        for series, points in matches:
            lab = dict(series.labels)
            if labels and any(lab.get(k) != v for k, v in labels.items()):
                continue
            pts = [(ts, v) for ts, v in points if ts >= cutoff]
            if not pts:
                continue
            entry = {
                "name": series.name,
                "labels": lab,
                "type": series.kind,
                "points": pts,
                "last": pts[-1][1],
            }
            if series.kind == "counter":
                entry["delta"] = pts[-1][1] - pts[0][1]
            out.append(entry)
        return out

    def windowed(self, name: str, window_s: float = 60.0,
                 labels: Optional[Dict[str, str]] = None) -> dict:
        """One aggregate across all matching series: ``delta`` summed for
        counters, ``last`` summed and ``max`` over per-series maxima for
        gauges — the single-number read a controller wants."""
        series = self.query(name, window_s, labels)
        agg = {"series": len(series), "delta": 0.0, "last": 0.0, "max": None}
        for entry in series:
            agg["delta"] += entry.get("delta", 0.0)
            agg["last"] += entry["last"]
            peak = max(v for _, v in entry["points"])
            agg["max"] = peak if agg["max"] is None else max(agg["max"], peak)
        return agg

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({n for (n, _) in self._series})

    # -- Prometheus exposition ------------------------------------------

    def prometheus_text(self) -> str:
        """The newest point of every series in the Prometheus text
        exposition format (one scrape = the cluster's live state). Series
        names are prefixed ``raydp_`` with dots mapped to underscores;
        counters get the conventional ``_total`` suffix."""
        with self._lock:
            series = [
                (s, s.points[-1]) for s in self._series.values() if s.points
            ]
        lines: List[str] = []
        seen_types: set = set()
        for s, newest in sorted(series, key=lambda e: (e[0].name, e[0].labels)):
            prom = "raydp_" + _prom_name(s.name)
            if s.kind == "counter":
                prom += "_total"
            if prom not in seen_types:
                seen_types.add(prom)
                lines.append(f"# TYPE {prom} {s.kind}")
            label_str = ",".join(
                f'{_prom_name(k)}="{_prom_escape(v)}"' for k, v in s.labels
            )
            ts, value = newest
            lines.append(
                f"{prom}{{{label_str}}} {value:.10g} {int(ts * 1000)}"
            )
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return "".join(
        ch if (ch.isalnum() or ch == "_") else "_" for ch in name
    )


def _prom_escape(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def parse_prometheus_text(text: str) -> Dict[str, Dict[tuple, float]]:
    """Parse the exposition format back into
    ``{metric: {sorted-label-items: value}}`` — the test/tooling half of the
    round trip (scrape → parse → compare against ``dump_metrics``)."""
    out: Dict[str, Dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            label_str, tail = rest.split("}", 1)
            labels = {}
            for part in _split_labels_text(label_str):
                if not part:
                    continue
                k, v = part.split("=", 1)
                labels[k] = v.strip('"').replace('\\"', '"').replace("\\\\", "\\")
            fields = tail.split()
        else:
            fields = line.split()
            name = fields[0]
            fields = fields[1:]
            labels = {}
        if not fields:
            continue
        out.setdefault(name, {})[tuple(sorted(labels.items()))] = float(fields[0])
    return out


def _split_labels_text(label_str: str) -> List[str]:
    parts, depth_quote, cur = [], False, []
    for ch in label_str:
        if ch == '"' and (not cur or cur[-1] != "\\"):
            depth_quote = not depth_quote
        if ch == "," and not depth_quote:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


# ---------------------------------------------------------------------------
# process-local mirror: the in-process consumers' windowed view
# ---------------------------------------------------------------------------

# fed by tracing.flush() with this process's own snapshot: in-process
# readers (the decode engine's memory-pressure veto through
# profiler.current_mem_pressure) get a windowed signal without a head
local_store = SeriesStore()


def ingest_local(snapshot: Dict[str, dict]) -> None:
    import os

    from raydp_tpu_torch.obs.tracing import process_role

    role = process_role()
    local_store.ingest(f"{role}:{os.getpid()}", role, snapshot)


def query_local(name: str, window_s: float = 60.0,
                labels: Optional[Dict[str, str]] = None) -> List[dict]:
    return local_store.query(name, window_s, labels)


def windowed_local(name: str, window_s: float = 60.0,
                   labels: Optional[Dict[str, str]] = None) -> dict:
    return local_store.windowed(name, window_s, labels)
