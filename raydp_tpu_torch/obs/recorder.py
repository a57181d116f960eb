"""Flight recorder: the port's copy of ``raydp_tpu/obs/recorder.py``.

- **Process half** (always on, near-free): a bounded ring of recent
  structured-log records. ``obs.logging`` calls :func:`note_log` for every
  line (one deque append), and the decode engine writes its
  ``serve.decode.state`` note there about once a second. ``recent_logs``
  reads the ring, ``drain_logs`` / ``requeue_logs`` take records out and put
  them back, as a flush that ships them would.
- **Recorder half** (:class:`FlightRecorder`): per-process rings of the
  last N spans, the last N log records and a ~10 s tail of metrics
  snapshots, fed by :meth:`FlightRecorder.note_ingest`, and the **crash
  dossier** :meth:`~FlightRecorder.assemble` builds from them: the victims'
  rings, the caller's state, and a ``decode`` section lifted from each
  ring's newest ``serve.decode.state`` note and ``serve.decode.*`` /
  ``serve.kv.*`` gauges (``_decode_sections``). :meth:`~FlightRecorder.write`
  serializes one, :func:`list_dossiers` lists them. In the JAX package the
  head feeds the recorder from every process's flush and assembles a
  dossier on a death event; the port has no head yet, so a caller feeds it
  from this process's own rings (``recent_logs()``, ``metrics.snapshot()``).
  Wiring a death event to a dossier, and the lock-order graph of the JAX
  package's sanitizer, wait for the cluster runtime.

Stdlib only.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

DOSSIER_DIR_ENV = "RAYDP_TPU_DOSSIER_DIR"

# per-process head-side ring capacities: small enough that hundreds of
# processes stay cheap, large enough to hold a victim's last dispatches
SPAN_RING = 512
LOG_RING = 256
METRICS_TAIL_S = 10.0
METRICS_TAIL_CAP = 32

MAX_DOSSIER_FILES = 32

# head-side rings for processes not heard from in this long are dropped
# (swept during note_ingest): actor churn on a long-lived cluster must not
# grow recorder memory without bound. Generous vs the seconds between a
# victim's last flush and its death event — dossier assembly always finds
# a fresh victim's rings.
PROC_RETENTION_S = 600.0
_RETENTION_SWEEP_EVERY = 128

# ---------------------------------------------------------------------------
# process half: recent-log ring, shipped with each flush
# ---------------------------------------------------------------------------

_log_ring: "collections.deque" = collections.deque(maxlen=LOG_RING)
# plain (never instrumented) lock: note_log sits under obs.logging, which
# error paths call with arbitrary other locks held — this must stay a
# self-contained leaf that only ever guards the deque
_log_lock = threading.Lock()


def note_log(level: str, role: str, message: str, fields: Dict[str, Any]) -> None:
    """Record one structured-log line in the process flight ring (called by
    ``obs.logging`` on every emit; one short lock acquire per line — log
    lines are rare next to spans/metrics)."""
    record = {
        "ts": time.time(),
        "level": level,
        "role": role,
        "message": message,
        "fields": {k: repr(v)[:200] for k, v in fields.items()},
    }
    with _log_lock:
        _log_ring.append(record)


def drain_logs() -> List[dict]:
    """Remove and return the recent-log ring (the flush ship point); records
    shipped once live on in the HEAD's per-process ring."""
    with _log_lock:
        out = list(_log_ring)
        _log_ring.clear()
    return out


def recent_logs() -> List[dict]:
    with _log_lock:
        return list(_log_ring)


def requeue_logs(logs: List[dict]) -> None:
    """Put drained log records back UNDER anything logged since the drain
    (a failed flush must not lose the ring) — newest-biased like the span
    re-buffer, bounded by the ring's own capacity. Atomic under the ring
    lock: lines logged DURING the failed flush (likely describing the very
    incident) must not be clobbered by the requeue."""
    if not logs:
        return
    with _log_lock:
        combined = logs + list(_log_ring)
        _log_ring.clear()
        _log_ring.extend(combined[-(_log_ring.maxlen or 1):])


# ---------------------------------------------------------------------------
# head half: per-process rings + dossier assembly
# ---------------------------------------------------------------------------


class _ProcFlight:
    __slots__ = ("role", "spans", "logs", "metrics_tail", "last_seen")

    def __init__(self, role: str):
        self.role = role
        self.spans: collections.deque = collections.deque(maxlen=SPAN_RING)
        self.logs: collections.deque = collections.deque(maxlen=LOG_RING)
        # (ts, cumulative snapshot) — pruned to the trailing tail window
        self.metrics_tail: collections.deque = collections.deque(
            maxlen=METRICS_TAIL_CAP
        )
        self.last_seen = 0.0


class FlightRecorder:
    """Head-side recorder; fed from ``handle_obs_ingest``, read by dossier
    assembly. Its lock is a LEAF: taken briefly for ring updates/snapshots,
    never around I/O or another lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._procs: Dict[str, _ProcFlight] = {}  # guarded-by: self._lock
        self._dossiers_written = 0  # guarded-by: self._lock
        self._ingests = 0  # guarded-by: self._lock

    def note_ingest(self, proc_key: str, role: str, spans: List[dict],
                    snapshot: Optional[dict], logs: Optional[List[dict]],
                    ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            flight = self._procs.get(proc_key)
            if flight is None:
                flight = self._procs[proc_key] = _ProcFlight(role)
            flight.last_seen = ts
            if spans:
                flight.spans.extend(spans)
            if logs:
                flight.logs.extend(logs)
            if snapshot:
                flight.metrics_tail.append((ts, snapshot))
                while (
                    flight.metrics_tail
                    and ts - flight.metrics_tail[0][0] > METRICS_TAIL_S
                ):
                    flight.metrics_tail.popleft()
            self._ingests += 1
            if self._ingests % _RETENTION_SWEEP_EVERY == 0:
                cutoff = ts - PROC_RETENTION_S
                for key in [
                    k for k, f in self._procs.items() if f.last_seen < cutoff
                ]:
                    del self._procs[key]

    def proc_keys(self) -> List[str]:
        with self._lock:
            return list(self._procs)

    def _snapshot_proc(self, proc_key: str) -> Optional[dict]:
        with self._lock:
            flight = self._procs.get(proc_key)
            if flight is None:
                return None
            return {
                "proc": proc_key,
                "role": flight.role,
                "last_seen": flight.last_seen,
                "spans": list(flight.spans),
                "logs": list(flight.logs),
                "metrics_tail": [
                    {"ts": ts, "metrics": snap}
                    for ts, snap in flight.metrics_tail
                ],
            }

    # -- dossiers --------------------------------------------------------

    def assemble(self, reason: str, victim_keys: Optional[List[str]] = None,
                 victim: Optional[dict] = None,
                 head_state: Optional[dict] = None) -> dict:
        """Build the dossier dict. ``head_state`` (actor table, tenant
        accounting, ...) is collected by the caller; this method only reads
        the flight rings."""
        rings = []
        for key in victim_keys or []:
            snap = self._snapshot_proc(key)
            if snap is not None:
                rings.append(snap)
        dossier = {
            "format": "raydp-crash-dossier-v1",
            "reason": reason,
            "ts": time.time(),
            "victim": victim or {},
            "victim_rings": rings,
            "head": head_state or {},
            "known_procs": self.proc_keys(),
        }
        decode = _decode_sections(rings)
        if decode:
            dossier["decode"] = decode
        return dossier

    def write(self, dossier: dict, out_dir: str) -> Optional[str]:
        """Serialize one dossier to ``out_dir`` (created on demand), pruning
        to the :data:`MAX_DOSSIER_FILES` newest PER REASON — routine
        intentional kills (scale-in churn, session stops) must never evict
        a genuine crash's evidence, which is the whole point of the
        recorder. Best-effort by design: a full disk must not take the head
        down with the actor."""
        try:
            os.makedirs(out_dir, exist_ok=True)
            with self._lock:
                # locked, so concurrent dossier writers (several deaths in
                # one event) get distinct sequence numbers — a same-second
                # filename collision would os.replace one victim's evidence
                # away silently
                self._dossiers_written += 1
                seq = self._dossiers_written
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            reason_slug = _slug(dossier.get("reason", "event"))
            name = f"dossier-{stamp}-{seq:04d}-{reason_slug}.json"
            path = os.path.join(out_dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dossier, f, indent=1, default=str)
            os.replace(tmp, path)
            existing = sorted(
                entry for entry in os.listdir(out_dir)
                if entry.startswith("dossier-")
                and entry.endswith(f"-{reason_slug}.json")
            )
            for stale in existing[:-MAX_DOSSIER_FILES]:
                try:
                    os.unlink(os.path.join(out_dir, stale))
                except OSError:  # a racing prune already removed it
                    pass
            return path
        except OSError:
            from raydp_tpu_torch import obs

            obs.log.warning(
                "crash dossier write failed", exc_info=True, dir=out_dir
            )
            return None


def _decode_sections(rings: List[dict]) -> List[dict]:
    """Lift each victim ring's newest decode-engine state note (the ~1/s
    ``serve.decode.state`` log the engine loop emits: in-flight streams with
    tokens emitted + KV lengths, queue depth, page-table summary) plus the
    latest ``serve.decode.*`` / ``serve.kv.*`` gauges from its metrics tail
    into a top-level ``decode`` dossier section — the first thing to read
    after a mid-decode replica death. Empty list when no ring ever decoded
    (the dossier then omits the section entirely)."""
    sections: List[dict] = []
    for ring in rings:
        state = None
        for record in reversed(ring.get("logs") or []):
            if record.get("message") == "serve.decode.state":
                state = {
                    "ts": record.get("ts"),
                    "fields": record.get("fields") or {},
                }
                break
        gauges: Dict[str, Any] = {}
        tail = ring.get("metrics_tail") or []
        if tail:
            newest = tail[-1].get("metrics") or {}
            for name, snap in newest.items():
                if name.startswith(("serve.decode.", "serve.kv.")):
                    gauges[name] = snap
        if state is not None or gauges:
            sections.append({
                "proc": ring.get("proc"),
                "role": ring.get("role"),
                "state": state,
                "metrics": gauges,
            })
    return sections


def _slug(text: str) -> str:
    return "".join(
        ch if (ch.isalnum() or ch in "-_") else "-" for ch in str(text)
    )[:48] or "event"


def list_dossiers(out_dir: str) -> List[str]:
    """Dossier files in ``out_dir``, oldest first (tooling/CI helper)."""
    try:
        return sorted(
            os.path.join(out_dir, entry) for entry in os.listdir(out_dir)
            if entry.startswith("dossier-") and entry.endswith(".json")
        )
    except OSError:
        return []
