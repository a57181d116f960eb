"""Trace and metrics export: the port's copy of ``raydp_tpu/obs/export.py``.

``export_trace(path)`` flushes this process, pulls everything the cluster
head has collected (every process ships its ring buffer there), merges this
process's local leftovers, and writes the Chrome trace-event format that
Perfetto loads directly (https://ui.perfetto.dev, open file): complete
events (``ph: "X"`` with ``ts``/``dur`` in microseconds), instant events
(``ph: "i"``) and process-name metadata events, one labelled track per
process. ``dump_metrics()`` is ``{"<role>:<pid>": {metric: snapshot}}`` for
every process that has flushed, merged with this process's live registry.

With no cluster running both read the local records alone, and the local
snapshot carries ``trace.spans_dropped`` where the full ring dropped spans
(the counter the head adds to a shipped snapshot).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List


def _gather(drain: bool = True) -> Dict[str, Any]:
    """Everything observable right now: head-aggregated spans/metrics merged
    with this process's local leftovers. ``drain=False`` (the metrics read)
    leaves unshipped spans in the local ring: a metrics read must never
    destroy trace data a later export would have written."""
    from raydp_tpu_torch.obs.metrics import metrics
    from raydp_tpu_torch.obs.tracing import (drain_local, dropped_count,
                                             flush, process_role)

    flush()  # best-effort: puts the local buffer on the head when possible
    spans: List[dict] = []
    proc_metrics: Dict[str, dict] = {}
    try:
        from raydp_tpu_torch.cluster import api as cluster_api
        from raydp_tpu_torch.cluster.common import SESSION_ENV

        if cluster_api.is_initialized() or os.environ.get(SESSION_ENV):
            dump = cluster_api.head_rpc("obs_dump", timeout=30.0)
            spans.extend(dump.get("spans", []))
            proc_metrics.update(dump.get("metrics", {}))
    except Exception:  # no cluster (or a dead head): local-only export below
        pass
    if drain:
        spans.extend(drain_local())  # anything the flush could not ship
    snapshot = metrics.snapshot()
    if dropped_count():
        snapshot["trace.spans_dropped"] = {"type": "counter",
                                           "value": dropped_count()}
    if snapshot:
        proc_metrics.setdefault(f"{process_role()}:{os.getpid()}", snapshot)
    return {"spans": spans, "metrics": proc_metrics}


def export_trace(path: str) -> str:
    """Write the Perfetto-loadable trace; returns ``path``. Every event
    carries ``ph/ts/pid/tid/name``."""
    gathered = _gather()
    events: List[dict] = []
    # display pids are synthesized per (role, os-pid) pair: two processes on
    # different hosts can share an OS pid, and worker/agent roles carry a
    # unique discriminator (actor id / node ip), so keying on the pair keeps
    # each process on its own labelled Perfetto track
    proc_track: Dict[tuple, int] = {}
    for record in gathered["spans"]:
        os_pid = int(record.get("pid", 0))
        proc = str(record.get("proc", "proc"))
        track_key = (proc, os_pid)
        if track_key not in proc_track:
            proc_track[track_key] = len(proc_track) + 1
            events.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": proc_track[track_key],
                    "tid": 0,
                    "ts": 0,
                    "args": {"name": f"{proc} (pid {os_pid})"},
                }
            )
        pid = proc_track[track_key]
        args = dict(record.get("args") or {})
        args["trace_id"] = record.get("trace")
        args["span_id"] = record.get("id")
        if record.get("parent"):
            args["parent_id"] = record["parent"]
        event = {
            "ph": record.get("ph", "X"),
            "name": str(record.get("name", "span")),
            "ts": int(record.get("ts", 0)),
            "pid": pid,
            "tid": int(record.get("tid", 0)),
            "cat": str(record.get("name", "span")).split(".", 1)[0],
            "args": args,
        }
        if event["ph"] == "X":
            event["dur"] = int(record.get("dur", 0))
        else:
            event["s"] = "p"  # process-scoped instant
        events.append(event)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"metrics": gathered["metrics"]},
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def dump_metrics() -> Dict[str, dict]:
    """Merged ``{"<role>:<pid>": {metric: snapshot}}`` across every process
    that has flushed, plus this process's live registry."""
    return _gather(drain=False)["metrics"]
