"""Trace and metrics export: the port's copy of ``raydp_tpu/obs/export.py``
over this process's own records.

``export_trace(path)`` flushes this process, takes the spans of its local
ring and writes the Chrome trace-event format that Perfetto loads
directly (https://ui.perfetto.dev, open file): complete events (``ph:
"X"`` with ``ts``/``dur`` in microseconds), instant events (``ph: "i"``)
and process-name metadata events, one labelled track per process.
``dump_metrics()`` is ``{"<role>:<pid>": {metric: snapshot}}`` for this
process, with ``trace.spans_dropped`` where the full ring dropped spans,
the counter the JAX package's head adds to a process's snapshot.

The JAX package also merges what the cluster head collected from every
process; the port has no head yet, so both read the local records alone,
the JAX package's own outcome with no cluster running.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List


def _gather(drain: bool = True) -> Dict[str, Any]:
    """Everything observable in this process now. ``drain=False`` (the
    metrics read) leaves the spans in the local ring: a metrics read must
    never destroy trace data a later export would have written."""
    from raydp_tpu_torch.obs.metrics import metrics
    from raydp_tpu_torch.obs.tracing import (drain_local, dropped_count,
                                             flush, process_role)

    flush()
    spans: List[dict] = drain_local() if drain else []
    snapshot = metrics.snapshot()
    if dropped_count():
        snapshot["trace.spans_dropped"] = {"type": "counter",
                                           "value": dropped_count()}
    proc_metrics: Dict[str, dict] = {}
    if snapshot:
        proc_metrics[f"{process_role()}:{os.getpid()}"] = snapshot
    return {"spans": spans, "metrics": proc_metrics}


def export_trace(path: str) -> str:
    """Write the Perfetto-loadable trace; returns ``path``. Every event
    carries ``ph/ts/pid/tid/name``."""
    gathered = _gather()
    events: List[dict] = []
    # display pids are synthesized per (role, os-pid) pair, one labelled
    # Perfetto track per process
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
    """``{"<role>:<pid>": {metric: snapshot}}`` of this process's live
    registry."""
    return _gather(drain=False)["metrics"]
