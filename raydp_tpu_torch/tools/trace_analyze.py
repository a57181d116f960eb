"""Critical-path attribution over an exported Perfetto trace, on the
port: the counterpart of the repository's ``tools/trace_analyze.py``.

Run: ``python -m raydp_tpu_torch.tools.trace_analyze trace.json [--root
etl.query] [--trace-id <trace-id>] [--top 5] [--json report.json]``

Loads a ``raydp_tpu_torch.export_trace`` JSON, rebuilds the span graph
from the event args (``trace_id`` / ``span_id`` / ``parent_id`` ride every
exported event), picks the root span (``--root`` name, ``--trace-id``, or
the longest parentless span), and prints ``obs/analysis.py``'s wall-time
attribution: per-category critical-path totals and the top-K widest
stalls.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List


def records_from_trace(doc: dict) -> List[dict]:
    """Perfetto trace events -> the span records ``obs/analysis.py``
    consumes. Metadata events name the process tracks; complete events
    carry ids in args."""
    track_names = {}
    for event in doc.get("traceEvents", []):
        if event.get("ph") == "M" and event.get("name") == "process_name":
            track_names[event.get("pid")] = (
                (event.get("args") or {}).get("name", "proc")
            )
    records = []
    for event in doc.get("traceEvents", []):
        if event.get("ph") not in ("X", "i"):
            continue
        args = dict(event.get("args") or {})
        records.append({
            "name": event.get("name", "span"),
            "ts": int(event.get("ts", 0)),
            "dur": int(event.get("dur", 0)),
            "ph": event.get("ph") if event.get("ph") == "i" else None,
            "proc": track_names.get(event.get("pid"), str(event.get("pid"))),
            "trace": args.pop("trace_id", None),
            "id": args.pop("span_id", None),
            "parent": args.pop("parent_id", None),
            "args": args,
        })
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trace", help="export_trace JSON path")
    parser.add_argument("--root", default=None,
                        help="root span NAME (e.g. etl.query, serve.request);"
                             " default: longest parentless span")
    parser.add_argument("--trace-id", default=None,
                        help="restrict root selection to one trace id")
    parser.add_argument("--top", type=int, default=5,
                        help="widest stalls to report")
    parser.add_argument("--json", default=None,
                        help="also write the report as JSON here")
    args = parser.parse_args(argv)

    from raydp_tpu_torch.obs.analysis import attribute, format_report

    with open(args.trace) as f:
        doc = json.load(f)
    records = records_from_trace(doc)
    if not records:
        print("no span events in trace", file=sys.stderr)
        return 1
    try:
        report = attribute(records, root_name=args.root,
                           trace=args.trace_id, top_k=args.top)
    except ValueError as exc:
        print(f"trace_analyze: {exc}", file=sys.stderr)
        return 1
    print(format_report(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
