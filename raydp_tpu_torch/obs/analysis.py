"""Critical-path analysis over span graphs: the port's copy of the half of
``raydp_tpu/obs/analysis.py`` that ``explain_fit`` calls (``attribute``
and ``format_report``, with the category rules they use).

It answers which segments of a span tree's critical path took its wall
time, by category (``compute``, ``compile``, ``dispatch``, ``decode``,
``rpc``, ...). The algorithm is a **last-finisher chain**: from the root
span's end, repeatedly pick the child whose (clipped) end is latest,
recurse into it and continue leftward from its start. Intervals no child
covers are the owning span's own and are reported as **stalls**. A leaf
epoch span carrying the step recorder's ``ingest_s``/``h2d_s``/
``compute_s``/``sync_s`` args is split into those phases.

Every interval of the root lands in exactly one segment, so the category
totals sum to the root's wall time; ``attributed_frac`` is the share that
landed in named segments.

The decode arm, ``explain_stream`` / ``format_stream_report``, decomposes
one streamed generation's wall time from the decode engine's stream record
(``DecodeEngine.explain``) without any span: TTFT into queue, KV alloc,
prefill and dispatch; the steady state into step compute, admission churn,
drain and stall. ``explain_last_query`` attributes an ETL session's last
query from the planner's records (the head's spans of its trace join them
when tracing is on).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# ordered (substring, category) rules; first match wins. Substrings, not
# prefixes: span names arrive namespaced ("etl.stage", "serve.queue_wait").
_CATEGORY_RULES: Tuple[Tuple[str, str], ...] = (
    ("queue_wait", "queue"),
    ("admission", "queue"),
    ("lineage", "recovery"),
    ("recovery", "recovery"),
    ("heal", "recovery"),
    # decode-serving spans before the generic Arrow-decode rule: the
    # "decode" substring would otherwise misfile the whole serving plane
    ("serve.stream.failover", "recovery"),
    ("serve.decode.prefill", "compute"),
    ("serve.decode.step", "compute"),
    ("serve.decode", "compute"),
    ("serve.stream", "dispatch"),
    ("decode", "decode"),
    ("read", "decode"),
    ("compute", "compute"),
    ("replica_infer", "compute"),
    ("replica_compile", "compute"),
    ("compile", "compile"),
    ("estimator.step", "compute"),
    ("estimator.epoch", "compute"),
    ("executor.task", "compute"),
    ("task.run", "compute"),
    ("emit", "rpc"),
    ("head.", "rpc"),
    ("rpc", "rpc"),
    ("obs_ingest", "rpc"),
    ("flush", "rpc"),
    ("batch_form", "dispatch"),
    ("serve.batch", "dispatch"),
    ("serve.dispatch", "dispatch"),
    ("dispatch", "dispatch"),
    ("etl.stage", "dispatch"),
    ("serve.request", "queue"),
    ("etl.query", "driver"),
    ("respond", "rpc"),
)


def categorize(name: str) -> str:
    for needle, category in _CATEGORY_RULES:
        if needle in name:
            return category
    # fall back to the name's first dotted component — still a NAMED
    # segment ("serve", "store", ...), never a silent "other"
    return name.split(".", 1)[0] or "other"


class _Node:
    __slots__ = ("record", "start", "end", "children")

    def __init__(self, record: dict):
        self.record = record
        self.start = int(record.get("ts", 0))
        self.end = self.start + int(record.get("dur", 0))
        self.children: List["_Node"] = []


def _build(records: List[dict]) -> Dict[str, _Node]:
    nodes: Dict[str, _Node] = {}
    for record in records:
        if record.get("ph") == "i" or not record.get("id"):
            continue  # instants have no extent to attribute
        node = _Node(record)
        prev = nodes.get(record["id"])
        if prev is None or node.end - node.start > prev.end - prev.start:
            nodes[record["id"]] = node
    for node in nodes.values():
        parent = node.record.get("parent")
        if parent and parent in nodes and nodes[parent] is not node:
            nodes[parent].children.append(node)
    for node in nodes.values():
        node.children.sort(key=lambda n: n.start)
    return nodes


def pick_root(records: List[dict], root_name: Optional[str] = None,
              trace: Optional[str] = None) -> Optional[dict]:
    """The span to attribute: the longest span named ``root_name`` (when
    given), else the longest parentless span — of ``trace`` when given."""
    best = None
    ids = {r.get("id") for r in records}
    for record in records:
        if record.get("ph") == "i":
            continue
        if trace and record.get("trace") != trace:
            continue
        if root_name is not None:
            if record.get("name") != root_name:
                continue
        elif record.get("parent") and record.get("parent") in ids:
            continue
        if best is None or record.get("dur", 0) > best.get("dur", 0):
            best = record
    return best


def _phase_split(node: _Node, lo: int, hi: int) -> Optional[List[dict]]:
    """Split a leaf stage span into synthetic segments from its phase args
    (dispatch envelope around the server's read/compute/emit window)."""
    args = node.record.get("args") or {}
    step_split = _step_phase_split(node, args, lo, hi)
    if step_split is not None:
        return step_split
    phases = [
        ("decode", float(args.get("read_s", 0.0))),
        ("compute", float(args.get("compute_s", 0.0))),
        ("rpc", float(args.get("emit_s", 0.0))),
    ]
    server_s = float(args.get("server_seconds", 0.0))
    if server_s <= 0.0 or all(v <= 0.0 for _, v in phases):
        return None
    total_us = hi - lo
    server_us = min(int(server_s * 1e6), total_us)
    name = node.record.get("name", "span")
    segments: List[dict] = []
    cursor = lo + (total_us - server_us)
    if cursor > lo:
        segments.append(_segment(node, lo, cursor, "dispatch",
                                 f"{name}:dispatch"))
    phase_sum = sum(v for _, v in phases) or 1.0
    for label, seconds in phases:
        if seconds <= 0.0:
            continue
        width = int(server_us * (seconds / phase_sum))
        if width <= 0:
            continue
        segments.append(_segment(node, cursor, min(cursor + width, hi),
                                 label, f"{name}:{label}"))
        cursor += width
    if cursor < hi:
        segments.append(_segment(node, cursor, hi, "compute",
                                 f"{name}:server"))
    return segments


def _step_phase_split(node: _Node, args: dict, lo: int,
                      hi: int) -> Optional[List[dict]]:
    """Split a leaf EPOCH span by the step profiler's phase totals
    (``ingest_s``/``h2d_s``/``compute_s``/``sync_s`` args, obs/profiler.py)
    into the compute-plane categories — ``explain_last_fit`` gets the same
    fine-grained attribution queries get from the stage phase args. Time
    the phases don't cover stays the epoch's own (named) category.

    Gated on the step profiler's OWN keys (``ingest_s``/``h2d_s``/
    ``sync_s``): ``compute_s`` alone must not claim a planner stage span,
    whose read/compute/emit split belongs to the server-phase arm."""
    if not any(k in args for k in ("ingest_s", "h2d_s", "sync_s")):
        return None
    phases = [
        ("ingest", float(args.get("ingest_s", 0.0))),
        ("h2d", float(args.get("h2d_s", 0.0))),
        ("compute", float(args.get("compute_s", 0.0))),
        ("sync", float(args.get("sync_s", 0.0))),
    ]
    covered_s = sum(seconds for _, seconds in phases)
    if covered_s <= 0.0:
        return None
    total_us = hi - lo
    covered_us = min(int(covered_s * 1e6), total_us)
    scale = covered_us / (covered_s * 1e6)
    name = node.record.get("name", "span")
    segments: List[dict] = []
    cursor = lo
    for label, seconds in phases:
        if seconds <= 0.0:
            continue
        width = int(seconds * 1e6 * scale)
        if width <= 0:
            continue
        segments.append(_segment(node, cursor, min(cursor + width, hi),
                                 label, f"{name}:{label}"))
        cursor += width
    if cursor < hi:
        # epoch time outside the measured phases (shuffle, bookkeeping):
        # the epoch's own category — named, honest about coverage
        segments.append(_segment(node, cursor, hi, categorize(name),
                                 f"{name}:overhead"))
    return segments


def _segment(node: _Node, lo: int, hi: int, category: str,
             label: Optional[str] = None) -> dict:
    return {
        "name": label or node.record.get("name", "span"),
        "category": category,
        "proc": node.record.get("proc", ""),
        "start_us": lo,
        "dur_s": max(0, hi - lo) / 1e6,
    }


def attribute(records: List[dict], root_name: Optional[str] = None,
              root_id: Optional[str] = None,
              trace: Optional[str] = None, top_k: int = 5) -> dict:
    """Critical-path wall-time attribution for one span tree (see module
    docstring). Returns ``{root, trace, total_s, segments, by_category,
    stalls, attributed_frac}``; raises ValueError when no root is found."""
    nodes = _build(records)
    root_record = (
        nodes[root_id].record if root_id and root_id in nodes
        else pick_root(records, root_name, trace)
    )
    if root_record is None or root_record.get("id") not in nodes:
        raise ValueError(
            "no root span found"
            + (f" (root_name={root_name!r})" if root_name else "")
        )
    root = nodes[root_record["id"]]
    segments: List[dict] = []
    stalls: List[dict] = []

    def walk(node: _Node, lo: int, hi: int) -> None:
        """Attribute (lo, hi) — a sub-interval of ``node`` — walking the
        last-finisher chain of its children right-to-left."""
        if hi <= lo:
            return
        kids = [c for c in node.children if c.start < hi and c.end > lo]
        if not kids:
            split = _phase_split(node, lo, hi)
            if split:
                segments.extend(split)
            else:
                segments.append(
                    _segment(node, lo, hi,
                             categorize(node.record.get("name", "")))
                )
            return
        cursor = hi
        remaining = list(kids)
        while cursor > lo and remaining:
            best = None
            best_end = lo
            for child in remaining:
                eff_end = min(child.end, cursor)
                if eff_end <= lo or child.start >= eff_end:
                    continue
                if best is None or eff_end > best_end or (
                    eff_end == best_end and child.start < best.start
                ):
                    best = child
                    best_end = eff_end
            if best is None:
                break
            remaining.remove(best)
            if best_end < cursor:
                # nothing ran here (on this subtree): the owning span's own
                # time — a STALL worth naming when it is wide
                gap = _segment(node, best_end, cursor,
                               _self_category(node),
                               f"{node.record.get('name', 'span')}:self")
                segments.append(gap)
                stalls.append({
                    "owner": node.record.get("name", "span"),
                    "proc": node.record.get("proc", ""),
                    "start_us": best_end,
                    "dur_s": gap["dur_s"],
                    "after": best.record.get("name", "span"),
                })
            walk(best, max(best.start, lo), best_end)
            cursor = max(best.start, lo)
        if cursor > lo:
            segments.append(
                _segment(node, lo, cursor, _self_category(node),
                         f"{node.record.get('name', 'span')}:self")
            )

    walk(root, root.start, root.end)
    segments.sort(key=lambda s: s["start_us"])
    total_s = max(root.end - root.start, 1) / 1e6
    by_category: Dict[str, float] = {}
    self_s = 0.0
    other_s = 0.0
    for segment in segments:
        by_category[segment["category"]] = (
            by_category.get(segment["category"], 0.0) + segment["dur_s"]
        )
        if segment["name"].endswith(":self"):
            self_s += segment["dur_s"]
        if segment["category"] == "other":
            other_s += segment["dur_s"]
    stalls.sort(key=lambda s: s["dur_s"], reverse=True)
    return {
        "root": root.record.get("name", "span"),
        "trace": root.record.get("trace"),
        "root_id": root.record.get("id"),
        "total_s": total_s,
        "segments": segments,
        "by_category": dict(
            sorted(by_category.items(), key=lambda kv: kv[1], reverse=True)
        ),
        "stalls": stalls[: int(top_k)],
        # share of wall time attributed to NAMED critical-path segments
        # (everything but the "other" fallback — owner self-gaps are named
        # too: a stage's gather stall is "dispatch", inter-stage driver
        # time is "driver")
        "attributed_frac": max(0.0, 1.0 - other_s / total_s),
        # the stricter split: wall time inside span bodies / phase splits
        # vs owner self-gaps (the stalls) — how much of the path is WORK
        "work_frac": max(0.0, 1.0 - self_s / total_s),
    }


def _self_category(node: _Node) -> str:
    name = node.record.get("name", "")
    if name == "etl.query":
        return "driver"
    return categorize(name)


def format_report(report: dict) -> str:
    """Human rendering of an ``attribute()`` report."""
    lines = [
        f"critical path of {report['root']} "
        f"(trace {report.get('trace')}): {report['total_s'] * 1e3:.2f} ms",
        f"attributed to named segments: {report['attributed_frac']:.1%} "
        f"(work {report.get('work_frac', 0.0):.1%}, "
        f"stalls {1.0 - report.get('work_frac', 0.0):.1%})",
        "by category:",
    ]
    for category, seconds in report["by_category"].items():
        share = seconds / report["total_s"] if report["total_s"] else 0.0
        lines.append(
            f"  {category:<10} {seconds * 1e3:9.2f} ms  {share:6.1%}"
        )
    if report["stalls"]:
        lines.append(f"widest stalls (top {len(report['stalls'])}):")
        for stall in report["stalls"]:
            lines.append(
                f"  {stall['dur_s'] * 1e3:9.2f} ms in {stall['owner']} "
                f"after {stall['after']} [{stall['proc']}]"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the session-facing entry point
# ---------------------------------------------------------------------------


def explain_last_query(session=None, top_k: int = 5) -> dict:
    """Attribute the active session's LAST query's wall time along its
    critical path. Works with tracing OFF (the planner's collector records
    carry the driver-side spans plus per-stage phase args); with tracing ON
    the head's shipped spans for the same trace id enrich the graph with
    executor/task-level detail. Returns the ``attribute()`` report with a
    rendered ``text`` field."""
    if session is None:
        from raydp_tpu_torch.etl.session import active_session

        session = active_session()
    if session is None:
        raise RuntimeError("no active session (init_etl first)")
    planner = getattr(session, "_planner", None) or getattr(
        session, "planner", None
    )
    records = list(getattr(planner, "last_query_records", []) or [])
    if not records:
        raise RuntimeError("no query has run on this session yet")
    root = pick_root(records, "etl.query")
    if root is not None:
        trace = root.get("trace")
        from raydp_tpu_torch.obs.tracing import enabled

        if enabled() and trace:
            try:
                from raydp_tpu_torch.cluster import api as cluster_api
                from raydp_tpu_torch.obs.tracing import flush

                flush()
                dump = cluster_api.head_rpc("obs_dump", timeout=30.0)
                known = {r.get("id") for r in records}
                for record in dump.get("spans", []):
                    if record.get("trace") == trace and record.get("id") not in known:
                        records.append(record)
            except Exception:  # enrichment is best-effort: the records alone attribute the query
                pass
    report = attribute(records, root_name="etl.query", top_k=top_k)
    report["text"] = format_report(report)
    return report


# ---------------------------------------------------------------------------
# the decode arm: stream TTFT / time-per-token decomposition
# ---------------------------------------------------------------------------

# phase -> category, for the by_category rollup (mirrors _CATEGORY_RULES'
# vocabulary, so attribute() and explain_stream speak the same names)
_STREAM_PHASE_CATEGORY = {
    "queue": "queue",
    "kv_alloc": "compute",
    "prefill": "compute",
    "dispatch": "dispatch",
    "step_compute": "compute",
    "admission_churn": "queue",
    "drain": "dispatch",
    "stall": "other",
}


def explain_stream(client_record: dict,
                   engine_record: Optional[dict] = None,
                   top_k: int = 5) -> dict:
    """Decompose one streamed generation's wall time from the engine-kept
    stream record — no spans required, so this works with tracing OFF
    (the ``explain_last_query``/``explain_last_fit`` contract).

    TTFT splits into queue wait -> KV alloc -> prefill compute -> dispatch
    (driver-side RPC/poll remainder — a NAMED category, exactly as in
    ``attribute()``); steady-state splits into step compute -> admission
    churn (other streams' prefills stalling the loop) -> drain (the
    client's steady window minus the ENGINE's: RPC/poll wire time after
    the engine emitted, measurable because both sides stamp durations) ->
    stall (the engine-side residual no phase explains). ``attributed_frac``
    mirrors
    ``attribute()``'s convention: 1 - the "other" share, where only the
    stall residual is "other"; ``work_frac`` is the stricter share covered
    by ENGINE-MEASURED phases (queue + kv_alloc + prefill + step_compute +
    churn) — remainders excluded, honest about what was not measured."""
    client = dict(client_record or {})
    engine = dict(engine_record or {})
    total_s = float(client.get("wall_s") or engine.get("wall_s") or 0.0)
    ttft_s = client.get("ttft_s")
    if ttft_s is None:
        ttft_s = engine.get("ttft_s")
    ttft_s = float(ttft_s or 0.0)
    ttft_s = min(ttft_s, total_s) if total_s else ttft_s

    queue_s = float(engine.get("queue_s") or 0.0)
    kv_alloc_s = float(engine.get("kv_alloc_s") or 0.0)
    prefill_s = float(engine.get("prefill_s") or 0.0)
    step_s = float(engine.get("step_compute_s") or 0.0)
    churn_s = float(engine.get("churn_s") or 0.0)

    dispatch_s = max(0.0, ttft_s - queue_s - kv_alloc_s - prefill_s)
    steady_s = max(0.0, total_s - ttft_s)
    engine_steady_s = engine.get("steady_s")
    if engine_steady_s is not None:
        # both sides stamp their own steady window as durations: the
        # client's window minus the engine's is the poll/RPC drain after
        # the engine emitted — wire time, charged to dispatch, not stall
        engine_steady_s = min(float(engine_steady_s), steady_s)
        drain_s = max(0.0, steady_s - engine_steady_s)
        # round-to-round charging can overshoot the emit-to-emit steady
        # window by fractions of a round — clamp so parts never exceed
        # the whole
        step_s = min(step_s, max(0.0, engine_steady_s - churn_s))
        stall_s = max(0.0, engine_steady_s - step_s - churn_s)
    else:
        drain_s = 0.0
        stall_s = max(0.0, steady_s - step_s - churn_s)

    phases = {
        "queue": queue_s,
        "kv_alloc": kv_alloc_s,
        "prefill": prefill_s,
        "dispatch": dispatch_s,
        "step_compute": step_s,
        "admission_churn": churn_s,
        "drain": drain_s,
        "stall": stall_s,
    }
    by_category: Dict[str, float] = {}
    for phase, seconds in phases.items():
        category = _STREAM_PHASE_CATEGORY[phase]
        by_category[category] = by_category.get(category, 0.0) + seconds

    measured_s = queue_s + kv_alloc_s + prefill_s + step_s + churn_s
    attributed = (
        max(0.0, 1.0 - stall_s / total_s) if total_s > 0 else 0.0
    )
    work_frac = min(1.0, measured_s / total_s) if total_s > 0 else 0.0

    tokens = int(client.get("tokens") or engine.get("tokens") or 0)
    tpot_ms = (steady_s * 1e3 / (tokens - 1)) if tokens > 1 else None
    report = {
        "root": "serve.stream",
        "stream_id": client.get("stream_id") or engine.get("stream_id"),
        "deployment": client.get("deployment"),
        "trace": client.get("trace") or engine.get("trace"),
        "total_s": total_s,
        "ttft_s": ttft_s,
        "ttft_ms": ttft_s * 1e3,
        "tpot_ms": tpot_ms,
        "tokens": tokens,
        "prompt_tokens": engine.get("prompt_tokens"),
        "steps": engine.get("steps"),
        "failovers": int(client.get("failovers") or 0),
        "error": client.get("error") or engine.get("error"),
        "good_tokens": engine.get("good_tokens"),
        "late_tokens": engine.get("late_tokens"),
        "phases": phases,
        "by_category": dict(
            sorted(by_category.items(), key=lambda kv: kv[1], reverse=True)
        ),
        "attributed_frac": attributed,
        "work_frac": work_frac,
        "engine_record": bool(engine_record),
    }
    report["text"] = format_stream_report(report)
    return report


def format_stream_report(report: dict) -> str:
    """Human rendering of an ``explain_stream`` report."""
    phases = report["phases"]
    tokens = report.get("tokens") or 0
    header = (
        f"decode stream {report.get('stream_id')} on "
        f"{report.get('deployment') or '?'}: "
        f"{report['total_s'] * 1e3:.2f} ms wall, {tokens} tokens, "
        f"{report.get('failovers', 0)} failovers"
    )
    ttft_line = (
        f"ttft {report['ttft_ms']:.2f} ms = "
        f"queue {phases['queue'] * 1e3:.2f}"
        f" + kv_alloc {phases['kv_alloc'] * 1e3:.2f}"
        f" + prefill {phases['prefill'] * 1e3:.2f}"
        f" + dispatch {phases['dispatch'] * 1e3:.2f}"
    )
    steady_ms = max(0.0, report["total_s"] - report["ttft_s"]) * 1e3
    steady_line = (
        f"steady {steady_ms:.2f} ms = "
        f"step_compute {phases['step_compute'] * 1e3:.2f}"
        f" + admission_churn {phases['admission_churn'] * 1e3:.2f}"
        f" + drain {phases['drain'] * 1e3:.2f}"
        f" + stall {phases['stall'] * 1e3:.2f}"
    )
    if report.get("tpot_ms") is not None:
        steady_line += f"  ({report['tpot_ms']:.2f} ms/token)"
    lines = [
        header,
        ttft_line,
        steady_line,
        f"attributed to named phases: {report['attributed_frac']:.1%} "
        f"(engine-measured {report.get('work_frac', 0.0):.1%})",
    ]
    if not report.get("engine_record"):
        lines.append(
            "NOTE: no engine-side stream record (replica restarted or "
            "record evicted) — only client-side timings above"
        )
    if report.get("error"):
        lines.append(f"error: {report['error']}")
    return "\n".join(lines)
