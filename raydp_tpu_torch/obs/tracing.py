"""Span API: the port's copy of what a fit on one process uses of
``raydp_tpu/obs/tracing.py``.

A span is a plain dict: ``{name, ts, dur, pid, tid, proc, trace, id,
parent, args}`` with ``ts``/``dur`` in microseconds of wall time
(``time.time_ns``). Two consumers, as in the JAX package:

- **collectors** (thread-local, always available): ``with collect() as
  got:`` captures every span finished on this thread. The estimator reads
  its epoch and compile times, and ``explain_last_fit`` its attribution,
  from these records.
- **the ring buffer** (process-global, gated on ``RAYDP_TPU_TRACE`` or
  :func:`set_enabled`): finished spans are kept in a ring of
  ``RAYDP_TPU_TRACE_BUFFER`` records and ship to the cluster head on
  :func:`flush` / at exit, with the metrics snapshot and the flight
  recorder's log ring; with no cluster (or a dead head) they stay local and
  are re-buffered. A full ring drops its oldest record and counts it
  (:func:`dropped_count`, ``trace.spans_dropped`` in ``dump_metrics``).

With tracing off and no collector installed, ``span()`` returns a shared
no-op after one branch.

Context: ``(trace_id, span_id)`` pairs travel thread-locally; ``span()``
parents under the current context and installs itself for its body. RPC
clients attach the current context to outgoing frames (cluster.common.rpc,
ActorHandle) and servers adopt it around the handled call, so causality
crosses process boundaries. :func:`mint_context` makes a root out of band (a serving stream's, passed
to ``DecodeEngine.submit`` as ``trace_ctx``), :func:`with_context` runs a
function under one on another thread.
"""

from __future__ import annotations

import atexit
import collections
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

TRACE_ENV = "RAYDP_TPU_TRACE"
BUFFER_ENV = "RAYDP_TPU_TRACE_BUFFER"

_enabled = os.environ.get(TRACE_ENV, "0") not in ("", "0", "false", "False")
_buffer_cap = int(os.environ.get(BUFFER_ENV, "8192") or "8192")

from raydp_tpu_torch.sanitize import named_lock as _named_lock

_tls = threading.local()
_buf_lock = _named_lock("obs._buf_lock")
_buffer: "collections.deque" = collections.deque(maxlen=_buffer_cap)
_dropped = 0  # spans evicted from the ring before a flush shipped them

# what this process calls itself in the trace (one Perfetto track per proc)
_role: str = "driver"


def set_process_role(role: str) -> None:
    """Label this process's track ("head" / "agent:<ip>" /
    "worker:<actor-id>" / "zygote"); the driver default stands when nothing
    claims otherwise."""
    global _role
    _role = role


def process_role() -> str:
    # a worker process that never called set_process_role still labels
    # itself from its spawn environment
    global _role
    if _role == "driver":
        actor_id = os.environ.get("RAYDP_TPU_TORCH_ACTOR_ID")
        if actor_id:
            _role = f"worker:{actor_id}"
    return _role


def enabled() -> bool:
    """Is the local span buffer on? (Collectors work either way.)"""
    return _enabled


def set_enabled(value: bool) -> None:
    """Test/bench hook; prefer setting RAYDP_TPU_TRACE before the process
    starts."""
    global _enabled
    _enabled = bool(value)


def reinit_for_process(role: str) -> None:
    """Reset per-process tracing state after fork/exec into a new runtime
    role. Zygote-forked workers inherit the ZYGOTE's enablement and buffer;
    the session that requested the fork decides tracing (its env rode in
    with the fork request), so re-read the environment and start clean."""
    global _enabled, _dropped
    set_process_role(role)
    _enabled = os.environ.get(TRACE_ENV, "0") not in ("", "0", "false", "False")
    with _buf_lock:
        _buffer.clear()
    _dropped = 0


def _collectors() -> List[list]:
    got = getattr(_tls, "collectors", None)
    if got is None:
        got = _tls.collectors = []
    return got


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) the next span parents under, or None."""
    return getattr(_tls, "ctx", None)


def _set_context(ctx: Optional[Tuple[str, str]]) -> None:
    _tls.ctx = ctx


class use_context:
    """Adopt a (trace_id, span_id) for a code region -- how a helper thread
    keeps its spans in the caller's trace."""

    def __init__(self, ctx: Optional[Tuple[str, str]]):
        self._ctx = tuple(ctx) if ctx else None
        self._saved: Optional[Tuple[str, str]] = None

    def __enter__(self):
        self._saved = current_context()
        if self._ctx is not None:
            _set_context(self._ctx)
        return self

    def __exit__(self, *exc):
        _set_context(self._saved)


def with_context(ctx, fn, *args, **kwargs):
    """Run ``fn`` under ``ctx``: how the caller's trace context reaches a
    worker-pool thread (thread-locals do not cross threads)."""
    with use_context(ctx):
        return fn(*args, **kwargs)


class _NoopSpan:
    """Shared do-nothing span for the disabled fast path."""

    __slots__ = ()
    duration = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


def _record(name: str, ts_us: int, dur_us: int, trace: str, span_id: str,
            parent: Optional[str], args: Dict[str, Any]) -> dict:
    return {
        "name": name,
        "ts": ts_us,
        "dur": dur_us,
        "pid": os.getpid(),
        "tid": threading.get_ident() % 1_000_000,
        "proc": process_role(),
        "trace": trace,
        "id": span_id,
        "parent": parent,
        "args": args,
    }


def _emit(record: dict) -> None:
    for sink in _collectors():
        sink.append(record)
    if _enabled:
        _buffer_append(record)


class Span:
    __slots__ = ("name", "args", "trace", "id", "parent", "_t0", "_ts",
                 "duration", "_saved_ctx")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        ctx = current_context()
        if ctx is None:
            self.trace = uuid.uuid4().hex[:16]
            self.parent = None
        else:
            self.trace, self.parent = ctx
        self.id = uuid.uuid4().hex[:16]
        self._saved_ctx = ctx
        self.duration = 0.0
        self._ts = time.time_ns() // 1000
        self._t0 = time.perf_counter()

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        _set_context((self.trace, self.id))
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration = time.perf_counter() - self._t0
        _set_context(self._saved_ctx)
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        _emit(_record(self.name, self._ts, int(self.duration * 1e6),
                      self.trace, self.id, self.parent, self.args))
        return False


def span(name: str, **attrs):
    """Start a span: ``with obs.span("estimator.epoch", epoch=0) as s``.
    Disabled and no collector: the shared no-op (one branch)."""
    if not _enabled and not getattr(_tls, "collectors", None):
        return _NOOP
    return Span(name, attrs)


def instant(name: str, **attrs) -> None:
    """A zero-duration marker event. Same gating as span()."""
    if not _enabled and not getattr(_tls, "collectors", None):
        return
    ctx = current_context()
    record = _record(name, time.time_ns() // 1000, 0,
                     (ctx or (uuid.uuid4().hex[:16],))[0],
                     uuid.uuid4().hex[:16], (ctx or (None, None))[1], attrs)
    record["ph"] = "i"
    _emit(record)


def record_span(
    name: str,
    ts_us: int,
    dur_us: int,
    trace: str,
    span_id: Optional[str] = None,
    parent: Optional[str] = None,
    **attrs,
) -> dict:
    """Emit a span RECORD for an interval measured elsewhere. Same
    consumers as a span's exit; returns the record (its ``id`` links
    children)."""
    record = _record(name, int(ts_us), max(0, int(dur_us)), trace,
                     span_id or uuid.uuid4().hex[:16], parent, attrs)
    _emit(record)
    return record


def mint_context() -> Tuple[str, str]:
    """A fresh (trace_id, span_id) pair for a root minted out of band: a
    sampled serving stream's, whose engine-side spans are emitted later by
    ``record_span`` under it."""
    return uuid.uuid4().hex[:16], uuid.uuid4().hex[:16]


def current_sinks() -> List[list]:
    """This thread's active collector sinks: capture them before handing
    work to a helper thread, and re-install there with ``use_sinks``."""
    return list(_collectors())


class use_sinks:
    """Adopt another thread's collector sinks for a code region. Appends are
    atomic under the interpreter lock, so two threads sharing a sink list
    interleave records without corruption."""

    def __init__(self, sinks: List[list]):
        self._sinks = list(sinks)

    def __enter__(self):
        _collectors().extend(self._sinks)
        return self

    def __exit__(self, *exc):
        got = _collectors()
        for sink in self._sinks:
            for i in range(len(got) - 1, -1, -1):
                if got[i] is sink:
                    del got[i]
                    break


class collect:
    """Capture every span/instant finished on THIS thread into a list.
    Nesting composes: inner collectors see only their own region."""

    def __init__(self):
        self.records: List[dict] = []

    def __enter__(self) -> List[dict]:
        _collectors().append(self.records)
        return self.records

    def __exit__(self, *exc):
        # remove by identity: two empty sink lists compare equal
        sinks = _collectors()
        for i in range(len(sinks) - 1, -1, -1):
            if sinks[i] is self.records:
                del sinks[i]
                break


_flush_inflight = threading.Event()


def _buffer_append(record: dict) -> None:
    global _dropped
    start_flush = False
    with _buf_lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1  # the append below evicts the oldest record
        _buffer.append(record)
        if len(_buffer) >= (_buffer.maxlen or 1) // 2:
            # a ring half full ships itself on a background thread, so the
            # call site neither stalls nor loses spans; one flusher at a time
            start_flush = not _flush_inflight.is_set()
            if start_flush:
                _flush_inflight.set()
    if start_flush:
        threading.Thread(target=_pressure_flush, daemon=True).start()


def _pressure_flush() -> None:
    try:
        flush()
    finally:
        _flush_inflight.clear()


def drain_local() -> List[dict]:
    """Remove and return this process's buffered spans."""
    with _buf_lock:
        out = list(_buffer)
        _buffer.clear()
    return out


def dropped_count() -> int:
    """Spans the full ring evicted since the process started."""
    return _dropped


def flush() -> bool:
    """Ship buffered spans, the metrics snapshot and the log ring to the
    head. Safe to call anywhere: no cluster, no session, or a dead head all
    degrade to keeping the spans local (they are re-buffered for the next
    attempt, and what does not fit is counted as dropped). The head
    process itself ingests directly, no RPC to self. Returns whether the
    records reached a head."""
    global _dropped
    from raydp_tpu_torch.obs.metrics import metrics

    # memory watermark plane: every flush tick samples this process's
    # rss / device bytes + pressure into the registry FIRST, so the
    # snapshot shipped below carries fresh mem.* gauges (self-throttled to
    # ~1s inside sample_memory), and the kernel layer's launch counts
    try:
        from raydp_tpu_torch.obs.profiler import sample_launches, sample_memory

        sample_memory()
        sample_launches()
    except Exception:  # the samplers must never block a telemetry flush
        pass

    spans = drain_local()
    snapshot = metrics.snapshot()
    if not spans and not snapshot:
        return True
    # the process-local time-series mirror rides the same tick: in-process
    # readers (the decode engine's memory-pressure veto) get the windowed
    # signal a head scrape would show
    try:
        from raydp_tpu_torch.obs import timeseries as _ts

        _ts.ingest_local(snapshot)
    except Exception:  # the local mirror must never block shipping to the head
        pass
    # flight-recorder log ring: shipped alongside spans/metrics so the head
    # holds every process's recent log lines for crash dossiers
    from raydp_tpu_torch.obs import recorder as _recorder

    logs = _recorder.drain_logs()
    proc = {"pid": os.getpid(), "role": process_role(), "dropped": _dropped}
    try:
        # the head's direct-ingest hook comes FIRST: the head process has
        # neither an initialized cluster API nor a session in its env, so
        # the cluster guard below would otherwise fail every head flush
        ingest = _local_ingest
        if ingest is not None:
            ingest(proc=proc, spans=spans, metrics_snapshot=snapshot,
                   logs=logs)
            return True
        from raydp_tpu_torch.cluster import api as cluster_api
        from raydp_tpu_torch.cluster.common import SESSION_ENV

        if not cluster_api.is_initialized() and not os.environ.get(SESSION_ENV):
            raise RuntimeError("no cluster")
        cluster_api.head_rpc(
            "obs_ingest", proc=proc, spans=spans,
            metrics_snapshot=snapshot, logs=logs, timeout=10.0,
        )
        return True
    except Exception:
        with _buf_lock:
            # re-buffer into the space left, preferring the NEWEST of the
            # failed batch (appendleft on a full deque would silently evict
            # from the right, i.e. drop spans recorded DURING the failed
            # flush); anything that doesn't fit is counted as dropped
            space = (_buffer.maxlen or 0) - len(_buffer)
            kept = spans[-space:] if space > 0 else []
            _dropped += len(spans) - len(kept)
            for record in reversed(kept):
                _buffer.appendleft(record)
        _recorder.requeue_logs(logs)
        return False


_last_flush = 0.0
_flush_lock = threading.Lock()


def flush_throttled(min_interval: float = 0.5) -> None:
    """flush() at most every ``min_interval`` seconds: the ship point of
    processes that may be SIGKILLed. Runs with tracing OFF too: the metrics
    registry is always on, and its snapshots reach ``dump_metrics()`` this
    way."""
    global _last_flush
    now = time.monotonic()
    with _flush_lock:
        if now - _last_flush < min_interval:
            return
        _last_flush = now
    flush()


# set by the head process so its own spans skip the RPC loopback
_local_ingest = None


def set_local_ingest(fn) -> None:
    global _local_ingest
    _local_ingest = fn


@atexit.register
def _flush_at_exit() -> None:  # pragma: no cover - exit path
    if _enabled:
        try:
            flush()
        except Exception:  # the logging plane may already be gone at exit
            pass
