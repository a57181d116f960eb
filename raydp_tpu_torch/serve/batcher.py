"""Dynamic batcher: per-deployment admission queue -> bucket-padded batches
-> replica dispatch over the doorbell UDS fast path; the port's copy of
``raydp_tpu/serve/batcher.py``.

Requests enter ``submit`` (any number of rows, up to the max batch size) and
park on per-request events. A drain thread forms batches on two triggers —
SIZE (enough queued rows to fill the largest bucket) or DEADLINE (the oldest
queued request has waited ``serve.batch_deadline_ms``) — pops whole requests,
and hands each batch to a small dispatcher pool. Dispatchers concatenate the
rows (exchange/features.py is the one row-accounting implementation), pad to
the nearest bucket, pick the least-loaded live replica, and send one
``infer`` actor call; actor dispatch rides the cluster's doorbell pooled sockets
automatically, so a warm request costs zero connect/handshake round trips.

Zero-drop failover: inference is pure and idempotent, so a dispatch that
dies with its replica (SIGKILL mid-flight, connection reset, actor DEAD) is
RE-ADMITTED at the FRONT of the queue and re-served by a surviving replica —
callers never see the failure unless a request exhausts
``serve.max_retries``. Replica exceptions that are NOT transport failures
(a bad payload) resolve straight to the caller: retrying a deterministic
error forever would hang the client.

Lock discipline (the blocking-under-lock rule): the condition guards queue
and replica-table state only; every RPC, result wait, and pad/concat runs
OUTSIDE it in the dispatcher threads.
"""

from __future__ import annotations

import random as _random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from raydp_tpu_torch import sanitize
from raydp_tpu_torch.cluster.common import ClusterError
from raydp_tpu_torch.exchange.features import (
    as_feature_rows,
    f_concat,
    f_rows,
    f_slice,
    pad_rows,
)

# transport-shaped dispatch failures: the request was (possibly) in flight on
# a replica that died or a socket that reset — re-admission is always safe
# because inference is pure
_RETRYABLE = (ClusterError, ConnectionError, EOFError, OSError, TimeoutError)


class _Request:
    __slots__ = ("rows", "n", "done", "value", "error", "retries",
                 "t_enqueue", "t_formed", "t_dispatch", "t_reply", "ctx")

    def __init__(self, rows, n: int):
        self.rows = rows
        self.n = n
        self.done = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.retries = 0
        self.t_enqueue = time.monotonic()
        # request-path tracing (docs/observability.md "Request traces"):
        # stage stamps are taken for EVERY request (three monotonic reads —
        # they feed the serve.stage.* histograms behind stats()'s latency
        # decomposition); ctx is a minted (trace_id, span_id) for SAMPLED
        # requests only, whose spans are emitted at resolution
        self.t_formed: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_reply: Optional[float] = None
        self.ctx: Optional[tuple] = None

    def resolve(self, value) -> None:
        self.value = value
        self.done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.done.set()

    def result(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError("serving request timed out")
        if self.error is not None:
            raise self.error
        return self.value


class _ChunkAssembly:
    """Reassembles one oversized request served as several bucket-shaped
    dispatches. Parts resolve independently (possibly on different replicas,
    possibly after re-admission); the parent resolves once every part has,
    with the rows concatenated back in order. Any part failing terminally
    fails the parent — partial results never reach a caller."""

    def __init__(self, parent: _Request):
        self.parent = parent
        self.lock = threading.Lock()
        self.results: List = []
        self.remaining = 0

    def arm(self, n_parts: int) -> None:
        self.results = [None] * n_parts
        self.remaining = n_parts

    def part_resolved(self, index: int, value) -> None:
        with self.lock:
            if self.parent.done.is_set():
                return
            self.results[index] = value
            self.remaining -= 1
            ready = self.remaining == 0
        if ready:
            self.parent.resolve(f_concat(self.results))

    def part_failed(self, error: BaseException) -> None:
        self.parent.fail(error)


class _ChunkPart(_Request):
    """One bucket-sized slice of an oversized request. Behaves exactly like
    a request on the dispatch/requeue path (it can be re-admitted on replica
    failure like any other), but resolution routes through the assembly."""

    __slots__ = ("assembly", "index")

    def __init__(self, rows, n: int, assembly: _ChunkAssembly, index: int):
        super().__init__(rows, n)
        self.assembly = assembly
        self.index = index

    def resolve(self, value) -> None:
        super().resolve(value)
        self.assembly.part_resolved(self.index, value)

    def fail(self, error: BaseException) -> None:
        super().fail(error)
        self.assembly.part_failed(error)


class DynamicBatcher:
    def __init__(
        self,
        conf,
        feature_columns=None,
        on_replica_failure: Optional[Callable] = None,
        admission=None,
    ):
        self._conf = conf
        self._feature_columns = feature_columns
        self._on_replica_failure = on_replica_failure
        # fair-share admission (tenancy/scheduler.py): when the deployment
        # names a tenant (``serve.tenant`` conf), every batch dispatch
        # acquires one admission ticket from the SAME weighted-DRR queue the
        # tenant's ETL stages use — serving and ETL share one quota, and a
        # co-tenant cannot starve this deployment. None = unthrottled.
        self._admission = admission
        self._cond = threading.Condition(
            sanitize.named_lock("serve.queue", threading.Lock())
        )
        # guarded-by: self._cond
        self._queue: deque = deque()
        self._queued_rows = 0
        self._replicas: Dict[str, object] = {}  # actor_id -> handle
        self._draining: set = set()
        self._failed: set = set()
        self._inflight: Dict[str, int] = {}
        self._rr = 0  # round-robin tiebreak among equally-loaded replicas
        self._stop = False
        # recent completion latencies (ms) for the SLO gauges the autoscaler
        # reads; cumulative shape lives in the serve.request_latency_s
        # histogram (now with reservoir p50/p99)
        self._latency_window: deque = deque(maxlen=256)

        from raydp_tpu_torch import obs

        m = obs.metrics
        self._m_requests = m.counter("serve.requests")
        self._m_rows = m.counter("serve.rows")
        self._m_batches = m.counter("serve.batches")
        self._m_padded = m.counter("serve.padded_rows")
        self._m_chunked = m.counter("serve.chunked_dispatches")
        self._m_requeued = m.counter("serve.requeued_requests")
        self._m_dropped = m.counter("serve.dropped_requests")
        self._m_errors = m.counter("serve.dispatch_errors")
        self._m_doorbell = m.counter("serve.doorbell_pooled")
        self._m_fill = m.histogram("serve.batch_fill")
        self._m_latency = m.histogram("serve.request_latency_s")
        self._g_queue = m.gauge("serve.queue_depth")
        self._g_inflight = m.gauge("serve.inflight")
        self._g_p99 = m.gauge("serve.p99_ms")
        # per-stage latency decomposition (every request feeds these; the
        # serve.request trace spans are the sampled mirror of the same
        # stamps): queue_wait = admission→batch pop, batch_form =
        # pop→dispatch send (concat/pad/admission ticket), dispatch =
        # send→reply minus replica compute, compute = replica-reported,
        # respond = reply→caller resolution
        self._h_stages = {
            stage: m.histogram(f"serve.stage.{stage}_s")
            for stage in (
                "queue_wait", "batch_form", "dispatch", "compute", "respond",
            )
        }
        # request-trace sampling (obs.request_sample_rate): spans only ship
        # when tracing is enabled; the rate keeps a 650 req/s closed loop
        # from drowning the span rings
        self._sample_rate = float(getattr(conf, "request_sample_rate", 0.0))

        self._dispatch_slots = threading.Semaphore(conf.dispatchers)
        self._pool = ThreadPoolExecutor(
            max_workers=conf.dispatchers, thread_name_prefix="serve-dispatch"
        )
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="serve-batcher", daemon=True
        )
        self._drain_thread.start()

    # -- replica membership (called by the deployment/controller) -------

    def add_replica(self, handle) -> None:
        with self._cond:
            self._replicas[handle.actor_id] = handle
            self._inflight.setdefault(handle.actor_id, 0)
            self._failed.discard(handle.actor_id)
            self._cond.notify_all()

    def remove_replica(
        self, actor_id: str, drain: bool = True, timeout: float = 30.0
    ) -> bool:
        """Stop dispatching to a replica; with ``drain`` wait (bounded) for
        its in-flight batches to complete before dropping it — the graceful
        scale-in contract. Returns True when the replica left with zero
        requests in flight."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._draining.add(actor_id)
            while drain and self._inflight.get(actor_id, 0) > 0:
                if time.monotonic() > deadline:
                    break
                self._cond.wait(0.05)
            clean = self._inflight.get(actor_id, 0) == 0
            self._replicas.pop(actor_id, None)
            self._inflight.pop(actor_id, None)
            self._draining.discard(actor_id)
            self._failed.discard(actor_id)
        return clean

    def live_replicas(self) -> List[str]:
        with self._cond:
            return [
                rid for rid in self._replicas
                if rid not in self._draining and rid not in self._failed
            ]

    def failed_ids(self) -> List[str]:
        """Replica ids a dispatcher flagged after a transport failure —
        the controller's heal pass confirms with the head (DEAD: replace;
        ALIVE: the failure was transient, re-admit via add_replica)."""
        with self._cond:
            return list(self._failed)

    # -- client surface -------------------------------------------------

    def submit(self, payload) -> _Request:
        rows = as_feature_rows(payload, feature_columns=self._feature_columns)
        n = f_rows(rows)
        if n == 0:
            raise ValueError("empty serving request")
        if n > self._conf.max_batch_size:
            raise ValueError(
                f"request of {n} rows exceeds serve.max_batch_size="
                f"{self._conf.max_batch_size}"
            )
        req = _Request(rows, n)
        if self._sample_rate > 0.0:
            from raydp_tpu_torch.obs import tracing as _tracing

            if _tracing.enabled() and (
                self._sample_rate >= 1.0
                or _random.random() < self._sample_rate
            ):
                req.ctx = _tracing.mint_context()
        with self._cond:
            if self._stop:
                raise RuntimeError("serving deployment is closed")
            self._queue.append(req)
            self._queued_rows += n
            depth = self._queued_rows
            self._cond.notify_all()
        self._m_requests.inc()
        self._m_rows.inc(n)
        self._g_queue.set(depth)
        return req

    def predict(self, payload, timeout: Optional[float] = None):
        return self.submit(payload).result(
            timeout if timeout is not None else self._conf.request_timeout_s * 2
        )

    # -- internals ------------------------------------------------------

    def _pop_batch_locked(self) -> List[_Request]:
        """Pop whole requests up to the largest bucket's row budget (exactly
        one request with dynamic batching off). guarded-by: self._cond held"""
        budget = (
            self._conf.max_batch_size if self._conf.dynamic_batching else 0
        )
        batch: List[_Request] = [self._queue.popleft()]
        taken = batch[0].n
        while (
            self._queue
            and self._conf.dynamic_batching
            and taken + self._queue[0].n <= budget
        ):
            req = self._queue.popleft()
            taken += req.n
            batch.append(req)
        self._queued_rows -= taken
        return batch

    def _has_candidate_locked(self) -> bool:
        # guarded-by: self._cond held
        return any(
            rid not in self._draining and rid not in self._failed
            for rid in self._replicas
        )

    def _drain_loop(self) -> None:
        conf = self._conf
        while True:
            # backpressure: a dispatch slot is claimed BEFORE forming a
            # batch, so under overload requests accumulate in the admission
            # queue (where size-triggered batches fill properly) instead of
            # exploding into half-full batches parked on the pool queue
            if not self._dispatch_slots.acquire(timeout=0.05):
                with self._cond:
                    if self._stop and not self._queue:
                        return
                continue
            batch: List[_Request] = []
            with self._cond:
                while True:
                    if self._stop and not self._queue:
                        self._dispatch_slots.release()
                        return
                    if self._queue and self._has_candidate_locked():
                        age_ms = (
                            time.monotonic() - self._queue[0].t_enqueue
                        ) * 1000.0
                        if (
                            not conf.dynamic_batching
                            or self._stop
                            or self._queued_rows >= conf.max_batch_size
                            or age_ms >= conf.batch_deadline_ms
                        ):
                            batch = self._pop_batch_locked()
                            break
                        wait_s = min(
                            (conf.batch_deadline_ms - age_ms) / 1000.0, 0.05
                        )
                    else:
                        wait_s = 0.05
                    self._cond.wait(max(wait_s, 0.001))
                depth = self._queued_rows
            self._g_queue.set(depth)
            t_formed = time.monotonic()
            for req in batch:
                req.t_formed = t_formed
            self._pool.submit(self._dispatch, batch)

    def _pick_replica(self):
        with self._cond:
            candidates = [
                rid for rid in self._replicas
                if rid not in self._draining and rid not in self._failed
            ]
            if not candidates:
                return None
            self._rr += 1
            best = min(
                candidates,
                key=lambda rid: (self._inflight.get(rid, 0),
                                 (self._rr + hash(rid)) % len(candidates)),
            )
            self._inflight[best] = self._inflight.get(best, 0) + 1
            handle = self._replicas[best]
            total = sum(self._inflight.values())
        self._g_inflight.set(total)
        return handle

    def _release_replica(self, actor_id: str) -> None:
        with self._cond:
            if actor_id in self._inflight:
                self._inflight[actor_id] = max(
                    0, self._inflight[actor_id] - 1
                )
            self._cond.notify_all()  # drain waiters watch in-flight counts

    def _requeue_front(self, batch: List[_Request], charge_retry: bool,
                       error: Optional[BaseException]) -> None:
        """Re-admit a failed batch's requests at the queue FRONT (their
        deadline clock keeps running from original admission). Requests out
        of retries resolve the error to their caller instead."""
        survivors: List[_Request] = []
        for req in batch:
            if charge_retry:
                req.retries += 1
            if error is not None and req.retries > self._conf.max_retries:
                req.fail(error)
                self._m_dropped.inc()
            else:
                survivors.append(req)
        if not survivors:
            return
        with self._cond:
            stopped = self._stop
            if not stopped:
                for req in reversed(survivors):
                    self._queue.appendleft(req)
                    self._queued_rows += req.n
                self._cond.notify_all()
        if stopped:
            # close() already cleared the queue and the drain thread is
            # gone — re-admitting here would strand these callers until
            # their predict timeout; fail fast like every pending request
            closed = RuntimeError("serving deployment closed")
            for req in survivors:
                req.fail(closed)
            return
        if charge_retry:
            self._m_requeued.inc(len(survivors))

    def _dispatch(self, batch: List[_Request]) -> None:
        try:
            self._dispatch_inner(batch)
        except BaseException as exc:  # noqa: BLE001 - backstop: no request may strand
            # a dispatch bug must never leave a caller parked on an event
            # that nobody will set (the pool future would swallow this)
            for req in batch:
                if not req.done.is_set():
                    req.fail(exc)
            from raydp_tpu_torch import obs

            obs.log.error("serve dispatch failed unexpectedly",
                          exc_info=True)
        finally:
            self._dispatch_slots.release()

    def _dispatch_inner(self, batch: List[_Request]) -> None:
        conf = self._conf
        # form the batch BEFORE claiming a replica: a formation error
        # (mixed payload containers, a misconfigured bucket ladder) then
        # fails the requests without ever inflating a replica's in-flight
        # count
        try:
            rows = (
                batch[0].rows if len(batch) == 1
                else f_concat([r.rows for r in batch])
            )
            n = sum(r.n for r in batch)
            chunk_to = None
            padded = None
            if conf.dynamic_batching:
                bucket = next((b for b in conf.buckets if b >= n), None)
                if bucket is None and conf.buckets:
                    # oversized payload (a hand-built ladder whose largest
                    # bucket is below max_batch_size): chunk it to the
                    # largest bucket — a raw shape must never warm into
                    # a live replica's bucket-keyed cache (the same hazard
                    # replica.profile() truncates against)
                    chunk_to = max(conf.buckets)
                else:
                    # a resolve()d ladder always contains max_batch_size;
                    # an empty hand-built one falls back to no padding
                    bucket = bucket if bucket is not None else n
                    padded = pad_rows(rows, bucket)
                    self._m_padded.inc(bucket - n)
                    self._m_fill.observe(n / bucket)
            else:
                padded = rows
                self._m_fill.observe(1.0)
        except Exception as exc:
            self._m_errors.inc()
            for req in batch:
                req.fail(exc)
            return
        ticket = None
        if self._admission is not None:
            from raydp_tpu_torch.tenancy.scheduler import TenantQuotaError

            try:
                # bounded by the request timeout: a tenant parked behind a
                # co-tenant's backlog is backpressure (the dispatcher thread
                # waits, requests fill the admission queue); a wait that
                # outlives the request budget resolves the TYPED quota
                # error to the callers instead of wedging the queue
                ticket = self._admission.acquire(
                    1, timeout_s=conf.request_timeout_s
                )
            except TenantQuotaError as exc:
                self._m_errors.inc()
                for req in batch:
                    req.fail(exc)
                return
        try:
            if chunk_to is not None:
                self._dispatch_chunked(batch, chunk_to)
            else:
                self._dispatch_to_replica(batch, n, padded)
        finally:
            if self._admission is not None:
                self._admission.release(ticket)

    def _dispatch_chunked(self, batch: List[_Request], largest: int) -> None:
        """Serve an over-bucket formation as a series of bucket-shaped
        dispatches: whole requests group greedily up to ``largest``; a
        single request bigger than ``largest`` splits into parts whose rows
        reassemble before its caller sees anything. Every dispatched shape
        is a real bucket shape."""
        groups: List[List[_Request]] = []
        current: List[_Request] = []
        cur_n = 0
        for req in batch:
            if req.n > largest:
                if current:
                    groups.append(current)
                    current, cur_n = [], 0
                assembly = _ChunkAssembly(req)
                parts = []
                offset = 0
                while offset < req.n:
                    k = min(largest, req.n - offset)
                    parts.append(_ChunkPart(
                        f_slice(req.rows, offset, offset + k),
                        k, assembly, len(parts),
                    ))
                    offset += k
                assembly.arm(len(parts))
                groups.extend([p] for p in parts)
            elif cur_n + req.n > largest:
                groups.append(current)
                current, cur_n = [req], req.n
            else:
                current.append(req)
                cur_n += req.n
        if current:
            groups.append(current)
        self._m_chunked.inc(len(groups))
        conf = self._conf
        t_formed = time.monotonic()
        for group in groups:
            g_n = sum(r.n for r in group)
            rows = (
                group[0].rows if len(group) == 1
                else f_concat([r.rows for r in group])
            )
            bucket = next((b for b in conf.buckets if b >= g_n), g_n)
            padded = pad_rows(rows, bucket)
            for req in group:
                if req.t_formed is None:
                    req.t_formed = t_formed
            self._m_padded.inc(bucket - g_n)
            self._m_fill.observe(g_n / bucket)
            self._dispatch_to_replica(group, g_n, padded)

    def _dispatch_to_replica(self, batch: List[_Request], n: int, padded) -> None:
        conf = self._conf
        handle = self._pick_replica()
        if handle is None:
            # no live replica RIGHT NOW (all draining/failed — the
            # controller is replacing them): park briefly off-lock and
            # re-admit without charging a retry
            time.sleep(0.02)
            self._requeue_front(batch, charge_retry=False, error=None)
            return
        # fan-in trace node: ONE serve.batch span parents the dispatch and
        # the replica's compute span (the RPC frame carries its context),
        # and links every sampled request in the batch via args — emitted
        # after the reply, when its duration is known
        from raydp_tpu_torch.obs import tracing as _tracing

        sampled = [req for req in batch if req.ctx is not None]
        batch_ctx = None
        if sampled and _tracing.enabled():
            import uuid as _uuid

            batch_ctx = (sampled[0].ctx[0], _uuid.uuid4().hex[:16])
        t_dispatch = time.monotonic()
        for req in batch:
            req.t_dispatch = t_dispatch
        try:
            with _tracing.use_context(batch_ctx):
                out = handle.infer.options(
                    timeout=conf.request_timeout_s
                ).remote(padded, n).result()
        except _RETRYABLE as exc:
            self._release_replica(handle.actor_id)
            self._m_errors.inc()
            self._note_failure(handle)
            self._requeue_front(batch, charge_retry=True, error=exc)
            return
        except BaseException as exc:  # noqa: BLE001 - deterministic replica error
            self._release_replica(handle.actor_id)
            self._m_errors.inc()
            for req in batch:
                req.fail(exc)
            return
        t_reply = time.monotonic()
        compute_s = 0.0
        if isinstance(out, tuple) and len(out) == 2:
            # replicas report their on-device compute seconds alongside the
            # rows (an older replica returning a bare array still works)
            out, compute_s = out
        for req in batch:
            req.t_reply = t_reply
        self._release_replica(handle.actor_id)
        self._m_batches.inc()
        # doorbell evidence: a completed dispatch returns its pooled socket
        # to THIS thread's doorbell table — count it so the fast path is
        # observable (tests + docs/serving.md assert on it)
        from raydp_tpu_torch.cluster import api as _capi

        conns = getattr(_capi._doorbell_tls, "conns", None)
        sock = getattr(handle, "_cached_sock", None)
        if conns and sock and sock in conns:
            self._m_doorbell.inc()
        now = time.monotonic()
        offset = 0
        latencies = []
        for req in batch:
            req.resolve(f_slice(out, offset, offset + req.n))
            offset += req.n
            latency_s = now - req.t_enqueue
            self._m_latency.observe(latency_s)
            latencies.append(latency_s * 1000.0)
        self._observe_stages(batch, now, compute_s)
        if batch_ctx is not None:
            self._emit_request_spans(
                batch, sampled, batch_ctx, now, compute_s,
                replica=handle.actor_id, batch_rows=n,
            )
        # the window deque is shared across dispatcher threads: mutate AND
        # snapshot it under the condition (a deque mutated mid-iteration
        # raises, which would silently starve the SLO gauge under exactly
        # the load where it matters)
        with self._cond:
            self._latency_window.extend(latencies)
            window = sorted(self._latency_window)
        if window:
            self._g_p99.set(window[min(len(window) - 1,
                                       int(len(window) * 0.99))])

    def _observe_stages(self, batch: List[_Request], t_done: float,
                        compute_s: float) -> None:
        """Feed the per-stage latency histograms from one resolved batch's
        stamps (dispatch = wire+wait minus the replica's reported compute)."""
        h = self._h_stages
        for req in batch:
            if req.t_formed is None or req.t_dispatch is None or req.t_reply is None:
                continue
            h["queue_wait"].observe(max(0.0, req.t_formed - req.t_enqueue))
            h["batch_form"].observe(max(0.0, req.t_dispatch - req.t_formed))
            h["dispatch"].observe(
                max(0.0, req.t_reply - req.t_dispatch - compute_s)
            )
            h["compute"].observe(max(0.0, compute_s))
            h["respond"].observe(max(0.0, t_done - req.t_reply))

    def _emit_request_spans(self, batch: List[_Request],
                            sampled: List[_Request], batch_ctx: tuple,
                            t_done: float, compute_s: float,
                            replica: str, batch_rows: int) -> None:
        """Emit the sampled request-path trace for one batch: per request a
        ``serve.request`` root with queue_wait / batch_form / dispatch /
        respond children, plus ONE ``serve.batch`` fan-in span (parented
        under the first sampled request, linking every sampled request span
        by id) whose context already rode the replica RPC — the replica's
        ``serve.replica_infer`` span lands under it."""
        from raydp_tpu_torch.obs.tracing import record_span

        now_wall_us = time.time_ns() // 1000
        now_mono = time.monotonic()

        def wall(stamp: Optional[float]) -> int:
            if stamp is None:
                return now_wall_us
            return now_wall_us - int((now_mono - stamp) * 1e6)

        first = sampled[0]
        record_span(
            "serve.batch",
            wall(first.t_dispatch), int((first.t_reply - first.t_dispatch) * 1e6),
            trace=batch_ctx[0], span_id=batch_ctx[1], parent=first.ctx[1],
            rows=int(batch_rows), requests=len(batch), replica=replica,
            compute_s=round(compute_s, 6),
            request_spans=[req.ctx[1] for req in sampled],
            request_traces=[req.ctx[0] for req in sampled],
        )
        for req in sampled:
            trace, span_id = req.ctx
            record_span(
                "serve.request", wall(req.t_enqueue),
                int((t_done - req.t_enqueue) * 1e6),
                trace=trace, span_id=span_id, parent=None,
                rows=req.n, retries=req.retries, batch_span=batch_ctx[1],
            )
            for name, lo, hi in (
                ("serve.queue_wait", req.t_enqueue, req.t_formed),
                ("serve.batch_form", req.t_formed, req.t_dispatch),
                ("serve.dispatch", req.t_dispatch, req.t_reply),
                ("serve.respond", req.t_reply, t_done),
            ):
                if lo is None or hi is None:
                    continue
                record_span(
                    name, wall(lo), int((hi - lo) * 1e6),
                    trace=trace, parent=span_id,
                    batch_span=batch_ctx[1],
                )

    def _note_failure(self, handle) -> None:
        with self._cond:
            self._failed.add(handle.actor_id)
        callback = self._on_replica_failure
        if callback is not None:
            try:
                callback(handle)
            except Exception:
                from raydp_tpu_torch import obs

                obs.log.error(
                    "replica-failure callback raised", exc_info=True,
                    actor_id=handle.actor_id,
                )

    # -- introspection / lifecycle --------------------------------------

    def stats(self) -> dict:
        with self._cond:
            out = {
                "queued_rows": self._queued_rows,
                "queued_requests": len(self._queue),
                "inflight": sum(self._inflight.values()),
                "replicas": len(self._replicas),
                "draining": len(self._draining),
                "failed": len(self._failed),
            }
        # per-stage latency decomposition (docs/observability.md): the same
        # stamps the sampled request traces are built from, as cumulative
        # histograms — p50/mean per stage in milliseconds
        stages = {}
        for stage, hist in self._h_stages.items():
            if hist.count:
                p50 = hist.quantile(0.50)
                stages[stage] = {
                    "p50_ms": round((p50 or 0.0) * 1e3, 3),
                    "mean_ms": round(hist.sum / hist.count * 1e3, 3),
                    "count": hist.count,
                }
        out["stage_latency"] = stages
        return out

    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def inflight_total(self) -> int:
        with self._cond:
            return sum(self._inflight.values())

    def close(self, timeout: float = 30.0) -> None:
        with self._cond:
            if self._stop:
                return
            self._stop = True
            pending = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self._cond.notify_all()
        for req in pending:
            req.fail(RuntimeError("serving deployment closed"))
        self._drain_thread.join(timeout)
        self._pool.shutdown(wait=True)
        self._g_queue.set(0)
        self._g_inflight.set(0)
