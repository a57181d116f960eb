"""Deployment: the user-facing handle over a replica pool; the port's copy
of ``raydp_tpu/serve/deployment.py``.

``serve.deploy(estimator, ...)`` (or an explicit model + checkpoint_dir)
spawns N ``ModelReplica`` actors, wires the dynamic batcher in front of them,
and starts the controller (healing + optional autoscaling). The deployment
object is the request client: ``predict(payload)`` is thread-safe and
blocking — concurrent client threads are the intended usage.

Replica-count management is RECONCILIATION-shaped: every path (explicit
``scale_to``, autoscaler decisions, failure healing) just moves the pool
toward ``_target``; races between the controller thread and a user thread
self-correct on the next pass instead of needing a lock held across spawn
RPCs (which the blocking-under-lock rule — correctly — forbids). Scale-in
always drains: the batcher stops routing to the victim, its in-flight
batches finish, then it is killed.

Rolling reload: ``reload()`` walks the replicas ONE AT A TIME; each replica
restores the newest checkpoint and warms it while its old generation
keeps serving (ModelReplica swaps atomically), so the deployment serves
every request throughout — from the old weights until that replica's swap,
from the new after.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from raydp_tpu_torch import obs, sanitize
from raydp_tpu_torch.cluster import api as cluster
from raydp_tpu_torch.cluster.common import ActorState, ClusterError
from raydp_tpu_torch.serve.autoscaler import ServeController
from raydp_tpu_torch.serve.batcher import DynamicBatcher
from raydp_tpu_torch.serve.config import ServeConf
from raydp_tpu_torch.serve.replica import ModelReplica, ReplicaSpec


class Deployment:
    def __init__(
        self,
        spec: ReplicaSpec,
        conf: ServeConf,
        replicas: int = 1,
        feature_columns=None,
    ):
        if not cluster.is_initialized():
            cluster.init()
        self._spec = spec
        self._conf = conf
        self._name = spec.name
        self._closed = False
        self._next_idx = 0
        self._next_stream = 0  # round-robin cursor for decode streams
        self._lock = sanitize.named_lock(
            "serve.deployment", threading.RLock()
        )
        # guarded-by: self._lock
        self._handles: List = []
        self._target = max(1, int(replicas))
        if conf.autoscale:
            self._target = min(
                max(self._target, conf.min_replicas), conf.max_replicas
            )
        self._m_out = obs.metrics.counter("serve.scale_out")
        self._m_in = obs.metrics.counter("serve.scale_in")
        self._m_reloads = obs.metrics.counter("serve.reloads")
        self._m_failovers = obs.metrics.counter("serve.replica_replacements")
        self._g_replicas = obs.metrics.gauge("serve.replicas")
        # client-side record of the last COMPLETED decode stream (stamps,
        # serving replica, stream id) — explain_last_stream starts here
        # (guarded-by: self._lock)
        self._last_stream: Optional[dict] = None
        admission = None
        if conf.tenant:
            # ride the named tenant's fair-share queue (docs/multitenancy.md);
            # a serve-only tenant (no ETL session) registers with defaults
            from raydp_tpu_torch.tenancy import registry as _treg

            scheduler = _treg.scheduler()
            if conf.tenant not in scheduler.snapshot():
                scheduler.register(conf.tenant)
            admission = scheduler.handle(conf.tenant)
        self.batcher = DynamicBatcher(
            conf,
            feature_columns=feature_columns,
            on_replica_failure=self._on_replica_failure,
            admission=admission,
        )
        try:
            with obs.span(
                "serve.deploy", deployment=self._name,
                replicas=self._target,
            ):
                self._reconcile()
            self.controller = ServeController(self, conf)
        except BaseException:
            # a deployment that failed to come up must not leave batcher
            # threads or half-spawned replicas behind the leak audit
            self._teardown()
            raise

    # -- replica pool ---------------------------------------------------

    def _spawn_one(self):
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        handle = cluster.spawn(
            ModelReplica,
            self._spec,
            name=f"{self._name}-serve-replica-{idx}",
            # death is handled by the deployment's own healing (a fresh
            # spawn reloads the checkpoint), not the head's restart path —
            # one recovery story instead of two racing ones
            max_restarts=0,
            max_concurrency=self._conf.replica_max_concurrency,
            light=self._conf.replica_light,
        )
        return handle

    def _reconcile(self) -> None:
        """Move the pool to ``_target``. Spawns and drains run OFF the
        lock; membership mutations under it."""
        while True:
            with self._lock:
                if self._closed:
                    return
                current = len(self._handles)
                target = self._target
            if current < target:
                try:
                    handle = self._spawn_one()
                except (ClusterError, OSError):
                    # cluster unreachable (teardown racing a heal tick) or
                    # spawn rejected: serve on with the survivors rather
                    # than wedging the controller in a spawn-retry loop
                    obs.log.warning(
                        "serve replica spawn failed; continuing with "
                        "current pool", deployment=self._name, exc_info=True,
                    )
                    break
                with self._lock:
                    if self._closed or len(self._handles) >= self._target:
                        surplus = True
                    else:
                        self._handles.append(handle)
                        surplus = False
                if surplus:  # lost a race; don't leak the spawn
                    self._kill_quietly(handle)
                else:
                    self.batcher.add_replica(handle)
            elif current > target:
                with self._lock:
                    if len(self._handles) <= self._target:
                        continue
                    victim = self._handles.pop()  # youngest first
                # graceful drain: stop routing, let in-flight finish, kill
                self.batcher.remove_replica(victim.actor_id, drain=True)
                self._kill_quietly(victim)
            else:
                break
        self._g_replicas.set(self.replica_count())

    @staticmethod
    def _kill_quietly(handle) -> None:
        try:
            handle.kill(no_restart=True)
        except Exception:  # raydp-lint: disable=swallowed-exceptions (victim may already be dead; the head GCs either way)
            pass

    def _on_replica_failure(self, handle) -> None:
        # called from a batcher dispatcher thread; the controller's next
        # tick does the actual replacement — the batcher has already
        # stopped routing to the failed id
        obs.log.warning(
            "serve replica failed; healing on next controller tick",
            actor_id=handle.actor_id, deployment=self._name,
        )

    def heal(self) -> int:
        """Resolve batcher-flagged replicas against the head's verdict
        (DEAD or unknown: drop and replace; ALIVE: the failure was a
        transient transport blip, resume routing), probe the rest for
        silent deaths (a replica SIGKILLed while idle never trips a
        dispatcher), then reconcile back to target. Returns the number of
        replicas replaced."""
        with self._lock:
            if self._closed:
                return 0
            snapshot = list(self._handles)
        flagged = set(self.batcher.failed_ids())
        dead = []
        for handle in snapshot:
            gone = False
            try:
                gone = handle.state() == ActorState.DEAD
            except ClusterError:
                gone = True  # unknown to the head = not servable
            if gone:
                dead.append(handle)
            elif handle.actor_id in flagged:
                self.batcher.add_replica(handle)  # transient: clear the flag
        if not dead:
            return 0
        with self._lock:
            for handle in dead:
                if handle in self._handles:
                    self._handles.remove(handle)
        for handle in dead:
            self.batcher.remove_replica(handle.actor_id, drain=False)
        self._m_failovers.inc(len(dead))
        obs.instant(
            "serve.replica_replaced", count=len(dead), deployment=self._name
        )
        self._reconcile()
        return len(dead)

    def replica_count(self) -> int:
        with self._lock:
            return len(self._handles)

    def scale_to(self, n: int) -> None:
        """Explicit scale (also the autoscaler's actuator). Scale-in drains
        gracefully; scale-out spawns warm zygote forks."""
        n = max(1, int(n))
        with self._lock:
            old = self._target
            self._target = n
        if n > old:
            self._m_out.inc(n - old)
        elif n < old:
            self._m_in.inc(old - n)
        self._reconcile()

    # -- request surface ------------------------------------------------

    def predict(self, payload, timeout: Optional[float] = None):
        """Blocking inference; thread-safe — this IS the client."""
        return self.batcher.predict(payload, timeout)

    def submit(self, payload):
        """Async variant: returns a request whose ``.result(timeout)``
        yields the prediction rows."""
        return self.batcher.submit(payload)

    # -- decode streaming (docs/serving.md, "Decode serving") -----------

    def _pick_decode_handle(self):
        with self._lock:
            if not self._handles:
                raise ClusterError("no live replicas")
            handle = self._handles[self._next_stream % len(self._handles)]
            self._next_stream += 1
        return handle

    def stream(self, prompt_tokens, max_new_tokens: int,
               timeout: float = 120.0):
        """Stream generated tokens for one prompt (generator of ints).

        Picks a replica round-robin, submits to its continuous-batching
        decode engine, and polls tokens out as they land. On replica
        death or reload mid-stream the deployment heals and RESUBMITS to
        a survivor with prompt + already-emitted tokens as the prefix —
        the KV cache is re-prefilled there, and because a decode step is
        bit-identical to a prefill over the same tokens (the kernel-family
        parity contract, f32 cache), the continuation carries on with
        exactly the tokens the dead replica would have produced. No token
        is ever emitted twice and none is lost: zero-drop re-admission,
        stream edition.

        Sampled streams (``obs.request_sample_rate``, tracing on) mint ONE
        trace id at admission that survives failover: a ``serve.stream``
        root span here, the engine's prefill child + per-round
        ``serve.decode.step`` fan-in spans on whichever replica serves each
        segment, and a ``serve.stream.failover`` span per re-prefill — one
        trace across driver/head/replica (docs/observability.md)."""
        import random
        import time

        from raydp_tpu_torch.obs import tracing as _tracing
        from raydp_tpu_torch.serve.batcher import _RETRYABLE

        prompt = [int(t) for t in prompt_tokens]
        max_new = int(max_new_tokens)
        emitted: List[int] = []
        t_request = time.monotonic()
        deadline = t_request + timeout
        failovers = 0
        rpc_timeout = self._conf.request_timeout_s
        ctx = None
        if (
            _tracing.enabled()
            and self._conf.request_sample_rate > 0
            and random.random() < self._conf.request_sample_rate
        ):
            ctx = _tracing.mint_context()
        handle = None
        sid = None
        t_first = None
        error = None
        try:
            while True:
                try:
                    handle = self._pick_decode_handle()
                    # the submit RPC runs under the stream's context, so
                    # the head's actor-lookup span and the replica's RPC
                    # hop land in the same trace
                    with _tracing.use_context(ctx):
                        sid = handle.decode_submit.options(
                            timeout=rpc_timeout
                        ).remote(
                            prompt + emitted, max_new - len(emitted),
                            trace_ctx=ctx,
                        ).result()
                    cursor = 0
                    while True:
                        res = handle.decode_poll.options(
                            timeout=rpc_timeout
                        ).remote(sid, cursor).result()
                        new = res["tokens"]
                        cursor += len(new)
                        for tok in new:
                            if t_first is None:
                                t_first = time.monotonic()
                            emitted.append(int(tok))
                            yield int(tok)
                        if res["error"]:
                            # engine-side failure (e.g. retired by a reload
                            # mid-stream): same recovery as a dead replica
                            raise ClusterError(res["error"])
                        if res["done"]:
                            return
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"decode stream timed out after {timeout}s "
                                f"({len(emitted)}/{max_new} tokens)"
                            )
                        time.sleep(0.003)
                except _RETRYABLE + (KeyError,):
                    failovers += 1
                    t_fail = time.monotonic()
                    if failovers > self._conf.max_retries:
                        raise
                    if t_fail > deadline:
                        raise TimeoutError(
                            f"decode stream timed out after {timeout}s "
                            f"({len(emitted)}/{max_new} tokens)"
                        )
                    obs.log.warning(
                        "decode stream failover: re-prefilling on a survivor",
                        deployment=self._name, emitted=len(emitted),
                        exc_info=True,
                    )
                    obs.metrics.counter("serve.decode.failovers").inc()
                    self.heal()
                    if ctx is not None and _tracing.enabled():
                        heal_s = time.monotonic() - t_fail
                        _tracing.record_span(
                            "serve.stream.failover",
                            time.time_ns() // 1000 - int(heal_s * 1e6),
                            int(heal_s * 1e6),
                            trace=ctx[0], parent=ctx[1],
                            emitted=len(emitted), failovers=failovers,
                            deployment=self._name,
                        )
        except BaseException as exc:
            error = repr(exc)[:200]
            raise
        finally:
            t_done = time.monotonic()
            record = {
                "deployment": self._name,
                "handle": handle,
                "stream_id": sid,
                "tokens": len(emitted),
                "failovers": failovers,
                "error": error,
                "wall_s": max(0.0, t_done - t_request),
                "ttft_s": (
                    max(0.0, t_first - t_request)
                    if t_first is not None else None
                ),
                "trace": ctx[0] if ctx else None,
            }
            with self._lock:
                self._last_stream = record
            if ctx is not None and _tracing.enabled():
                _tracing.record_span(
                    "serve.stream",
                    time.time_ns() // 1000 - int(record["wall_s"] * 1e6),
                    int(record["wall_s"] * 1e6),
                    trace=ctx[0], span_id=ctx[1], parent=None,
                    deployment=self._name, tokens=len(emitted),
                    failovers=failovers, error=error,
                    ttft_ms=(
                        round(record["ttft_s"] * 1000.0, 3)
                        if record["ttft_s"] is not None else None
                    ),
                )

    def generate(self, prompt_tokens, max_new_tokens: int,
                 timeout: float = 120.0) -> List[int]:
        """Blocking convenience over ``stream``: the full token list."""
        return list(self.stream(prompt_tokens, max_new_tokens, timeout))

    def explain_last_stream(self, top_k: int = 5) -> dict:
        """Decompose the last completed stream's wall time: TTFT into
        queue wait / KV alloc / prefill compute / dispatch, and the steady
        state into step compute / admission churn / batch-fill stall —
        from the serving engine's own stream record plus this client's
        stamps. Works with tracing OFF, exactly like ``explain_last_query``
        / ``explain_last_fit``; returns the ``obs.analysis.explain_stream``
        report with a rendered ``text`` field."""
        with self._lock:
            record = dict(self._last_stream) if self._last_stream else None
        if record is None:
            raise RuntimeError(
                "no stream has completed on this deployment yet"
            )
        engine_record = None
        handle = record.get("handle")
        if handle is not None and record.get("stream_id"):
            try:
                engine_record = handle.decode_explain.options(
                    timeout=self._conf.request_timeout_s
                ).remote(record["stream_id"]).result()
            except Exception:  # raydp-lint: disable=swallowed-exceptions (the serving replica may have died since; the client stamps still attribute what they can)
                engine_record = None
        from raydp_tpu_torch.obs.analysis import explain_stream

        return explain_stream(record, engine_record, top_k=top_k)

    def decode_stats(self) -> List[dict]:
        """Per-replica decode engine stats (inflight/queued/KV/goodput/veto
        causes) — empty dicts for replicas that never streamed."""
        with self._lock:
            snapshot = list(self._handles)
        return [h.decode_stats.remote().result() for h in snapshot]

    # -- lifecycle ------------------------------------------------------

    def reload(self) -> List[dict]:
        """Rolling checkpoint reload: one replica at a time picks up the
        newest committed checkpoint; old weights serve until each replica's
        new generation is warm. Returns the per-replica info dicts."""
        with self._lock:
            snapshot = list(self._handles)
        infos = []
        with obs.span("serve.reload", deployment=self._name,
                      replicas=len(snapshot)):
            for handle in snapshot:
                infos.append(handle.reload.remote().result())
        self._m_reloads.inc()
        return infos

    def infos(self) -> List[dict]:
        with self._lock:
            snapshot = list(self._handles)
        return [h.info.remote().result() for h in snapshot]

    def profile(self, payload=None) -> dict:
        """Capture one replica's warm inference under the compute
        observatory (``ModelReplica.profile``): the first live replica
        runs a ``torch.profiler`` capture (the card's kernels included)
        of one inference and returns the capture summary —
        on-demand, never on the request path."""
        with self._lock:
            snapshot = list(self._handles)
        if not snapshot:
            raise RuntimeError("no live replicas to profile")
        return snapshot[0].profile.remote(payload).result()

    def stats(self) -> dict:
        out = self.batcher.stats()
        out["target_replicas"] = self._target
        out["doorbell_pooled"] = int(
            obs.metrics.counter("serve.doorbell_pooled").value
        )
        return out

    def _teardown(self) -> None:
        controller = getattr(self, "controller", None)
        if controller is not None:
            controller.close()
        batcher = getattr(self, "batcher", None)
        if batcher is not None:
            batcher.close()
        with self._lock:
            self._closed = True
            victims = list(self._handles)
            self._handles.clear()
        for handle in victims:
            self._kill_quietly(handle)
        self._g_replicas.set(0)

    def close(self) -> None:
        """Stop serving: controller and batcher threads join (pending
        requests fail with a closed error), replicas are killed. Idempotent;
        call before ``cluster.shutdown()`` so the leak audit stays clean."""
        with self._lock:
            if self._closed:
                return
        self._teardown()

    def __enter__(self) -> "Deployment":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def deploy(
    estimator=None,
    *,
    model=None,
    checkpoint_dir: Optional[str] = None,
    name: str = "default",
    replicas: int = 1,
    conf: Optional[dict] = None,
    example=None,
    feature_columns=None,
    device=None,
) -> Deployment:
    """Stand up an online serving deployment for a trained model.

    Pass a fitted/configured ``Estimator`` (its model, feature columns,
    ``checkpoint_dir`` and device are adopted -- weights always travel via
    the checkpoint, never by value) or an explicit ``model`` +
    ``checkpoint_dir``. ``example`` (one feature row) lets replicas warm
    every batch bucket at boot so no request ever pays a warm. ``conf``
    takes ``serve.*`` keys (docs/serving.md). ``device`` is where the
    replicas serve: the card unless ``"cpu"`` is asked for (or the
    estimator's device, when one is passed)."""
    if estimator is not None:
        model = model if model is not None else estimator._model_arg
        checkpoint_dir = checkpoint_dir or estimator.checkpoint_dir
        if feature_columns is None:
            feature_columns = list(estimator.feature_columns) or None
        if device is None:
            device = str(estimator.device)
    if model is None or not checkpoint_dir:
        raise ValueError(
            "deploy needs an estimator, or model= plus checkpoint_dir="
        )
    resolved = ServeConf.resolve(conf)
    decode_kwargs = {}
    if resolved.decode:
        decode_kwargs = {
            "capacity_tokens": resolved.decode_capacity_tokens,
            "page_tokens": resolved.decode_page_tokens,
            "max_seqs": resolved.decode_max_seqs,
            "max_new_tokens": resolved.decode_max_new_tokens,
            "int8_kv": resolved.decode_int8_kv,
            "eos_token": resolved.decode_eos_token,
            "max_mem_pressure": resolved.max_mem_pressure,
            "ttft_slo_ms": resolved.decode_ttft_slo_ms,
            "tpot_slo_ms": resolved.decode_tpot_slo_ms,
            "tenant": resolved.tenant,
        }
    spec = ReplicaSpec(
        model=model,
        checkpoint_dir=checkpoint_dir,
        buckets=resolved.buckets,
        example=example,
        name=name,
        decode=decode_kwargs,
        device=device,
    )
    return Deployment(
        spec, resolved, replicas=replicas, feature_columns=feature_columns
    )
