"""Serving-plane configuration: the port's copy of
``raydp_tpu/serve/config.py``, the one place that parses the ``serve.*``
conf keys (docs/serving.md has the full table).

``ServeConf.resolve`` merges the defaults with the ``conf`` argument. The
JAX package also merges in an active ETL session's ``serve.*`` and
``obs.*`` configs; that merge waits for the ETL session's surfaces
(ROADMAP Queue 1 item 2)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


def _flag(value, default: bool = True) -> bool:
    if value is None:
        return default
    return str(value).lower() in ("1", "true", "yes")


def _buckets(value, max_batch: int) -> Tuple[int, ...]:
    """The batch-shape bucket ladder. Default: powers of two up to
    ``max_batch`` (few warmed shapes, low padding waste). Accepts a sequence
    or a comma-separated string; always sorted, deduped, capped at
    max_batch, and containing max_batch itself so every admissible batch
    has a bucket. A SINGLE bucket (``serve.batch_buckets = [N]``) makes
    every dispatch one fixed shape — the deterministic-shapes mode the
    chaos/recovery byte-identity gates run under (a kernel's numerics are
    bit-stable per shape, not across shapes)."""
    if value is None:
        ladder = []
        b = 1
        while b < max_batch:
            ladder.append(b)
            b *= 2
        ladder.append(max_batch)
        return tuple(ladder)
    if isinstance(value, str):
        value = [int(v) for v in value.replace(",", " ").split()]
    ladder = sorted({int(v) for v in value if 0 < int(v) <= max_batch})
    if not ladder or ladder[-1] != max_batch:
        ladder.append(max_batch)
    return tuple(ladder)


@dataclass
class ServeConf:
    """Resolved serving knobs for one deployment."""

    # -- batching policy ------------------------------------------------
    dynamic_batching: bool = True  # off = one dispatch per request, unpadded
    max_batch_size: int = 64
    batch_deadline_ms: float = 5.0  # oldest queued request's max wait
    buckets: Tuple[int, ...] = ()
    # -- dispatch / failover -------------------------------------------
    dispatchers: int = 4  # concurrent in-flight batches (doorbell conns)
    max_retries: int = 8  # re-admissions per request before it errors out
    request_timeout_s: float = 60.0  # per-dispatch RPC timeout
    # -- autoscaling ----------------------------------------------------
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    tick_s: float = 0.25
    sustained_ticks: int = 3  # the etl.dynamicAllocation.sustainedStages shape
    target_queue_per_replica: float = 8.0  # rows of sustained backlog each
    slo_p99_ms: Optional[float] = None  # latency SLO; breach => scale out
    # scale-out is REFUSED while host memory pressure (the mem.pressure
    # watermark gauge, obs/profiler.py) exceeds this — a hot deployment
    # must not fork replicas into an OOM (conf: autoscale.max_mem_pressure)
    max_mem_pressure: float = 0.95
    # -- replicas -------------------------------------------------------
    replica_light: bool = True  # zygote warm fork (python -S); see docs
    replica_max_concurrency: int = 4
    # -- decode serving (docs/serving.md, "Decode serving") -------------
    # continuous-batching autoregressive decode on each replica: a paged
    # KV cache (on the card, or a shm arena on the CPU) plus a fixed-slot
    # decode loop (serve/decode.py).
    # Opt-in — a deployment that never streams pays nothing for it.
    decode: bool = False
    decode_capacity_tokens: int = 512  # per-sequence max prompt+generation
    decode_page_tokens: int = 128  # KV page granularity
    decode_max_seqs: int = 4  # concurrent decode slots per replica
    decode_max_new_tokens: int = 64  # per-request generation cap
    decode_int8_kv: bool = False  # int8 K/V pages + in-kernel dequant
    decode_eos_token: Optional[int] = None  # early-stop token id
    # per-token deadline SLOs (docs/observability.md, "Decode observatory"):
    # set either and every emitted token is judged against its deadline —
    # first token vs TTFT, token k vs t_first + (k-1)*TPOT — feeding the
    # serve.decode.goodput gauge + good/late token counters. None = no
    # deadline accounting (the default; goodput stays unreported).
    decode_ttft_slo_ms: Optional[float] = None
    decode_tpot_slo_ms: Optional[float] = None
    # -- request-path tracing (docs/observability.md) -------------------
    # fraction of requests that mint a trace context and emit the sampled
    # serve.request / serve.batch / replica span chain (only when tracing
    # is enabled: RAYDP_TPU_TRACE); the per-stage latency HISTOGRAMS are
    # always on regardless. Conf key: ``obs.request_sample_rate``.
    request_sample_rate: float = 0.01
    # -- tenancy (docs/multitenancy.md) ---------------------------------
    # name a tenant and this deployment's batch dispatches ride the
    # process's fair-share admission queue (tenancy/scheduler.py) under
    # that tenant's quota, so a co-tenant's heavy traffic cannot starve
    # this deployment's batches (or vice versa).
    # Empty = unthrottled, the single-tenant behavior.
    tenant: str = ""
    extra: dict = field(default_factory=dict)

    @classmethod
    def resolve(cls, conf: Optional[dict]) -> "ServeConf":
        """Merge precedence: defaults < the ``conf`` argument passed to
        ``deploy``."""
        merged: dict = dict(conf or {})

        def get(key, default=None):
            return merged.get(f"serve.{key}", default)

        max_batch = int(get("max_batch_size", 64))
        out = cls(
            dynamic_batching=_flag(get("dynamic_batching"), True),
            max_batch_size=max_batch,
            batch_deadline_ms=float(get("batch_deadline_ms", 5.0)),
            buckets=_buckets(get("batch_buckets"), max_batch),
            dispatchers=max(1, int(get("dispatchers", 4))),
            max_retries=int(get("max_retries", 8)),
            request_timeout_s=float(get("request_timeout_s", 60.0)),
            autoscale=_flag(get("autoscale.enabled"), False),
            min_replicas=max(1, int(get("autoscale.min_replicas", 1))),
            max_replicas=max(1, int(get("autoscale.max_replicas", 4))),
            tick_s=float(get("autoscale.tick_s", 0.25)),
            sustained_ticks=max(1, int(get("autoscale.sustained_ticks", 3))),
            target_queue_per_replica=float(
                get("autoscale.target_queue_per_replica", 8.0)
            ),
            max_mem_pressure=float(get("autoscale.max_mem_pressure", 0.95)),
            slo_p99_ms=(
                float(get("slo_p99_ms")) if get("slo_p99_ms") is not None
                else None
            ),
            decode=_flag(get("decode.enabled"), False),
            decode_capacity_tokens=int(get("decode.capacity_tokens", 512)),
            decode_page_tokens=int(get("decode.page_tokens", 128)),
            decode_max_seqs=max(1, int(get("decode.max_seqs", 4))),
            decode_max_new_tokens=int(get("decode.max_new_tokens", 64)),
            decode_int8_kv=_flag(get("decode.int8_kv"), False),
            decode_eos_token=(
                int(get("decode.eos_token"))
                if get("decode.eos_token") is not None else None
            ),
            decode_ttft_slo_ms=(
                float(get("decode.ttft_slo_ms"))
                if get("decode.ttft_slo_ms") is not None else None
            ),
            decode_tpot_slo_ms=(
                float(get("decode.tpot_slo_ms"))
                if get("decode.tpot_slo_ms") is not None else None
            ),
            replica_light=_flag(get("replica_light"), True),
            replica_max_concurrency=max(
                2, int(get("replica_max_concurrency", 4))
            ),
            request_sample_rate=float(
                merged.get("obs.request_sample_rate", 0.01)
            ),
            tenant=str(get("tenant", "") or ""),
            extra=merged,
        )
        return out
