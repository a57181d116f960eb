"""``raydp_tpu_torch.tenancy``: the port's multi-tenant control plane, its
copy of ``raydp_tpu/tenancy``.

- **fair-share dispatch** (:mod:`raydp_tpu_torch.tenancy.scheduler`): a
  weighted deficit-round-robin admission queue with per-tenant in-flight
  quotas and typed over-quota rejection (:class:`TenantQuotaError`); a
  deployment with ``serve.tenant`` acquires one ticket per batch dispatch;
- **per-tenant accounting**: ``tenant.<ns>.*`` metrics (tasks dispatched,
  queue wait, queue depth, quota rejections), which the time-series mirror
  labels by tenant;
- **session registry** (:mod:`raydp_tpu_torch.tenancy.registry`):
  ``init_etl(app_name=...)`` attaches to a running cluster as a named
  tenant; ``active_session()`` is per-thread with the explicit
  multi-session API (:func:`sessions`, :func:`use_session`,
  :func:`current_session`, :func:`list_tenants`).

``fair_share_series`` reads a tenant's fair-share signals as windowed
time-series: from the head when a cluster runs, else from this process's
mirror.
"""

from raydp_tpu_torch.cluster.common import TenantQuotaError
from raydp_tpu_torch.tenancy.registry import (
    current_session,
    list_tenants,
    reset_scheduler,
    scheduler,
    sessions,
    tenant_namespace,
    use_session,
)
from raydp_tpu_torch.tenancy.scheduler import (
    AdmissionHandle,
    FairShareScheduler,
    Ticket,
)



def fair_share_series(tenant: str, window_s: float = 60.0):
    """The tenant's fair-share signals as WINDOWED time-series aggregates:
    queue depth, tasks dispatched, quota rejections, queue-wait p99 and the
    head's byte accounting, keyed like a head scrape's ``tenant="<ns>"``
    labeled series, so policies and dashboards read one signal. One
    ``obs_query_series`` RPC to the head (``bytes_stored`` lives only in the
    head's registry, which it ingests about once a second); with no cluster
    running (or a dead head) this process's local mirror answers. Returns
    ``{metric: windowed-aggregate}``."""
    import os as _os

    from raydp_tpu_torch.cluster import api as _capi
    from raydp_tpu_torch.cluster.common import SESSION_ENV as _SESSION_ENV
    from raydp_tpu_torch.obs import timeseries as _ts
    from raydp_tpu_torch.obs.tracing import flush as _flush

    labels = {"tenant": tenant}
    metrics = (
        "queue_depth", "tasks_dispatched", "quota_rejections",
        "queue_wait_s.p99", "bytes_stored",
    )
    _flush()  # ONE registry ship; the whole group then reads in ONE RPC
    try:
        if _capi.is_initialized() or _os.environ.get(_SESSION_ENV):
            got = _capi.head_rpc(
                "obs_query_series",
                name=[f"tenant.{name}" for name in metrics],
                window_s=window_s, labels=labels, aggregate=True,
                timeout=10.0,
            )
            return {name: got[f"tenant.{name}"] for name in metrics}
    except Exception:  # no cluster, or a dead head: the local mirror answers
        pass
    return {
        name: _ts.local_store.windowed(f"tenant.{name}", window_s, labels)
        for name in metrics
    }


__all__ = [
    "fair_share_series",
    "TenantQuotaError",
    "AdmissionHandle",
    "FairShareScheduler",
    "Ticket",
    "current_session",
    "list_tenants",
    "scheduler",
    "reset_scheduler",
    "sessions",
    "tenant_namespace",
    "use_session",
]
