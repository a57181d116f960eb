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

``fair_share_series`` (the tenant's signals as windowed time-series) waits
for the ETL session's surfaces (ROADMAP Queue 1 item 2).
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

__all__ = [
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
