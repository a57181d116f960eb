"""``raydp_tpu_torch.tenancy``: the port's fair-share admission, the part
of ``raydp_tpu/tenancy`` that the serving plane rides on.

- **fair-share dispatch** (:mod:`raydp_tpu_torch.tenancy.scheduler`): a
  weighted deficit-round-robin admission queue with per-tenant in-flight
  quotas and typed over-quota rejection (:class:`TenantQuotaError`); a
  deployment with ``serve.tenant`` acquires one ticket per batch dispatch;
- **per-tenant accounting**: ``tenant.<ns>.*`` metrics (tasks dispatched,
  queue wait, queue depth, quota rejections), which the time-series mirror
  labels by tenant.

The session registry (many ETL sessions on one cluster, ``use_session``,
``list_tenants``) and ``fair_share_series`` come with the ETL session.
"""

from raydp_tpu_torch.cluster.common import TenantQuotaError
from raydp_tpu_torch.tenancy.registry import (
    reset_scheduler,
    scheduler,
    tenant_namespace,
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
    "scheduler",
    "reset_scheduler",
    "tenant_namespace",
]
