"""The driver's tenant registry: the port's copy of the scheduler half of
``raydp_tpu/tenancy/registry.py``.

``tenant_namespace`` folds an app name into a block-namespace- and
metric-safe tenant id; ``scheduler`` is the process's one
:class:`FairShareScheduler`, which a deployment with ``serve.tenant``
registers its tenant with. The session half (``add_session``,
``sessions``, ``use_session``, ``list_tenants``) comes with the ETL
session.
"""

from __future__ import annotations

import re
import threading
from typing import Optional

from raydp_tpu_torch import sanitize
from raydp_tpu_torch.tenancy.scheduler import FairShareScheduler

# guards the process scheduler singleton. A leaf: held only around the
# singleton's read or swap, never across an RPC
_lock = sanitize.named_lock("tenancy.registry", threading.Lock())
_scheduler: Optional[FairShareScheduler] = None  # guarded-by: _lock


def tenant_namespace(app_name: str) -> str:
    """The block-namespace/metric-safe tenant id derived from an app name:
    dots would collide with the object-id separator, so everything outside
    ``[A-Za-z0-9_-]`` folds to ``-``."""
    return re.sub(r"[^A-Za-z0-9_-]", "-", app_name)


def scheduler() -> FairShareScheduler:
    """The process-wide fair-share scheduler (created on first use)."""
    global _scheduler
    with _lock:
        if _scheduler is None:
            _scheduler = FairShareScheduler()
        return _scheduler


def reset_scheduler() -> None:
    """Drop the process scheduler (tests only -- a fresh scheduler forgets
    every tenant's in-flight accounting)."""
    global _scheduler
    with _lock:
        _scheduler = None
