"""The driver's tenant and session registry: the port's copy of
``raydp_tpu/tenancy/registry.py``.

``tenant_namespace`` folds an app name into a block-namespace- and
metric-safe tenant id; ``scheduler`` is the process's one
:class:`FairShareScheduler`, which every ETL session and a deployment with
``serve.tenant`` register their tenant with. The session half holds a list
of live ETL sessions plus a per-thread "current session" overlay
(``add_session``, ``discard_session``, ``sessions``, ``current_session``,
``use_session``); ``etl.session`` delegates its singleton surface
(``active_session``, ``stop_etl``, the atexit sweep) here, and
``list_tenants`` reads the head's tenant table::

    a = raydp_tpu_torch.init_etl("dashboards", ...)
    b = raydp_tpu_torch.init_etl("training", ...)   # attaches as 2nd tenant
    with raydp_tpu_torch.tenancy.use_session(b):
        ...  # active_session() == b on this thread
    raydp_tpu_torch.tenancy.sessions()              # [a, b]
"""

from __future__ import annotations

import re
import threading
from typing import Any, Dict, List, Optional

from raydp_tpu_torch import sanitize
from raydp_tpu_torch.tenancy.scheduler import FairShareScheduler

# guards the session list and the process scheduler singleton. A leaf:
# held only around list mutation/reads or the singleton's swap, never across
# session construction or an RPC (etl.session's own lock serializes
# init/stop)
_lock = sanitize.named_lock("tenancy.registry", threading.Lock())
_sessions: List[Any] = []  # live + recently-stopped EtlSessions; guarded-by: _lock
_tls = threading.local()  # per-thread current session
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


def add_session(session: Any) -> None:
    with _lock:
        _sessions[:] = [s for s in _sessions if not s._stopped]
        _sessions.append(session)
    _tls.session = session


def discard_session(session: Any) -> None:
    with _lock:
        _sessions[:] = [
            s for s in _sessions if s is not session and not s._stopped
        ]
    if getattr(_tls, "session", None) is session:
        _tls.session = None


def sessions() -> List[Any]:
    """Every LIVE session on this driver, in creation order."""
    with _lock:
        return [s for s in _sessions if not s._stopped]


def current_session() -> Optional[Any]:
    """This thread's session (``use_session`` / the thread that created it),
    falling back to the most recently created live session — which is
    exactly the old single-session ``active_session()`` contract."""
    session = getattr(_tls, "session", None)
    if session is not None and not session._stopped:
        return session
    with _lock:
        for session in reversed(_sessions):
            if not session._stopped:
                return session
    return None


class use_session:
    """Bind a session as this THREAD's current one (``active_session()``,
    estimator/serve session discovery) for the scope. Nests; restores the
    previous binding on exit."""

    def __init__(self, session: Any):
        self._session = session
        self._prev: Any = None

    def __enter__(self):
        self._prev = getattr(_tls, "session", None)
        _tls.session = self._session
        return self._session

    def __exit__(self, *exc) -> None:
        _tls.session = self._prev


def list_tenants() -> Dict[str, dict]:
    """The head's tenant table: one record per named tenant with active
    flag, fair-share weight, quota, and live block/byte accounting."""
    from raydp_tpu_torch.cluster import api as cluster_api

    return cluster_api.head_rpc("tenant_list")
