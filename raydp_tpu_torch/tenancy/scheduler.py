"""Fair-share dispatch scheduler: weighted deficit-round-robin admission;
the port's copy of ``raydp_tpu/tenancy/scheduler.py``.

One :class:`FairShareScheduler` per driver process sits in front of every
dispatch path that names a tenant: in the port, the serving plane's batch
dispatch (``serve.tenant``), through :class:`AdmissionHandle`; the ETL
planner's submits join it with the ETL engine. Each tenant gets:

- an **in-flight task quota** (``tenancy.max_inflight_tasks``): at most that
  many of its tasks dispatched-but-unfinished at once, so one tenant's
  thousand-task shuffle occupies its own quota, not the cluster's patience;
- a **deficit-round-robin** share of admission: waiting tenants are drained
  in rounds, each round crediting ``quantum × weight`` tasks of deficit, so
  a tenant streaming huge stages cannot starve another tenant's one-task
  interactive queries — the interactive tenant earns enough deficit every
  round to admit immediately;
- **backpressure with a typed floor**: an admission that cannot proceed
  BLOCKS the submitting thread (bounded waits re-checked on a short period
  — the serving controller's sustained-signal shape: pressure that
  persists keeps the submitter parked, a burst drains on the next
  release), and a tenant whose
  admission queue is already at ``tenancy.max_queued_requests`` — or whose
  wait exceeds ``tenancy.admission_timeout_s`` — is REJECTED with
  :class:`TenantQuotaError` instead of wedging the queue.

Single-tenant sessions ride a fast path: no other tenant has waiters, so an
admission is one lock acquire + two counter bumps — the tenancy-on
single-session arm stays indistinguishable from tenancy-off in the bench
gates.

Lock discipline: ``tenancy.scheduler`` is a LEAF lock — no RPC, dispatch,
or other named lock is ever taken under it; waits are bounded
(``cond.wait(≤0.25s)`` re-check loops, the head's
``handle_wait_actor_ready`` pattern), so the blocking-under-lock rule stays
clean by construction.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from raydp_tpu_torch import sanitize
from raydp_tpu_torch.cluster.common import TenantQuotaError

__all__ = [
    "FairShareScheduler",
    "AdmissionHandle",
    "Ticket",
    "TenantQuotaError",
]

# tasks of deficit credited per DRR round per unit weight: small enough that
# heavy stages take several rounds (interleaving everyone else), large
# enough that typical interactive stages (1-8 tasks) admit in one round
DRR_QUANTUM = 8


class Ticket:
    """One granted admission: ``tenant`` owes ``cost`` in-flight tasks back
    via ``release``. ``cost == 0`` marks a re-entrant no-op grant (an inner
    dispatch path riding an outer stage's admission on the same thread)."""

    __slots__ = ("tenant", "cost")

    def __init__(self, tenant: str, cost: int):
        self.tenant = tenant
        self.cost = cost


class _TenantState:
    __slots__ = (
        "name", "weight", "max_inflight", "max_queued", "timeout_s",
        "inflight", "deficit", "waiters", "active",
        "m_dispatched", "m_rejections", "m_wait", "g_queue",
    )

    def __init__(
        self, name: str, weight: float, max_inflight: int,
        max_queued: int, timeout_s: float,
    ):
        self.name = name
        self.weight = max(0.01, float(weight))
        self.max_inflight = max(1, int(max_inflight))
        self.max_queued = max(1, int(max_queued))
        self.timeout_s = float(timeout_s)
        self.inflight = 0
        self.deficit = 0.0
        # FIFO of [cost, admitted-flag] cells; head-of-line only — a
        # tenant's own stages admit in submission order
        self.waiters: deque = deque()
        self.active = True
        # instruments pre-created OUTSIDE the scheduler lock (instrument
        # creation takes the registry lock; inc/observe after that are
        # lock-free) — and eagerly, so dump_metrics always carries the
        # per-tenant keys (the pinned-schema contract)
        from raydp_tpu_torch import obs

        self.m_dispatched = obs.metrics.counter(
            f"tenant.{name}.tasks_dispatched"
        )
        self.m_rejections = obs.metrics.counter(
            f"tenant.{name}.quota_rejections"
        )
        self.m_wait = obs.metrics.histogram(f"tenant.{name}.queue_wait_s")
        self.g_queue = obs.metrics.gauge(f"tenant.{name}.queue_depth")


class FairShareScheduler:
    """The process-wide admission arbiter (see module docstring)."""

    def __init__(self, quantum: int = DRR_QUANTUM, record: bool = False):
        self.quantum = max(1, int(quantum))
        self._cond = threading.Condition(
            sanitize.named_lock("tenancy.scheduler", threading.Lock())
        )
        self._tenants: "OrderedDict[str, _TenantState]" = OrderedDict()  # guarded-by: self._cond
        # white-box evidence for the DRR tests: (tenant, cost) per admission
        self._admission_log: Optional[List[Tuple[str, int]]] = (
            [] if record else None
        )  # guarded-by: self._cond

    # -- membership -----------------------------------------------------

    def register(
        self,
        tenant: str,
        weight: float = 1.0,
        max_inflight: int = 64,
        max_queued: int = 64,
        timeout_s: float = 300.0,
    ) -> None:
        """Admit a tenant (idempotent: re-registering updates its knobs but
        keeps accumulated in-flight accounting — a session restart under the
        same name must not forget tasks still in flight)."""
        state = _TenantState(tenant, weight, max_inflight, max_queued, timeout_s)
        with self._cond:
            existing = self._tenants.get(tenant)
            if existing is not None:
                existing.weight = state.weight
                existing.max_inflight = state.max_inflight
                existing.max_queued = state.max_queued
                existing.timeout_s = state.timeout_s
                existing.active = True
            else:
                self._tenants[tenant] = state
            self._cond.notify_all()

    def unregister(self, tenant: str) -> None:
        """A tenant's session stopped: admit every parked waiter (their
        dispatches fail fast against the dead pool — far better than parking
        threads on a queue nobody will ever drain) and drop the state once
        nothing is in flight."""
        with self._cond:
            state = self._tenants.get(tenant)
            if state is None:
                return
            state.active = False
            while state.waiters:
                cost, cell = state.waiters.popleft()
                cell[0] = True
                state.inflight += cost
            state.g_queue.set(0)
            if state.inflight <= 0:
                del self._tenants[tenant]
            self._cond.notify_all()

    def handle(self, tenant: str) -> "AdmissionHandle":
        return AdmissionHandle(self, tenant)

    # -- admission ------------------------------------------------------

    def acquire(
        self, tenant: str, cost: int, timeout_s: Optional[float] = None
    ) -> Ticket:
        """Block until ``tenant`` may dispatch ``cost`` more tasks (DRR
        order across tenants, FIFO within one). Raises the typed quota error
        when the tenant's admission queue is full or the bounded wait runs
        out — reject-fast, never wedge."""
        with self._cond:
            state = self._tenants.get(tenant)
            if state is None:
                # unknown tenant (scheduler disabled mid-flight, tests):
                # admit untracked rather than failing the dispatch
                return Ticket(tenant, 0)
            # a stage wider than the tenant's whole quota admits as one
            # full-quota ticket (it alone saturates the tenant — that IS
            # the throttle); uncapped it could never be admitted at all
            cost = max(1, min(int(cost), state.max_inflight))
            if (
                not state.waiters
                and state.inflight + cost <= state.max_inflight
                and not self._others_waiting(tenant)
            ):
                # single-tenant / uncontended fast path
                state.inflight += cost
                self._note_admit(state, cost)
                return Ticket(tenant, cost)
            if len(state.waiters) >= state.max_queued:
                state.m_rejections.inc()
                err = TenantQuotaError(
                    f"tenant {tenant!r} admission queue is full "
                    f"({state.max_queued} waiting stage dispatches) — "
                    "sustained backpressure escalated to rejection"
                )
                err.tenant = tenant
                raise err
            cell = [False]
            entry = (cost, cell)
            state.waiters.append(entry)
            state.g_queue.set(len(state.waiters))
            t0 = time.monotonic()
            deadline = t0 + (
                state.timeout_s if timeout_s is None else float(timeout_s)
            )
            self._drain_locked()
            while not cell[0]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # remove OUR entry by identity: two waiters with equal
                    # (cost, [False]) shapes compare ==, and removing the
                    # wrong one would orphan a stranger's admission
                    for i, e in enumerate(state.waiters):
                        if e is entry:
                            del state.waiters[i]
                            break
                    if cell[0]:
                        break  # admitted in the race window after all
                    state.g_queue.set(len(state.waiters))
                    state.m_rejections.inc()
                    err = TenantQuotaError(
                        f"tenant {tenant!r} admission wait exceeded "
                        f"{state.timeout_s if timeout_s is None else timeout_s}s "
                        "(sustained over-quota backpressure)"
                    )
                    err.tenant = tenant
                    raise err
                # bounded re-check period (never an unbounded wait): a
                # missed notify costs at most one period, not a hang
                self._cond.wait(min(remaining, 0.25))
                self._drain_locked()
            state.g_queue.set(len(state.waiters))
            state.m_wait.observe(time.monotonic() - t0)
            # the grant itself (counter + white-box log) was recorded by
            # _drain_locked at admission time, in true DRR order
            return Ticket(tenant, cost)

    def release(self, ticket: Ticket) -> None:
        if ticket.cost <= 0:
            return
        with self._cond:
            state = self._tenants.get(ticket.tenant)
            if state is None:
                return
            state.inflight = max(0, state.inflight - ticket.cost)
            if not state.active and state.inflight <= 0 and not state.waiters:
                del self._tenants[ticket.tenant]
            else:
                self._drain_locked()
            self._cond.notify_all()

    # -- internals (all guarded-by: self._cond held) --------------------

    def _others_waiting(self, tenant: str) -> bool:  # guarded-by: self._cond held
        return any(
            s.waiters for name, s in self._tenants.items() if name != tenant
        )

    def _note_admit(self, state: _TenantState, cost: int) -> None:  # guarded-by: self._cond held
        state.m_dispatched.inc(cost)
        if self._admission_log is not None:
            self._admission_log.append((state.name, cost))

    def _drain_locked(self) -> None:  # guarded-by: self._cond held
        """Deficit-round-robin: each round credits every waiting tenant
        ``quantum × weight`` and admits from its queue head while both the
        deficit and the in-flight quota allow. Rounds repeat until a full
        round admits nothing — so an interactive tenant's cheap stage never
        waits behind more than one round of a heavy tenant's backlog."""
        progress = True
        admitted_any = False
        while progress:
            progress = False
            for state in list(self._tenants.values()):
                if not state.waiters:
                    state.deficit = 0.0  # classic DRR: idle queues bank nothing
                    continue
                state.deficit = min(
                    state.deficit + self.quantum * state.weight,
                    # bounded: enough for the head waiter plus one round —
                    # an un-admittable head (quota-blocked) must not bank
                    # unbounded credit for later
                    float(state.waiters[0][0] + self.quantum * state.weight),
                )
                while state.waiters:
                    cost, cell = state.waiters[0]
                    if state.inflight + cost > state.max_inflight:
                        break  # quota: its own releases will re-drain
                    if state.deficit < cost:
                        break  # out of this round's share
                    state.waiters.popleft()
                    state.deficit -= cost
                    state.inflight += cost
                    cell[0] = True
                    self._note_admit(state, cost)
                    progress = True
                    admitted_any = True
                state.g_queue.set(len(state.waiters))
        if admitted_any:
            self._cond.notify_all()

    # -- introspection --------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        with self._cond:
            return {
                name: {
                    "weight": s.weight,
                    "inflight": s.inflight,
                    "max_inflight": s.max_inflight,
                    "queued": len(s.waiters),
                    "deficit": round(s.deficit, 3),
                    "active": s.active,
                }
                for name, s in self._tenants.items()
            }

    def admission_log(self) -> List[Tuple[str, int]]:
        with self._cond:
            return list(self._admission_log or [])


class AdmissionHandle:
    """One tenant's bound view of the scheduler, shared by that tenant's
    planner and serve dispatchers. Thread-RE-ENTRANT: a nested dispatch path
    (a compiled program falling back to the staged submit, a reduce round
    launched inside the map gather) rides the outer stage's ticket instead
    of double-counting — or worse, deadlocking against — its own quota."""

    def __init__(self, scheduler: FairShareScheduler, tenant: str):
        self._scheduler = scheduler
        self.tenant = tenant
        self._tls = threading.local()

    def acquire(
        self, cost: int, timeout_s: Optional[float] = None
    ) -> Optional[Ticket]:
        """A ticket to dispatch ``cost`` tasks, or None when this thread
        already holds one (re-entrant inner path — do not release)."""
        depth = getattr(self._tls, "depth", 0)
        if depth > 0:
            self._tls.depth = depth + 1
            return None
        ticket = self._scheduler.acquire(self.tenant, cost, timeout_s)
        self._tls.depth = 1
        return ticket

    def release(self, ticket: Optional[Ticket]) -> None:
        depth = getattr(self._tls, "depth", 0)
        if ticket is None:
            if depth > 0:
                self._tls.depth = depth - 1
            return
        self._tls.depth = 0
        self._scheduler.release(ticket)
