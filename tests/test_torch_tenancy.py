"""The port's fair-share admission (raydp_tpu_torch/tenancy) against the
JAX package's (raydp_tpu/tenancy/{scheduler,registry}.py):

- ``FairShareScheduler``: the same grant order, and the same parked
  waiters, over a seeded script of acquires and releases across weighted
  tenants with in-flight quotas (each acquire runs on its own thread, since
  one that cannot be admitted blocks);
- the typed rejections (a full admission queue, a wait past its timeout);
- ``AdmissionHandle``'s re-entrancy, ``tenant_namespace`` and the
  process scheduler's lifetime.

Every wait polls a condition under a deadline.
"""

import threading
import time

import numpy as np
import pytest

from raydp_tpu import tenancy as jten
from raydp_tpu.tenancy import registry as jregistry
from raydp_tpu.tenancy.scheduler import FairShareScheduler as JaxScheduler
from raydp_tpu_torch import tenancy as tten
from raydp_tpu_torch.cluster.common import TenantQuotaError
from raydp_tpu_torch.tenancy import registry as tregistry
from raydp_tpu_torch.tenancy.scheduler import FairShareScheduler as PortScheduler

# (name, weight, max_inflight)
TENANTS = (("heavy", 1.0, 4), ("interactive", 3.0, 2), ("batch", 0.5, 3))


def wait_until(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _script(seed, steps=80):
    """("acquire", tenant, cost) or ("release",) -- the latter releases the
    oldest ticket granted and not yet released, if any."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        if rng.random() < 0.55:
            name = TENANTS[int(rng.integers(len(TENANTS)))][0]
            ops.append(("acquire", name, int(rng.integers(1, 4))))
        else:
            ops.append(("release",))
    return ops


def _run(cls, script):
    """Play ``script`` against a fresh scheduler; returns its admission log
    (every grant in DRR order) and the parked waiters after each step.
    After each acquire the scheduler is quiescent: the acquire was granted
    or its waiter is parked. The n-th grant of a tenant is its n-th
    acquire (FIFO within a tenant).

    The quantum credits every tenant at least its largest cost a round, so
    only the quotas park waiters: a waiter limited by its deficit would be
    admitted by whichever drain comes next, its own 0.25 s re-check
    included, and the order would follow the clock."""
    sched = cls(quantum=6, record=True)
    for name, weight, inflight in TENANTS:
        sched.register(name, weight=weight, max_inflight=inflight,
                       max_queued=64, timeout_s=60.0)
    pending = {name: [] for name, _, _ in TENANTS}  # acquire slots in order
    tickets, threads, released, queued_after = {}, [], 0, []

    def queued():
        return sum(s["queued"] for s in sched.snapshot().values())

    def acquire(slot, name, cost):
        tickets[slot] = sched.acquire(name, cost)

    def release_oldest():
        nonlocal released
        log = sched.admission_log()
        if released >= len(log):
            return False
        seen = {name: 0 for name in pending}
        for name, _ in log[:released]:
            seen[name] += 1
        name = log[released][0]
        slot = pending[name][seen[name]]
        wait_until(lambda: slot in tickets, 30.0, "the granted ticket")
        sched.release(tickets[slot])
        released += 1
        return True

    for i, op in enumerate(script):
        if op[0] == "acquire":
            _, name, cost = op
            pending[name].append(i)
            grants, parked = len(sched.admission_log()), queued()
            thread = threading.Thread(target=acquire, args=(i, name, cost))
            thread.start()
            threads.append(thread)
            wait_until(lambda: len(sched.admission_log()) > grants
                       or queued() > parked, 30.0, "the acquire to settle")
        else:
            release_oldest()
        queued_after.append(queued())
    while release_oldest() or queued():  # drain: every acquire is granted
        pass
    for thread in threads:
        thread.join(30.0)
        assert not thread.is_alive()
    assert all(s["inflight"] == 0 for s in sched.snapshot().values())
    return sched.admission_log(), queued_after


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grant_order_matches_the_reference(seed):
    script = _script(seed)
    got = _run(PortScheduler, script)
    ref = _run(JaxScheduler, script)
    assert got == ref
    log, queued_after = got
    assert len(log) == sum(op[0] == "acquire" for op in script)
    assert max(queued_after) > 0  # the quotas did park waiters


@pytest.mark.parametrize("cls", [PortScheduler, JaxScheduler],
                         ids=["port", "jax"])
def test_full_queue_and_timeout_reject_with_the_typed_error(cls):
    sched = cls()
    sched.register("t", max_inflight=1, max_queued=1, timeout_s=2.0)
    held = sched.acquire("t", 1)
    outcome = []

    def park():
        try:
            sched.acquire("t", 1)
        except Exception as exc:  # the typed rejection, checked below
            outcome.append(exc)

    parked = threading.Thread(target=park)
    parked.start()
    wait_until(lambda: sched.snapshot()["t"]["queued"] == 1, 10.0,
               "the parked waiter")
    with pytest.raises(Exception, match="admission queue is full") as full:
        sched.acquire("t", 1)
    parked.join(10.0)
    assert not parked.is_alive()
    quota_error = TenantQuotaError if cls is PortScheduler else jten.TenantQuotaError
    assert len(outcome) == 1 and isinstance(outcome[0], quota_error)
    assert "admission wait exceeded" in str(outcome[0])
    with pytest.raises(Exception, match="admission wait exceeded") as late:
        sched.acquire("t", 1, timeout_s=0.05)
    assert {full.value.tenant, late.value.tenant} == {"t"}
    assert type(full.value).__name__ == "TenantQuotaError"
    sched.release(held)
    assert sched.acquire("t", 5).cost == 1  # capped at the quota
    # an unknown tenant is admitted untracked
    assert sched.acquire("nobody", 3).cost == 0


def test_admission_handle_is_reentrant_like_the_reference():
    for sched in (PortScheduler(record=True), JaxScheduler(record=True)):
        sched.register("a", max_inflight=1)
        handle = sched.handle("a")
        outer = handle.acquire(1)
        inner = handle.acquire(1)  # would deadlock against its own quota
        assert outer.cost == 1 and inner is None
        handle.release(inner)
        handle.release(outer)
        assert sched.snapshot()["a"]["inflight"] == 0
        assert sched.admission_log() == [("a", 1)]


@pytest.mark.parametrize("name", ["app", "my.app v2", "ü-x_1", "a/b:c"])
def test_tenant_namespace_matches(name):
    assert tten.tenant_namespace(name) == jten.tenant_namespace(name)


def test_process_scheduler_lives_until_reset():
    first = tregistry.scheduler()
    assert tten.scheduler() is first and isinstance(first, PortScheduler)
    tregistry.reset_scheduler()
    assert tregistry.scheduler() is not first
    assert type(jregistry.scheduler()).__name__ == type(first).__name__
    assert set(tten.__all__) <= set(jten.__all__)
