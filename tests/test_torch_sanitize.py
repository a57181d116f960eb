"""The port's runtime sanitizers (``raydp_tpu_torch/sanitize.py``) against
the cases of ``tests/test_lockdep.py``, each lockdep unit run on both
packages' modules side by side:

- lockdep: a seeded inversion raises :class:`LockOrderError` with both
  stacks in both packages, with the same recorded edges; a three-lock cycle;
  a consistent order, RLock reentrancy, a Condition over a named lock and
  two instances of one lock class stay silent; a plain lock re-acquired by
  its holder is a self-deadlock; with lockdep off nothing is recorded;
- a multithreaded hammer of head RPCs (actor create, lookup, call and kill)
  through the port's cluster, lockdep armed in every process;
- leaks: a seeded fd leak is counted, a tracked shared-memory segment is
  named until it is unlinked, ``leaks-strict`` escalates, the report has the
  JAX package's keys, and a clean init -> spawn -> kill -> shutdown cycle
  audits back to baseline in strict mode.
"""

import os
import signal
import threading
import uuid

import pytest

from raydp_tpu import sanitize as jax_sanitize
from raydp_tpu_torch import cluster
from raydp_tpu_torch import sanitize
from raydp_tpu_torch.cluster.common import unlink_block

BOTH = {"port": sanitize, "jax": jax_sanitize}
ARMED = "donation,lockdep,leaks"


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 60 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(60)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(params=sorted(BOTH))
def san(request, monkeypatch):
    """Each package's sanitizer with the suite's modes armed and a clean
    order graph (edges recorded elsewhere must not couple with these)."""
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED)
    mod = BOTH[request.param]
    mod.reset_lockdep()
    yield mod
    mod.reset_lockdep()


def test_modes_parse_as_the_jax_package(monkeypatch):
    """The suite's ``donation,lockdep,leaks`` arms lockdep and leaks in the
    port, whose sanitizer has no donation half, without an error."""
    for modes in ("", ARMED, "leaks-strict", " lockdep , leaks ", "donation"):
        monkeypatch.setenv("RAYDP_TPU_SANITIZE", modes)
        for name in ("lockdep_enabled", "leaks_enabled", "leaks_strict"):
            assert getattr(sanitize, name)() == getattr(jax_sanitize, name)()
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED)
    assert sanitize.lockdep_enabled() and sanitize.leaks_enabled()
    assert not sanitize.leaks_strict()


def test_lock_order_error_on_seeded_inversion(san):
    a = san.named_lock("t.inv.A")
    b = san.named_lock("t.inv.B")
    with a:
        with b:
            pass
    with pytest.raises(san.LockOrderError) as exc:
        with b:
            with a:  # closes the cycle A -> B -> A
                pass
    message = str(exc.value)
    assert "t.inv.A" in message and "t.inv.B" in message
    assert "this acquisition at" in message
    assert "first recorded on thread" in message
    assert san.lock_order_edges() == [("t.inv.A", "t.inv.B")]


def test_lockdep_three_lock_cycle(san):
    a, b, c = (san.named_lock(f"t.tri.{n}") for n in "ABC")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(san.LockOrderError):
        with c:
            with a:  # A -> B -> C -> A
                pass
    assert san.lock_order_edges() == [("t.tri.A", "t.tri.B"),
                                      ("t.tri.B", "t.tri.C")]


def test_lockdep_consistent_order_stays_silent(san):
    a = san.named_lock("t.ok.A")
    b = san.named_lock("t.ok.B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert san.lock_order_edges() == [("t.ok.A", "t.ok.B")]


def test_lockdep_rlock_reentrancy_not_flagged(san):
    r = san.named_lock("t.re.R", threading.RLock())
    with r:
        with r:
            with r:
                pass
    assert san.lock_order_edges() == []


def test_lockdep_self_deadlock_on_plain_lock(san):
    p = san.named_lock("t.self.P")
    p.acquire()
    try:
        with pytest.raises(san.LockOrderError, match="self-deadlock"):
            p.acquire()
        assert p.acquire(False) is False  # a non-blocking probe is legal
    finally:
        p.release()


def test_condition_over_plain_named_lock(san):
    cond = threading.Condition(san.named_lock("t.cond.plain"))
    with cond:
        assert cond.wait(timeout=0.05) is False
        cond.notify_all()
    assert san.lock_order_edges() == []


def test_lockdep_per_instance_identity_same_name(san):
    lock1 = san.named_lock("t.cls.slot")
    lock2 = san.named_lock("t.cls.slot")
    with lock1:
        with lock2:
            pass
    assert san.lock_order_edges() == []


def test_condition_over_named_lock_is_one_node(san):
    lock = san.named_lock("t.cond.L", threading.RLock())
    cond = threading.Condition(lock)
    seen = []

    def waiter():
        with cond:
            while not seen:
                cond.wait(timeout=1.0)
            seen.append("woke")

    thread = threading.Thread(target=waiter)
    thread.start()
    with lock:
        pass
    with cond:
        seen.append("notify")
        cond.notify_all()
    thread.join(timeout=5)
    assert not thread.is_alive() and "woke" in seen
    assert san.lock_order_edges() == []


def test_lockdep_disabled_is_transparent(san, monkeypatch):
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", "donation")
    a = san.named_lock("t.off.A")
    b = san.named_lock("t.off.B")
    with a:
        with b:
            pass
    with b:
        with a:  # inverted, but the sanitizer is off: plain delegation
            pass
    assert san.lock_order_edges() == []


# ---------------------------------------------------------------------------
# multithreaded hammer through the port's cluster
# ---------------------------------------------------------------------------


class _Cell:
    def __init__(self):
        self.value = 0

    def incr(self):
        self.value += 1
        return self.value


def test_hammer_concurrent_head_rpcs(monkeypatch):
    """Actor create/lookup/call/kill and actor-table reads from several
    driver threads at once: the head serves each under its lockdep-wrapped
    ``head.lock``, so an inversion in the control plane, or a false
    positive, surfaces here as a collected error."""
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED)
    monkeypatch.setenv("RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE", "1")
    cluster.init(num_cpus=8, memory=2 << 30)
    errors = []
    try:
        anchor = cluster.spawn(_Cell, name="hammer-anchor", light=True)

        def actor_churn(tid):
            try:
                for i in range(3):
                    name = f"hammer-{tid}-{i}"
                    handle = cluster.spawn(_Cell, name=name, num_cpus=0.01,
                                           light=True)
                    assert handle.incr.remote().result() == 1
                    assert cluster.get_actor(name) is not None
                    handle.kill(no_restart=True)
            except Exception as exc:  # noqa: BLE001 - collected for the assert
                errors.append(exc)

        def lookup_churn(tid):
            try:
                for _ in range(20):
                    cluster.list_actors()
                    cluster.available_resources()
                    assert anchor.incr.remote().result() >= 1
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = ([threading.Thread(target=actor_churn, args=(t,))
                    for t in range(3)]
                   + [threading.Thread(target=lookup_churn, args=(t,))
                      for t in range(3)])
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=45)
        assert not any(thread.is_alive() for thread in threads), "hammer hung"
        assert errors == [], errors
        assert sanitize.lock_order_edges() is not None
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# leak sanitizer
# ---------------------------------------------------------------------------


def test_leak_report_detects_seeded_fd_leak(san):
    san.snapshot_baseline()
    read_fd, write_fd = os.pipe()
    try:
        report = san.leak_report()
        assert report["fds"] >= 2
    finally:
        os.close(read_fd)
        os.close(write_fd)
    assert san.leak_report()["fds"] < report["fds"]


def test_leak_report_has_the_jax_keys(san):
    assert sorted(san.leak_report()) == sorted(jax_sanitize.leak_report())
    assert sorted(san.leak_report()) == ["fds", "pending_spans", "shm",
                                         "spill", "threads"]


def test_leak_audit_detects_and_clears_a_tracked_segment(monkeypatch):
    """A segment tracked by this process is named until the cluster's
    ``unlink_block`` removes it; ``leaks-strict`` escalates meanwhile."""
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED)
    name = f"rtpu-test-{uuid.uuid4().hex[:12]}"
    path = os.path.join("/dev/shm", name)
    with open(path, "wb") as f:
        f.write(b"leakme" * 1024)
    try:
        sanitize.track_block(name, path)
        assert name in sanitize.leak_report()["shm"]
        monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED + ",leaks-strict")
        with pytest.raises(sanitize.LeakError, match=name):
            sanitize.audit_leaks("test-seeded-leak")
        monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED)
        unlink_block(name)
        assert not os.path.exists(path)
        audited = sanitize.audit_leaks("test-after-unlink")
        assert audited["shm"] == [] and audited["spill"] == []
        from raydp_tpu_torch.obs import metrics

        assert metrics.snapshot()["sanitize.leaked_shm_segments"]["value"] == 0
    finally:
        if os.path.exists(path):
            os.unlink(path)
        sanitize.untrack_block(name)


def test_clean_cycle_audits_back_to_baseline(monkeypatch):
    """init -> spawn -> kill -> shutdown leaves no tracked block behind, and
    the shutdown audit runs without raising in strict mode."""
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED)
    monkeypatch.setenv("RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE", "1")
    cluster.init(num_cpus=2, memory=1 << 30)
    handle = cluster.spawn(_Cell, light=True)
    assert handle.incr() == 1
    handle.kill()
    monkeypatch.setenv("RAYDP_TPU_SANITIZE", ARMED + ",leaks-strict")
    cluster.shutdown()  # audits; would raise LeakError on a leak
    report = sanitize.leak_report()
    assert report["shm"] == [] and report["spill"] == []
