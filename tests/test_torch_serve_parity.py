"""The port's serving plane against the JAX package, piece by piece, on
the same seeded numpy inputs (raydp_tpu_torch/{exchange/features,serve}
vs raydp_tpu/{exchange/features,serve}):

- the batch-assembly helpers of ``exchange/features.py``, exactly;
- ``ServeConf.resolve`` (and ``_flag`` / ``_buckets``) over a table of
  conf dicts, exactly;
- ``DynamicBatcher`` with stub replica handles (as
  ``tests/test_decode_serve.py`` drives it): the same payload sequence
  gives the same dispatched (shape, n_valid) list and the same rows back,
  padding never leaks, a request over ``max_batch_size`` is refused;
- ``ServeController.tick`` under injected signals: the same out/in/None
  sequence and the same memory-pressure veto count;
- the ``serve.kv.*`` gauges after the same alloc/append/free script;
- the CPU arena: an ``rtpt-`` segment while the cache lives, none after
  ``close``, and the head's owner-GC unlinks it after its owner actor is
  SIGKILLed.

Every wait polls a condition under a deadline.
"""

import glob
import os
import signal
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from raydp_tpu.exchange import features as jfeat
from raydp_tpu.obs.metrics import metrics as jmetrics
from raydp_tpu.serve import config as jconfig
from raydp_tpu.serve.autoscaler import ServeController as JaxController
from raydp_tpu.serve.batcher import DynamicBatcher as JaxBatcher
from raydp_tpu.serve.kvcache import PagedKVCache as JaxCache
from raydp_tpu_torch.exchange import features as tfeat
from raydp_tpu_torch.obs.metrics import metrics as tmetrics
from raydp_tpu_torch.serve import config as tconfig
from raydp_tpu_torch.serve.autoscaler import ServeController as PortController
from raydp_tpu_torch.serve.batcher import DynamicBatcher as PortBatcher
from raydp_tpu_torch.serve.kvcache import PagedKVCache as PortCache


def wait_until(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _same(a, b) -> bool:
    """Equal container structure, dtypes, shapes and values."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        return (isinstance(a, tuple) and isinstance(b, tuple)
                and len(a) == len(b) and all(map(_same, a, b)))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# exchange/features.py: batch assembly
# ---------------------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(7)
    dense = rng.random((5, 3)).astype(np.float32)
    ids = rng.integers(0, 100, (5, 2)).astype(np.int32)
    return {
        "array": dense,
        "row": dense[0],
        "tuple": (dense, ids),
        "tuple_of_rows": (dense[0], ids[0]),
        "list": dense.tolist(),
        "scalar_list": [1.0, 2.0, 3.0],
        "ints": ids,
    }


@pytest.mark.parametrize("case", sorted(_payloads()))
def test_as_feature_rows_pad_slice_concat_match(case):
    x = _payloads()[case]
    got, ref = tfeat.as_feature_rows(x), jfeat.as_feature_rows(x)
    assert _same(got, ref)
    n = tfeat.f_rows(got)
    assert n == jfeat.f_rows(ref)
    for bucket in (n, n + 1, 8):
        padded = tfeat.pad_rows(got, bucket)
        assert _same(padded, jfeat.pad_rows(ref, bucket))
        # padding repeats the last valid row, never zeros
        assert _same(tfeat.f_slice(padded, n - 1, n), tfeat.f_slice(
            tfeat.fmap(lambda a: np.repeat(a[-1:], bucket - n + 1, 0), got),
            0, 1))
    for lo, hi in ((0, n), (1, n), (0, 1)):
        assert _same(tfeat.f_slice(got, lo, hi), jfeat.f_slice(ref, lo, hi))
    parts = [tfeat.f_slice(got, 0, 1), got, tfeat.f_slice(got, 1, n)]
    assert _same(tfeat.f_concat(parts), jfeat.f_concat(
        [jfeat.f_slice(ref, 0, 1), ref, jfeat.f_slice(ref, 1, n)]))


@pytest.mark.parametrize("kind", ["pandas", "arrow"])
def test_tabular_payloads_match(kind):
    rng = np.random.default_rng(3)
    cols = {c: rng.random(4) for c in ("a", "b", "c")}
    frame = pd.DataFrame(cols) if kind == "pandas" else pa.table(cols)
    order = ["c", "a"]
    assert _same(tfeat.as_feature_rows(frame, order),
                 jfeat.as_feature_rows(frame, order))
    for mod in (tfeat, jfeat):
        with pytest.raises(ValueError, match="feature_columns"):
            mod.as_feature_rows(frame)


def test_assembly_errors_match():
    x = np.zeros((4, 2), np.float32)
    for mod in (tfeat, jfeat):
        with pytest.raises(ValueError, match="exceeds bucket"):
            mod.pad_rows(x, 3)
        with pytest.raises(ValueError, match="at least one"):
            mod.f_concat([])


# ---------------------------------------------------------------------------
# serve/config.py
# ---------------------------------------------------------------------------

CONFS = [
    None,
    {},
    {"serve.max_batch_size": 256},
    {"serve.max_batch_size": 48, "serve.batch_buckets": "4, 16 100 0"},
    {"serve.max_batch_size": 16, "serve.batch_buckets": [16]},
    {"serve.dynamic_batching": "false", "serve.dispatchers": 0,
     "serve.replica_light": "0", "serve.replica_max_concurrency": 1},
    {"serve.autoscale.enabled": "yes", "serve.autoscale.min_replicas": 0,
     "serve.autoscale.max_replicas": 3, "serve.autoscale.tick_s": 0.1,
     "serve.autoscale.sustained_ticks": 0, "serve.slo_p99_ms": "25",
     "serve.autoscale.target_queue_per_replica": 2,
     "serve.autoscale.max_mem_pressure": 0.5},
    {"serve.decode.enabled": True, "serve.decode.capacity_tokens": 2048,
     "serve.decode.page_tokens": 128, "serve.decode.max_seqs": 4,
     "serve.decode.max_new_tokens": 32, "serve.decode.int8_kv": "TRUE",
     "serve.decode.eos_token": "2", "serve.decode.ttft_slo_ms": 50,
     "serve.decode.tpot_slo_ms": "5"},
    {"serve.tenant": "team-a", "obs.request_sample_rate": 1.0,
     "serve.max_retries": 2, "serve.request_timeout_s": "7.5",
     "serve.batch_deadline_ms": 1, "other.key": 3},
]


@pytest.mark.parametrize("conf", CONFS, ids=range(len(CONFS)))
def test_serve_conf_resolve_matches(conf):
    got = tconfig.ServeConf.resolve(conf)
    ref = jconfig.ServeConf.resolve(conf)
    assert vars(got) == vars(ref)


@pytest.mark.parametrize("value", [None, "1", "true", "Yes", "0", "no", 1,
                                   0, True, False, "garbage"])
def test_flag_matches(value):
    for default in (True, False):
        assert tconfig._flag(value, default) == jconfig._flag(value, default)


@pytest.mark.parametrize("value,max_batch", [
    (None, 1), (None, 64), (None, 100), ([3, 1, 3, 500], 64),
    ("8,2 2", 8), ((), 16), ([0, -4], 4), ("1", 1)])
def test_buckets_match(value, max_batch):
    assert tconfig._buckets(value, max_batch) == jconfig._buckets(value, max_batch)


# ---------------------------------------------------------------------------
# serve/batcher.py with stub replica handles
# ---------------------------------------------------------------------------


class _StubInfer:
    """Replica-handle stand-in: records every dispatch's (shape, n_valid)
    and answers as a replica does, the first n_valid rows of its output."""

    def __init__(self, calls, lock):
        self._calls = calls
        self._lock = lock

    def options(self, **kw):
        return self

    def remote(self, padded, n):
        with self._lock:
            self._calls.append((len(tfeat.f0(padded)), int(n)))
        dense = padded[0] if isinstance(padded, tuple) else padded
        out = np.asarray(dense, np.float32).sum(axis=1, keepdims=True) * 2.0

        class _R:
            def result(self, timeout=None):
                return out[: int(n)], 0.001

        return _R()


class _StubHandle:
    def __init__(self, actor_id="stub-replica"):
        self.actor_id = actor_id
        self.calls = []
        self.infer = _StubInfer(self.calls, threading.Lock())


def _payload_script(tuples: bool, seed=11, n=24, max_rows=40):
    """Requests of 1..max_rows rows: dense arrays, or (dense, ids) tuples
    (one container per script: a batch concatenates like containers)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = int(rng.integers(1, max_rows + 1))
        dense = rng.random((rows, 3)).astype(np.float32)
        ids = rng.integers(0, 9, (rows, 2)).astype(np.int32)
        out.append((dense, ids) if tuples else dense)
    return out


def _run_batcher(cls, conf_cls, payloads, buckets, max_batch):
    """Queue every payload before any replica exists, then add one: the
    drain thread pops batches by the row budget alone, so the dispatch
    sequence is a function of the payloads and the conf."""
    conf = conf_cls(max_batch_size=max_batch, buckets=buckets,
                    batch_deadline_ms=1.0, dispatchers=1,
                    request_timeout_s=10.0)
    batcher = cls(conf)
    handle = _StubHandle()
    try:
        reqs = [batcher.submit(p) for p in payloads]
        batcher.add_replica(handle)
        outs = [r.result(30.0) for r in reqs]
        stats = batcher.stats()
    finally:
        batcher.close()
    return handle.calls, outs, stats


@pytest.mark.parametrize("tuples", [False, True], ids=["array", "tuple"])
@pytest.mark.parametrize("buckets,max_batch,max_rows", [
    ((1, 2, 4, 8, 16, 32, 64), 64, 40),  # the default ladder
    ((16,), 16, 16),  # one shape
    ((4, 8), 32, 40),  # oversized requests chunk to the largest bucket
])
def test_batcher_dispatches_and_reassembles_as_the_reference(
        buckets, max_batch, max_rows, tuples):
    payloads = _payload_script(tuples, max_rows=min(max_rows, max_batch))
    got_calls, got, got_stats = _run_batcher(
        PortBatcher, tconfig.ServeConf, payloads, buckets, max_batch)
    ref_calls, ref, ref_stats = _run_batcher(
        JaxBatcher, jconfig.ServeConf, payloads, buckets, max_batch)
    assert got_calls == ref_calls
    assert all(shape in buckets for shape, _ in got_calls)
    for p, out, r in zip(payloads, got, ref):
        dense = p[0] if isinstance(p, tuple) else p
        # each caller gets its own rows back, no padded row
        np.testing.assert_array_equal(
            out, dense.sum(axis=1, keepdims=True).astype(np.float32) * 2.0)
        assert _same(out, r)
    for key in ("queued_rows", "queued_requests", "inflight", "replicas"):
        assert got_stats[key] == ref_stats[key]
    assert set(got_stats["stage_latency"]) == set(ref_stats["stage_latency"])


def test_batcher_refuses_what_the_reference_refuses():
    for cls, conf_cls in ((PortBatcher, tconfig.ServeConf),
                          (JaxBatcher, jconfig.ServeConf)):
        batcher = cls(conf_cls(max_batch_size=8, buckets=(8,)))
        try:
            with pytest.raises(ValueError, match="exceeds serve.max_batch_size"):
                batcher.submit(np.zeros((9, 2), np.float32))
            with pytest.raises(ValueError, match="empty"):
                batcher.submit(np.zeros((0, 2), np.float32))
        finally:
            batcher.close()
        with pytest.raises(RuntimeError, match="closed"):
            batcher.submit(np.zeros((1, 2), np.float32))


class _FailingInfer(_StubInfer):
    """Dies like a SIGKILLed replica on its first ``fail`` dispatches."""

    def __init__(self, calls, lock, fail):
        super().__init__(calls, lock)
        self._fail = fail

    def remote(self, padded, n):
        with self._lock:
            if self._fail > 0:
                self._fail -= 1
                raise ConnectionResetError("replica died")
        return super().remote(padded, n)


def _failover(cls, conf_cls):
    conf = conf_cls(max_batch_size=8, buckets=(8,), batch_deadline_ms=1.0,
                    dispatchers=1, request_timeout_s=10.0)
    failed = []
    batcher = cls(conf, on_replica_failure=lambda h: failed.append(h.actor_id))
    bad, good = _StubHandle("bad"), _StubHandle("good")
    bad.infer = _FailingInfer(bad.calls, threading.Lock(), fail=1)
    try:
        rows = np.arange(12, dtype=np.float32).reshape(6, 2)
        batcher.add_replica(bad)
        req = batcher.submit(rows)
        wait_until(lambda: failed, 30.0, "the failure callback")
        assert batcher.failed_ids() == ["bad"] and batcher.live_replicas() == []
        batcher.add_replica(good)  # re-admitted at the front, served here
        out = req.result(30.0)
        assert req.retries == 1
    finally:
        batcher.close()
    return out, good.calls


def test_batcher_readmits_a_dead_replicas_batch_as_the_reference():
    got, got_calls = _failover(PortBatcher, tconfig.ServeConf)
    ref, ref_calls = _failover(JaxBatcher, jconfig.ServeConf)
    assert _same(got, ref) and got_calls == ref_calls == [(8, 6)]


# ---------------------------------------------------------------------------
# serve/autoscaler.py: the controller's decisions under injected signals
# ---------------------------------------------------------------------------


class _FakeBatcher:
    def inflight_total(self):
        return 0


class _FakeDeployment:
    def __init__(self, replicas):
        self.replicas = replicas
        self.batcher = _FakeBatcher()
        self.heals = 0

    def heal(self):
        self.heals += 1
        return 0

    def replica_count(self):
        return self.replicas

    def scale_to(self, n):
        self.replicas = n


def _signal_script(seed=5, runs=30):
    """Runs of 1-5 like ticks (idle, backlog, an SLO breach under or over
    the memory-pressure limit, light load), so the sustained rule fires
    both ways and the veto holds some scale-outs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(runs):
        kind = int(rng.integers(0, 4))
        for _ in range(int(rng.integers(1, 6))):
            if kind == 0:  # idle
                out.append({"queue_rows": 0.0, "inflight": 0, "p99_ms": 1.0,
                            "mem_pressure": 0.1})
            elif kind == 1:  # backlog
                out.append({"queue_rows": float(rng.integers(20, 80)),
                            "inflight": 2, "p99_ms": 5.0,
                            "mem_pressure": 0.2})
            elif kind == 2:  # SLO breach, memory pressure either side
                out.append({"queue_rows": 1.0, "inflight": 1,
                            "p99_ms": float(rng.integers(60, 90)),
                            "mem_pressure": float(rng.choice([0.5, 0.99]))})
            else:  # light load
                out.append({"queue_rows": 2.0, "inflight": 1,
                            "p99_ms": 20.0, "mem_pressure": 0.3})
    return out


def _decisions(controller_cls, metrics, conf, script):
    feed = iter(script)
    dep = _FakeDeployment(conf.min_replicas)
    veto = metrics.counter("serve.scale_out_vetoed_mem")
    vetoed0 = veto.value
    ctl = controller_cls(dep, conf, signal_fn=lambda: next(feed))
    try:
        out = [(ctl.tick(), dep.replicas) for _ in script]
    finally:
        ctl.close()
    return out, veto.value - vetoed0, dep.heals


@pytest.mark.parametrize("sustained", [1, 3])
def test_controller_ticks_as_the_reference(sustained):
    conf = {"serve.autoscale.enabled": True,
            "serve.autoscale.min_replicas": 1,
            "serve.autoscale.max_replicas": 3,
            # a tick period the thread never reaches: the test ticks
            "serve.autoscale.tick_s": 3600,
            "serve.autoscale.sustained_ticks": sustained,
            "serve.autoscale.target_queue_per_replica": 8,
            "serve.slo_p99_ms": 50,
            "serve.autoscale.max_mem_pressure": 0.9}
    script = _signal_script()
    got = _decisions(PortController, tmetrics,
                     tconfig.ServeConf.resolve(conf), script)
    ref = _decisions(JaxController, jmetrics,
                     jconfig.ServeConf.resolve(conf), script)
    assert got == ref
    decisions = [d for d, _ in got[0]]
    assert "out" in decisions and "in" in decisions and got[1] > 0
    assert got[2] == len(script)  # healing runs on every tick


def test_controller_without_autoscale_only_heals():
    conf = tconfig.ServeConf.resolve({"serve.autoscale.tick_s": 3600})
    dep = _FakeDeployment(2)
    ctl = PortController(dep, conf, signal_fn=lambda: {"queue_rows": 1e9})
    try:
        assert [ctl.tick() for _ in range(5)] == [None] * 5
    finally:
        ctl.close()
    assert dep.heals == 5 and dep.replicas == 2


# ---------------------------------------------------------------------------
# serve/kvcache.py: the serve.kv.* gauges and the CPU arena
# ---------------------------------------------------------------------------

KV_GAUGES = ("bytes", "pages_total", "pages_free", "seqs", "page_occupancy",
             "fragmentation", "used_bytes")


def _gauges(metrics, tenant):
    out = {name: metrics.gauge(f"serve.kv.{name}").value for name in KV_GAUGES}
    out["tenant_bytes"] = metrics.gauge(f"tenant.{tenant}.serve.kv.bytes").value
    return out


def _kv_script(seed=2, steps=40):
    rng = np.random.default_rng(seed)
    live, ops = [], []
    for i in range(steps):
        r = rng.random()
        if r < 0.25 or not live:
            sid = f"s{i}"
            live.append(sid)
            ops.append(("alloc", sid, 0))
        elif r < 0.4:
            ops.append(("free", live.pop(int(rng.integers(len(live)))), 0))
        else:
            ops.append(("append", live[int(rng.integers(len(live)))],
                        int(rng.integers(1, 12))))
    return ops


def _run_kv(cache_cls, metrics, int8, tenant, **kw):
    rng = np.random.default_rng(9)
    readings = []
    cache = cache_cls(layers=2, heads=2, head_dim=8, capacity_tokens=64,
                      page_tokens=8, max_seqs=4, int8=int8, tenant=tenant,
                      **kw)
    lengths = {}
    try:
        readings.append(_gauges(metrics, tenant))
        for op, sid, t in _kv_script():
            if op == "alloc":
                cache.alloc(sid)
                lengths[sid] = 0
            elif op == "free":
                cache.free(sid)
                lengths.pop(sid)
            elif lengths[sid] + t <= 64:
                k = rng.standard_normal((2, 2, t, 8)).astype(np.float32)
                cache.append(sid, k, -k)
                lengths[sid] += t
            readings.append(_gauges(metrics, tenant))
    finally:
        cache.close()
    readings.append(_gauges(metrics, tenant))
    return readings


@pytest.mark.parametrize("int8", [False, True])
def test_kv_gauges_match_the_reference(int8):
    got = _run_kv(PortCache, tmetrics, int8, "team-kv", device="cpu")
    ref = _run_kv(JaxCache, jmetrics, int8, "team-kv")
    assert got == ref
    assert got[0]["pages_total"] == 32 and got[0]["bytes"] > 0
    assert max(r["used_bytes"] for r in got) > 0
    # close zeroes every gauge, the tenant's too
    assert set(got[-1].values()) == {0.0}


def _segments(ns_glob="rtpt-*"):
    return set(glob.glob(f"/dev/shm/{ns_glob}"))


def test_cpu_arena_is_a_store_segment_until_close():
    before = _segments()
    cache = PortCache(layers=2, heads=2, head_dim=8, capacity_tokens=32,
                      page_tokens=8, max_seqs=2, device="cpu")
    try:
        arena = _segments() - before
        assert len(arena) == 1
        assert os.path.getsize(arena.pop()) == cache.nbytes
        cache.alloc("s")
        k = np.ones((2, 2, 3, 8), np.float32)
        cache.append("s", k, 2 * k)
        got_k, got_v = cache.gather(["s"])
        assert torch.equal(got_k[:, 0, :, :3], torch.ones(2, 2, 3, 8))
        assert torch.equal(got_v[:, 0, :, :3], 2 * torch.ones(2, 2, 3, 8))
    finally:
        cache.close()
    assert _segments() - before == set()


class ArenaOwner:
    """An actor that holds a CPU KV cache, as a replica's engine does."""

    def __init__(self):
        self.cache = PortCache(layers=2, heads=2, head_dim=8,
                               capacity_tokens=32, page_tokens=8, max_seqs=2,
                               device="cpu")

    def arena(self):
        return os.getpid(), self.cache._block.object_id


def test_head_unlinks_a_killed_owners_arena(monkeypatch):
    from raydp_tpu_torch import cluster
    from raydp_tpu_torch.store import object_store

    # a session-local zygote, which shutdown stops
    monkeypatch.setenv("RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE", "1")

    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 60 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(60)
    cluster.init(num_cpus=1)
    try:
        owner = cluster.spawn(ArenaOwner, light=True)
        pid, object_id = owner.arena()
        path = "/dev/shm" + object_store._local_shm_name(object_id)
        assert os.path.exists(path)
        assert object_store.owner_of(
            object_store.ObjectRef(object_id, 0)) == owner.actor_id
        os.kill(pid, signal.SIGKILL)
        wait_until(lambda: not os.path.exists(path), 20.0,
                   "the head to unlink the dead owner's arena")
    finally:
        cluster.shutdown()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
