"""The ETL session's surfaces of the port held against the JAX package's:
``tenancy.fair_share_series``, ``ServeConf.resolve``'s merge of the active
session's configs and ``explain_last_query``.

- ``fair_share_series`` without a cluster (each process's local mirror)
  and with one (one ``obs_query_series`` RPC to the head) after the same
  tenant traffic: the same metrics, and the same newest value of each
  count and gauge (``_same_series``).
- ``ServeConf.resolve`` under a session whose configs hold ``serve.*`` and
  ``obs.*`` keys: defaults < the session's configs < the ``conf``
  argument, every field equal in both packages.
- ``explain_last_query`` after the same shuffle query in each package's
  session: the report's keys, root, the stages and phases on its critical
  path with their categories, from the session method and from the
  package's ``obs``.

One session of each package (1 executor, 1 core), each on its own cluster,
as ``tests/test_torch_etl.py`` runs them; every test under a 90 s alarm.
"""

import dataclasses
import importlib
import signal
import time

import numpy as np
import pandas as pd
import pytest

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")
APP = "etl-surfaces"
CONFIGS = {"serve.max_batch_size": "32", "serve.batch_deadline_ms": "2.5",
           "obs.request_sample_rate": "0.5", "etl.unrelated": "1"}
COUNTED = ("queue_depth", "tasks_dispatched", "quota_rejections",
           "bytes_stored")


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 90 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(90)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def stop_everything():
    """Stop both packages' ETL sessions and clusters (an earlier module of
    this process may have left one up)."""
    for package in PACKAGES:
        importlib.import_module(package + ".etl.session").stop_etl()
        importlib.import_module(package + ".cluster.api").shutdown()


def _module(package, name):
    return importlib.import_module(f"{package}.{name}")


def _traffic(package, tenant, n):
    """``n`` tickets of one tenant through a fair-share scheduler."""
    sched = _module(package, "tenancy.scheduler").FairShareScheduler()
    sched.register(tenant)
    for _ in range(n):
        sched.release(sched.acquire(tenant, 1))


def _same_series(got, want):
    """The same metrics with the same aggregate keys; the same series and
    newest value of each count and gauge. What a window saw between
    samples (a counter's ``delta``, a gauge's ``max`` over a shuffle's
    transient blocks) depends on when each process flushed, and the queue
    wait is a time: their series counts only."""
    assert got.keys() == want.keys()
    for name, agg in got.items():
        assert agg.keys() == want[name].keys(), name
        assert agg["series"] == want[name]["series"], name
    for name in COUNTED:
        assert got[name]["last"] == want[name]["last"], name


def test_fair_share_series_without_a_cluster():
    stop_everything()
    reads = {}
    for package in PACKAGES:
        tenancy = _module(package, "tenancy")
        assert "fair_share_series" in tenancy.__all__
        before = tenancy.fair_share_series("fair-local")
        _traffic(package, "fair-local", 5)
        reads[package] = (before, tenancy.fair_share_series("fair-local"))
    for got, want in zip(*reads.values()):
        _same_series(got, want)
    after = reads["raydp_tpu_torch"][1]
    assert after["tasks_dispatched"]["last"] == 5.0
    assert after["queue_depth"]["series"] == 1


@pytest.fixture(scope="module")
def sessions():
    stop_everything()
    try:
        yield {package: _module(package, "etl.session").init_etl(
            APP, num_executors=1, executor_cores=1, executor_memory="300M",
            configs=dict(CONFIGS)) for package in PACKAGES}
    finally:
        stop_everything()


def _shuffle_query(package, session):
    F = _module(package, "etl.functions")
    rng = np.random.default_rng(3)
    pdf = pd.DataFrame({"k": rng.integers(0, 13, 5000),
                        "v": rng.standard_normal(5000)})
    df = session.from_pandas(pdf, num_partitions=4)
    return df.group_by("k").agg(F.sum("v")).sort("k").to_arrow()


def test_explain_last_query_matches_the_jax_package(sessions):
    reports = {}
    for package, session in sessions.items():
        table = _shuffle_query(package, session)
        assert table.num_rows == 13
        report = session.explain_last_query()
        assert _module(package, "obs").explain_last_query(session)["root"] \
            == "etl.query"
        reports[package] = report
    got, want = reports["raydp_tpu_torch"], reports["raydp_tpu"]
    assert set(got) == set(want)
    assert got["root"] == want["root"] == "etl.query"
    # the stages and phases on the critical path, each with its category
    # (how many times a phase shows between stages follows the timing)
    assert {(s["name"], s["category"]) for s in got["segments"]} == \
        {(s["name"], s["category"]) for s in want["segments"]}
    assert set(got["by_category"]) == set(want["by_category"])
    assert got["attributed_frac"] >= 0.90
    assert "critical path of etl.query" in got["text"]
    import raydp_tpu_torch

    assert raydp_tpu_torch.explain_last_query()["root"] == "etl.query"


def test_fair_share_series_with_a_cluster(sessions):
    """The sessions' tenant after the same queries, read from the heads
    once each head's series has caught up with its tenant table (a head
    ingests its own tenant gauges about once a second)."""
    reads = {}
    for package, session in sessions.items():
        tenancy = _module(package, "tenancy")
        head_rpc = _module(package, "cluster.api").head_rpc
        _shuffle_query(package, session)
        stored = head_rpc("tenant_list")[session.tenant_ns]["bytes_stored"]
        assert stored > 0
        deadline = time.monotonic() + 20
        while True:
            read = tenancy.fair_share_series(session.tenant_ns)
            if read["bytes_stored"]["last"] == stored:
                break
            assert time.monotonic() < deadline, (package, read, stored)
            time.sleep(0.1)
        reads[package] = read
    got, want = reads["raydp_tpu_torch"], reads["raydp_tpu"]
    _same_series(got, want)
    assert got["tasks_dispatched"]["last"] > 0
    assert got["bytes_stored"]["series"] == 1


def test_serve_conf_resolve_merges_the_session_configs(sessions):
    confs = {}
    for package in PACKAGES:
        ServeConf = _module(package, "serve.config").ServeConf
        confs[package] = ServeConf.resolve({"serve.batch_deadline_ms": 7.0})
        defaults = ServeConf.resolve(None)
        assert defaults.max_batch_size == 32  # the session's, over 64
    got, want = (dataclasses.asdict(c) for c in confs.values())
    assert got == want
    conf = confs["raydp_tpu_torch"]
    assert (conf.max_batch_size, conf.batch_deadline_ms,
            conf.request_sample_rate) == (32, 7.0, 0.5)
