"""The port's obs shipped to its cluster head, with plain actors in the
places of the JAX package's ETL executors (``tests/test_observability.py``):

- ``dump_metrics`` merges the processes' registries on the head;
- a spawned actor's spans ship under its ``worker:<actor_id>`` track, linked
  to the driver's trace through the RPC frame;
- a scrape of the head's Prometheus endpoint round-trips and agrees with
  ``dump_metrics``;
- ``query_metrics`` reads windowed series and aggregates from the head;
- the head ring's capacity is configurable and its evictions are counted by
  role;
- a SIGKILLed actor gets a crash dossier with its shipped rings, and the
  dossier has the keys and sections the JAX head writes for the same
  scenario (each package run in its own subprocess);
- a flush in a process that never initialised CUDA does not ask the driver
  for a device count (``torch.cuda.is_available`` is never called);
- a ring half full ships itself to the head, as the JAX package's does.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from raydp_tpu_torch import cluster, obs
from raydp_tpu_torch.cluster import api as capi
from raydp_tpu_torch.obs import tracing
from raydp_tpu_torch.obs.timeseries import parse_prometheus_text, scrape

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_GLOBAL_ZYGOTE = "RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"


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


def wait_until(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


class Worker:
    """A plain actor doing what an executor's dispatch does for obs: a span
    per task, a counter, and a flush that ships them."""

    def work(self, n):
        from raydp_tpu_torch import obs as wobs

        for i in range(n):
            with wobs.span("worker.task", i=i):
                wobs.metrics.counter("worker.tasks_run").inc()
        wobs.flush()
        return n

    def pid(self):
        return os.getpid()


@pytest.fixture(scope="module")
def traced_cluster():
    saved = {k: os.environ.get(k) for k in (NO_GLOBAL_ZYGOTE,)}
    os.environ[NO_GLOBAL_ZYGOTE] = "1"
    was_enabled = tracing.enabled()
    tracing.set_enabled(True)
    cluster.init(num_cpus=4)
    worker = cluster.spawn(Worker, name="obs-worker", light=True,
                           env={"RAYDP_TPU_TRACE": "1"})
    try:
        yield worker
    finally:
        worker.kill()
        cluster.shutdown()
        tracing.set_enabled(was_enabled)
        tracing.drain_local()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def test_dump_metrics_merges_processes(traced_cluster):
    assert traced_cluster.work.remote(3).result() == 3
    merged = cluster.dump_metrics()
    driver_keys = [k for k in merged if k.startswith("driver:")]
    assert driver_keys
    assert merged[driver_keys[0]]["rpc.client.calls"]["value"] > 0
    worker_key = next(k for k in merged
                      if k.startswith(f"worker:{traced_cluster.actor_id}:"))
    assert merged[worker_key]["worker.tasks_run"]["value"] >= 3
    assert any(k.startswith("head:") for k in merged)


def test_actor_spans_ship_under_its_track_and_the_callers_trace(traced_cluster,
                                                              tmp_path):
    with obs.span("driver.stage") as stage:
        traced_cluster.work.remote(2).result()
    path = cluster.export_trace(str(tmp_path / "trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert all({"ph", "ts", "pid", "tid", "name"} <= set(e) for e in events)
    tracks = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    tasks = [e for e in events if e["name"] == "worker.task"
             and e["args"]["trace_id"] == stage.trace]
    assert len(tasks) == 2
    assert all(tracks[e["pid"]].startswith(f"worker:{traced_cluster.actor_id} ")
               for e in tasks)
    assert any(e["name"] == "driver.stage" for e in events)


def test_scrape_endpoint_round_trip(traced_cluster):
    traced_cluster.work.remote(1).result()
    settings = cluster.head_rpc("obs_configure", scrape_port=0)
    host, port = settings["scrape_addr"]
    assert capi.scrape_addr() == (host, port)
    obs.flush()  # the driver's registry must be on the head before scraping
    parsed = parse_prometheus_text(scrape(host, port))
    assert parsed, "scrape did not parse"
    merged = cluster.dump_metrics()
    driver_key = next(k for k in merged if k.startswith("driver:"))
    worker_key = next(k for k in merged if k.startswith("worker:"))
    prom = parsed["raydp_worker_tasks_run_total"]
    labels = next(lb for lb in prom if ("proc", worker_key) in lb)
    assert prom[labels] == merged[worker_key]["worker.tasks_run"]["value"]
    assert ("role", "worker") in labels
    assert any(("proc", driver_key) in lb
               for lb in parsed["raydp_rpc_client_calls_total"])


def test_query_metrics_windowed(traced_cluster):
    before = capi.query_metrics("worker.tasks_run", window_s=600.0,
                                aggregate=True)
    traced_cluster.work.remote(4).result()
    series = capi.query_metrics("worker.tasks_run", window_s=600.0)
    workers = [e for e in series if e["labels"]["role"] == "worker"]
    assert workers, series
    for entry in workers:
        assert entry["type"] == "counter"
        assert entry["points"] and entry["last"] >= 4
    after = capi.query_metrics("worker.tasks_run", window_s=600.0,
                               aggregate=True)
    assert after["last"] >= before.get("last", 0) + 4, (before, after)


def test_head_ring_conf_and_eviction_counters(traced_cluster):
    original = cluster.head_rpc("obs_configure")["head_ring_spans"]
    try:
        small = cluster.head_rpc("obs_configure", head_ring_spans=8)
        assert small["head_ring_spans"] == 8
        span = {"name": "synthetic", "ts": 0, "dur": 1, "pid": 7, "tid": 0,
                "proc": "worker:actor-synth", "trace": "t", "id": "s",
                "parent": None, "args": {}}
        for batch in range(4):
            cluster.head_rpc(
                "obs_ingest", proc={"role": "worker:actor-synth", "pid": 7},
                spans=[dict(span, id=f"s{batch}-{i}") for i in range(8)],
                metrics_snapshot={},
            )
        merged = cluster.dump_metrics()
        head_key = next(k for k in merged if k.startswith("head:"))
        evictions = {name: snap["value"]
                     for name, snap in merged[head_key].items()
                     if name.startswith("obs.ingest_evictions.")}
        assert evictions.get("obs.ingest_evictions.worker", 0) >= 8
    finally:
        cluster.head_rpc("obs_configure", head_ring_spans=original)


DOSSIER_SCENARIO = """
import glob, json, os, signal, sys, time
PKG = sys.argv[1]
os.environ["RAYDP_TPU_NO_GLOBAL_ZYGOTE"] = "1"
os.environ["RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"] = "1"
import importlib
cluster = importlib.import_module(PKG + ".cluster")
api = importlib.import_module(PKG + ".cluster.api")

class Victim:
    def work(self):
        obs = importlib.import_module(PKG + ".obs")
        recorder = importlib.import_module(PKG + ".obs.recorder")
        tracing = importlib.import_module(PKG + ".obs.tracing")
        with obs.span("worker.task"):
            obs.metrics.counter("serve.decode.tokens").inc(7)
            obs.metrics.gauge("serve.decode.inflight").set(2)
        recorder.note_log("INFO", tracing.process_role(), "serve.decode.state",
                          {"inflight": [{"stream": "s0", "tokens": 7}],
                           "queued": 1})
        obs.flush()
        return os.getpid()

cluster.init(num_cpus=2)
v = cluster.spawn(Victim, name="victim", light=True,
                  env={"RAYDP_TPU_TRACE": "1"})
pid = v.work()
os.kill(pid, signal.SIGKILL)
pattern = os.path.join(cluster.session_dir(), "dossiers", "dossier-*.json")
deadline = time.monotonic() + 10
found = None
while found is None:
    assert time.monotonic() < deadline, "no dossier"
    for path in glob.glob(pattern):
        with open(path) as f:
            d = json.load(f)
        if d["victim"].get("actor_id") == v.actor_id:
            found = d
    time.sleep(0.05)
rings = found["victim_rings"]
print(json.dumps({
    "reason": found["reason"],
    "keys": sorted(found),
    "victim": sorted(found["victim"]),
    "head": sorted(found["head"]),
    "actor_row": sorted(found["head"]["actors"][0]),
    "ring_keys": sorted(rings[0]),
    "ring_is_victims": all(v.actor_id in r["proc"] for r in rings),
    "ring_spans": [s["name"] for r in rings for s in r["spans"]],
    "decode": [{"keys": sorted(s), "state": s["state"]["fields"],
                "metrics": sorted(s["metrics"])} for s in found["decode"]],
    "lock_graph_is_list": isinstance(found.get("lock_order_graph"), list),
}))
cluster.shutdown()
"""


def _dossier(package: str, tmp_path) -> dict:
    script = tmp_path / f"dossier_{package}.py"
    script.write_text(textwrap.dedent(DOSSIER_SCENARIO))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + sys.path)
    env["JAX_PLATFORMS"] = "cpu"
    env["RAYDP_TPU_SANITIZE"] = "lockdep,leaks"
    for var in ("RAYDP_TPU_SESSION", "RAYDP_TPU_HEAD_ADDR", "RAYDP_TPU_TOKEN",
                "RAYDP_TPU_TORCH_SESSION", "RAYDP_TPU_TORCH_HEAD_ADDR",
                "RAYDP_TPU_TORCH_TOKEN", "RAYDP_TPU_DOSSIER_DIR"):
        env.pop(var, None)
    run = subprocess.run([sys.executable, str(script), package],
                         capture_output=True, text=True, timeout=50, env=env,
                         cwd=str(tmp_path))
    assert run.returncode == 0, f"{package}:\n{run.stdout}\n{run.stderr}"
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_crash_dossier_on_sigkill_matches_the_jax_head(tmp_path):
    got = _dossier("raydp_tpu_torch", tmp_path)
    want = _dossier("raydp_tpu", tmp_path)
    assert got == want
    assert got["reason"] == "actor_crashed"
    assert got["ring_is_victims"] and "worker.task" in got["ring_spans"]
    assert got["decode"][0]["state"] == {
        "inflight": repr([{"stream": "s0", "tokens": 7}]), "queued": "1"}
    assert "serve.decode.tokens" in got["decode"][0]["metrics"]
    assert got["lock_graph_is_list"] and "lock_order_graph" in got["keys"]


PRESSURE_SCENARIO = """
import json, os, sys, tempfile, time
PKG = sys.argv[1]
os.environ["RAYDP_TPU_NO_GLOBAL_ZYGOTE"] = "1"
os.environ["RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE"] = "1"
os.environ["RAYDP_TPU_TRACE_BUFFER"] = "16"
import importlib
cluster = importlib.import_module(PKG + ".cluster")
obs = importlib.import_module(PKG + ".obs")
tracing = importlib.import_module(PKG + ".obs.tracing")
cluster.init(num_cpus=2)
tracing.set_enabled(True)
tracing.drain_local()
for i in range(40):
    with obs.span("pressure.span", i=i):
        pass
    # one span at a time: the flush a half-full ring starts ends first
    deadline = time.monotonic() + 10
    while tracing._flush_inflight.is_set():
        assert time.monotonic() < deadline, "the pressure flush did not end"
        time.sleep(0.001)
obs.flush()
path = os.path.join(tempfile.mkdtemp(), "trace.json")
cluster.export_trace(path)
with open(path) as f:
    trace = json.load(f)
events = trace["traceEvents"] if isinstance(trace, dict) else trace
print(json.dumps({
    "spans": [e["args"]["i"] for e in events if e.get("name") == "pressure.span"],
    "dropped": tracing.dropped_count()}))
cluster.shutdown()
"""


def test_half_full_ring_flushes_like_the_jax_package(tmp_path):
    """A ring of 16 (``RAYDP_TPU_TRACE_BUFFER``) given 40 spans under a
    cluster: once it is half full it ships itself on a background thread,
    so the head holds every span, in order, and nothing is dropped; the
    same in both packages (each in its own subprocess)."""
    script = tmp_path / "pressure.py"
    script.write_text(textwrap.dedent(PRESSURE_SCENARIO))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + sys.path)
    env["JAX_PLATFORMS"] = "cpu"
    for var in ("RAYDP_TPU_SESSION", "RAYDP_TPU_HEAD_ADDR", "RAYDP_TPU_TOKEN",
                "RAYDP_TPU_TORCH_SESSION", "RAYDP_TPU_TORCH_HEAD_ADDR",
                "RAYDP_TPU_TORCH_TOKEN"):
        env.pop(var, None)
    got = {}
    for package in ("raydp_tpu_torch", "raydp_tpu"):
        run = subprocess.run([sys.executable, str(script), package],
                             capture_output=True, text=True, timeout=25,
                             env=env, cwd=str(tmp_path))
        assert run.returncode == 0, f"{package}:\n{run.stdout}\n{run.stderr}"
        got[package] = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"] == {"spans": list(range(40)), "dropped": 0}


def test_flush_never_asks_the_driver_for_a_device_count(monkeypatch):
    """In a process that never initialised CUDA (a zygote, the head, an
    actor before it touches the card), a flush and a forced memory sample
    must not call ``torch.cuda.is_available``: that call initialises the
    CUDA driver, and a zygote that did so forks children that cannot use
    the card."""
    assert not torch.cuda.is_initialized()

    def refuse():
        raise AssertionError("torch.cuda.is_available was called")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    obs.sample_memory(force=True)
    tracing.flush()
    from raydp_tpu_torch.obs import profiler

    assert profiler._device_live_bytes() is None
