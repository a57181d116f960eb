"""The process-local rest of the port's obs against the JAX package's
(raydp_tpu_torch/obs/{timeseries,recorder,export,tracing,profiler,analysis}
vs raydp_tpu/obs/...):

- ``SeriesStore`` fed the same snapshots at the same timestamps gives equal
  ``query`` / ``windowed`` results and the identical Prometheus text, which
  ``parse_prometheus_text`` reads back; ``split_labels`` the same labels;
- ``explain_stream`` / ``format_stream_report`` the same report and text
  for the same records;
- the log ring and ``FlightRecorder`` (rings, dossier, its decode section,
  ``write`` / ``list_dossiers``), after the JAX tests
  ``test_flight_recorder_rings_unit`` and
  ``test_dossier_decode_section_from_rings``;
- ``export_trace`` the same events for the same spans;
- ``current_mem_pressure`` the same reading from the same samples, and the
  step-profiler switch;
- the tracing additions: ``set_enabled``, ``mint_context``,
  ``with_context``, ``dropped_count`` (reported by ``dump_metrics`` as
  ``trace.spans_dropped``).

Inputs are made from a seed with numpy. Nothing here is a device
measurement.
"""

import collections
import importlib
import json
import threading
import time

import numpy as np
import pytest

from raydp_tpu.obs import analysis as jax_analysis
from raydp_tpu.obs import export as jax_export
from raydp_tpu.obs import profiler as jax_profiler
from raydp_tpu.obs import recorder as jax_recorder
from raydp_tpu.obs import timeseries as jax_ts
from raydp_tpu.obs import tracing as jax_tracing
from raydp_tpu_torch import obs
from raydp_tpu_torch.obs import (analysis, export, profiler, recorder,
                                 timeseries, tracing)

jax_metrics = importlib.import_module("raydp_tpu.obs.metrics")
port_metrics = importlib.import_module("raydp_tpu_torch.obs.metrics")


@pytest.fixture(autouse=True)
def jax_obs_stays_local(monkeypatch):
    """The JAX package's flush ships spans and log records to a cluster
    head when one is up in this process (another test file's session may
    have left one): keep both packages' records local, as with no
    cluster, so the two are compared on the same records."""
    from raydp_tpu.cluster import api as cluster_api

    monkeypatch.delenv("RAYDP_TPU_SESSION", raising=False)
    monkeypatch.setattr(cluster_api, "is_initialized", lambda: False)
    monkeypatch.setattr(jax_tracing, "_local_ingest", None)


# ---------------------------------------------------------------------------
# time series
# ---------------------------------------------------------------------------


def _snapshots(seed, n):
    """n cumulative registry snapshots: counters rising, gauges (one a
    watermark), histograms with quantiles, tenant-prefixed names."""
    rng = np.random.default_rng(seed)
    out, tokens, steps = [], 0.0, 0.0
    for _ in range(n):
        tokens += float(rng.integers(1, 50))
        steps += float(rng.integers(1, 5))
        lat = np.sort(rng.exponential(3.0, 8))
        hist = {"type": "histogram", "count": int(rng.integers(1, 100)),
                "sum": float(lat.sum()), "min": float(lat[0]),
                "max": float(lat[-1]), "mean": float(lat.mean()),
                "p50": float(lat[4]), "p99": float(lat[-1])}
        out.append({
            "serve.decode.tokens": {"type": "counter", "value": tokens},
            "serve.decode.steps": {"type": "counter", "value": steps},
            "serve.decode.goodput": {"type": "gauge",
                                     "value": float(rng.random())},
            "mem.pressure": {"type": "gauge", "value": float(rng.random()),
                             "max": float(rng.random() + 1.0)},
            "serve.ttft_ms": hist,
            "tenant.acme.serve.tpot_ms": dict(hist, count=hist["count"] + 1),
            "tenant.beta.serve.decode.tokens": {"type": "counter",
                                                "value": tokens * 2},
            "serve.decode.prefill_s": {"type": "histogram", "count": 0,
                                       "sum": 0.0},
        })
    return out


def _fed_stores(seed=0, n=12):
    port, ref = timeseries.SeriesStore(), jax_ts.SeriesStore()
    base = time.time() - 30.0
    for i, snap in enumerate(_snapshots(seed, n)):
        # two processes, points 0.3 s apart; every third ingest within the
        # fold interval of the one before
        ts = base + i * 0.3 + (0.1 if i % 3 == 2 else 0.0)
        proc, role = (("driver:1", "driver") if i % 2 else
                      ("worker:r1:7", "worker:r1"))
        port.ingest(proc, role, snap, ts=ts)
        ref.ingest(proc, role, snap, ts=ts)
    return port, ref


QUERIES = ["serve.decode.tokens", "serve.decode.goodput", "mem.pressure",
           "mem.pressure.max", "serve.ttft_ms.p50", "serve.ttft_ms.count",
           "tenant.serve.tpot_ms.p99", "tenant.serve.decode.tokens",
           "serve.decode.prefill_s.count", "no.such.series"]


@pytest.mark.parametrize("name", QUERIES)
def test_series_store_query_and_windowed_match(name):
    port, ref = _fed_stores()
    for window, labels in ((60.0, None), (5.0, None),
                           (60.0, {"role": "worker"}),
                           (60.0, {"tenant": "acme"})):
        got = port.query(name, window, labels)
        want = ref.query(name, window, labels)
        key = lambda e: sorted(e["labels"].items())  # noqa: E731
        assert sorted(got, key=key) == sorted(want, key=key)
        assert port.windowed(name, window, labels) == \
            ref.windowed(name, window, labels)
    assert port.series_names() == ref.series_names()


def test_prometheus_text_identical_and_round_trips():
    port, ref = _fed_stores(seed=3)
    text = port.prometheus_text()
    assert text == ref.prometheus_text()
    parsed = timeseries.parse_prometheus_text(text)
    assert parsed == jax_ts.parse_prometheus_text(text)
    # every newest point comes back under its exposition name and labels
    for name in port.series_names():
        for entry in port.query(name, 3600.0):
            prom = "raydp_" + timeseries._prom_name(name)
            if entry["type"] == "counter":
                prom += "_total"
            labels = tuple(sorted(
                (timeseries._prom_name(k), v)
                for k, v in entry["labels"].items()))
            assert parsed[prom][labels] == pytest.approx(entry["last"],
                                                         rel=1e-9)


@pytest.mark.parametrize("name,role,proc", [
    ("serve.decode.tokens", "driver", "driver:1"),
    ("tenant.acme.serve.ttft_ms", "worker:r1", "worker:r1:9"),
    ("tenant.x", "", "p:2"),
    ("tenant..serve.tpot_ms", "head", "head:3"),
])
def test_split_labels_match(name, role, proc):
    assert timeseries.split_labels(name, role, proc) == \
        jax_ts.split_labels(name, role, proc)


def test_local_mirror_is_fed_by_flush():
    """``flush`` folds the registry into the local mirror, which
    ``query_local_series`` and ``windowed_local`` read."""
    port_metrics.metrics.counter("test.obs_local.ticks").inc(3)
    tracing.flush()
    series = obs.query_local_series("test.obs_local.ticks", 60.0)
    assert series and series[-1]["last"] >= 3.0
    assert series[-1]["labels"]["role"] == "driver"
    assert timeseries.windowed_local("test.obs_local.ticks")["series"] >= 1


# ---------------------------------------------------------------------------
# explain_stream
# ---------------------------------------------------------------------------


def _stream_records(seed):
    rng = np.random.default_rng(seed)
    queue, kv, prefill = rng.uniform(0.0, 0.05, 3)
    ttft = queue + kv + prefill + float(rng.uniform(0.0, 0.01))
    steady = float(rng.uniform(0.05, 0.5))
    churn = float(rng.uniform(0.0, 0.02))
    engine = {
        "stream_id": f"s{seed}", "prompt_tokens": int(rng.integers(1, 99)),
        "tokens": 32, "steps": 31, "error": None, "trace": "t" * 16,
        "queue_s": queue, "prefill_s": prefill, "kv_alloc_s": kv,
        "step_compute_s": steady * float(rng.uniform(0.8, 1.1)),
        "churn_s": churn, "ttft_s": ttft, "steady_s": steady,
        "wall_s": ttft + steady, "good_tokens": 30, "late_tokens": 2,
    }
    client = {"stream_id": f"s{seed}", "deployment": "lm",
              "wall_s": ttft + steady + float(rng.uniform(0.0, 0.01)),
              "ttft_s": ttft + 0.002, "tokens": 32, "failovers": 0}
    return client, engine


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_explain_stream_matches(seed):
    client, engine = _stream_records(seed)
    for args in ((client, engine), (engine, engine), (client, None),
                 (dict(engine, tokens=1), engine)):
        got = analysis.explain_stream(*args)
        assert got == jax_analysis.explain_stream(*args)
        assert got["text"] == analysis.format_stream_report(got)
    # an engine record alone: its phases sum to its wall time
    report = analysis.explain_stream(engine, engine)
    assert sum(report["phases"].values()) == pytest.approx(engine["wall_s"])


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def _drain_both():
    recorder.drain_logs()
    jax_recorder.drain_logs()


def test_log_ring_matches():
    _drain_both()
    try:
        for mod in (recorder, jax_recorder):
            mod.note_log("INFO", "driver", "serve.decode.state",
                         {"inflight": {"s1": {"emitted": 3}}, "queued": 1})
            mod.note_log("WARN", "driver", "x" * 3, {"long": "y" * 500})
        got, want = recorder.recent_logs(), jax_recorder.recent_logs()
        strip = lambda logs: [{k: v for k, v in r.items() if k != "ts"}  # noqa: E731
                              for r in logs]
        assert strip(got) == strip(want) and len(got) == 2
        assert len(got[1]["fields"]["long"]) == 200  # repr, cut at 200
        drained = recorder.drain_logs()
        assert recorder.recent_logs() == []
        recorder.note_log("INFO", "driver", "later", {})
        recorder.requeue_logs(drained)
        assert [r["message"] for r in recorder.recent_logs()] == \
            ["serve.decode.state", "xxx", "later"]
    finally:
        _drain_both()


def test_structured_log_lines_land_in_the_ring(capsys):
    _drain_both()
    try:
        obs.log.warning("decode engine step failed", stream="s3")
        got = recorder.recent_logs()
        assert got[-1]["message"] == "decode engine step failed"
        assert got[-1]["level"] == "WARN"
        assert got[-1]["fields"] == {"stream": "'s3'"}
        assert "decode engine step failed" in capsys.readouterr().err
    finally:
        _drain_both()


def _strip_ts(dossier):
    return {k: v for k, v in dossier.items() if k != "ts"}


def test_flight_recorder_rings_match():
    port, ref = recorder.FlightRecorder(), jax_recorder.FlightRecorder()
    for rec in (port, ref):
        for tick in range(30):
            rec.note_ingest(
                "worker:a:1", "worker:a",
                spans=[{"name": f"s{tick}", "id": f"i{tick}"}],
                snapshot={"c": {"type": "counter", "value": float(tick)}},
                logs=[{"message": f"m{tick}"}],
                ts=1000.0 + tick,
            )
    snap = port._snapshot_proc("worker:a:1")
    assert snap == ref._snapshot_proc("worker:a:1")
    assert len(snap["spans"]) == 30
    assert 1029.0 - snap["metrics_tail"][0]["ts"] <= recorder.METRICS_TAIL_S
    kw = dict(victim_keys=["worker:a:1"], victim={"actor_id": "a"},
              head_state={"actors": []})
    got = port.assemble("unit", **kw)
    want = ref.assemble("unit", **kw)
    want.pop("lock_order_graph", None)  # the JAX sanitizer's, when armed
    assert _strip_ts(got) == _strip_ts(want)
    assert got["victim_rings"][0]["spans"][-1]["name"] == "s29"


def test_dossier_decode_section_matches(tmp_path):
    state_fields = {
        "inflight": {"s1": {"emitted": 7, "kv_len": 12, "prompt": 5}},
        "queued": 2,
        "pages": {"free": 3, "total": 8, "page_tokens": 16},
    }
    port, ref = recorder.FlightRecorder(), jax_recorder.FlightRecorder()
    for rec in (port, ref):
        rec.note_ingest(
            "worker:r1:9", "worker:r1", spans=[],
            snapshot={
                "serve.kv.pages_total": {"type": "gauge", "value": 8.0},
                "serve.decode.goodput": {"type": "gauge", "value": 0.9},
                "etl.rows": {"type": "counter", "value": 5.0},
            },
            logs=[
                {"ts": 10.0, "level": "INFO", "role": "worker:r1",
                 "message": "serve.decode.state", "fields": state_fields},
                {"ts": 11.0, "level": "INFO", "role": "worker:r1",
                 "message": "unrelated", "fields": {}},
            ],
            ts=11.0,
        )
        rec.note_ingest("worker:r2:4", "worker:r2", spans=[], snapshot=None,
                        logs=[{"ts": 9.0, "message": "plain", "fields": {}}],
                        ts=11.0)
    keys = ["worker:r1:9", "worker:r2:4"]
    got = port.assemble("unit", victim_keys=keys)
    assert got["decode"] == ref.assemble("unit", victim_keys=keys)["decode"]
    assert [d["proc"] for d in got["decode"]] == ["worker:r1:9"]
    assert got["decode"][0]["state"]["fields"] == state_fields
    assert set(got["decode"][0]["metrics"]) == {"serve.kv.pages_total",
                                                "serve.decode.goodput"}
    assert "decode" not in port.assemble("unit2", victim_keys=["worker:r2:4"])
    # written, listed and pruned per reason as the JAX recorder does
    paths = [port.write(got, str(tmp_path)) for _ in range(3)]
    assert recorder.list_dossiers(str(tmp_path)) == sorted(paths)
    assert json.loads(open(paths[0]).read())["decode"] == got["decode"]
    assert recorder.list_dossiers(str(tmp_path / "missing")) == []


# ---------------------------------------------------------------------------
# tracing additions and export
# ---------------------------------------------------------------------------


@pytest.fixture
def both_tracing_on():
    saved = (tracing.enabled(), jax_tracing.enabled())
    tracing.set_enabled(True)
    jax_tracing.set_enabled(True)
    tracing.drain_local()
    jax_tracing.drain_local()
    yield
    tracing.set_enabled(saved[0])
    jax_tracing.set_enabled(saved[1])
    tracing.drain_local()
    jax_tracing.drain_local()


def test_export_trace_writes_the_same_events(both_tracing_on, tmp_path):
    durations = np.random.default_rng(5).integers(10, 5000, 6)
    root = ("a" * 16, "b" * 16)
    for mod in (tracing, jax_tracing):
        t0 = 1_700_000_000_000_000
        for i, dur in enumerate(durations):
            mod.record_span("serve.decode.step", t0 + 10_000 * i, int(dur),
                            trace=root[0], span_id=f"{i:016x}",
                            parent=root[1], streams=2, fill=0.5)
        mod.record_span("serve.decode.prefill", t0, 900, trace=root[0],
                        span_id="c" * 16, parent=root[1], stream="s0")
        with mod.use_context(root):
            mod.instant("serve.decode.veto", cause="mem_pressure")
    got = json.loads(open(export.export_trace(str(tmp_path / "p.json"))).read())
    want = json.loads(open(jax_export.export_trace(str(tmp_path / "j.json"))).read())
    strip = lambda events: [  # noqa: E731
        {k: v for k, v in e.items() if not (e["ph"] == "i" and k in ("ts",))}
        | ({"args": {k: v for k, v in e["args"].items() if k != "span_id"}}
           if e["ph"] == "i" else {})
        for e in events]
    assert strip(got["traceEvents"]) == strip(want["traceEvents"])
    assert len(got["traceEvents"]) == 1 + 8  # the track's name, 8 records
    assert all({"ph", "ts", "pid", "tid", "name"} <= set(e)
               for e in got["traceEvents"])
    assert tracing.drain_local() == []  # the export took the ring


def test_mint_and_with_context():
    trace_id, span_id = obs.mint_context()
    assert len(trace_id) == len(span_id) == 16 and trace_id != span_id
    int(trace_id, 16), int(span_id, 16)
    seen = []

    def worker():
        seen.append(obs.with_context((trace_id, span_id),
                                     tracing.current_context))
        seen.append(tracing.current_context())

    thread = threading.Thread(target=worker)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert seen == [(trace_id, span_id), None]


def test_disabled_ring_keeps_nothing():
    saved = tracing.enabled()
    tracing.set_enabled(False)
    try:
        tracing.drain_local()
        tracing.record_span("x", 0, 1, trace="t")
        assert tracing.drain_local() == []
        tracing.set_enabled(True)
        tracing.record_span("x", 0, 1, trace="t")
        assert [r["name"] for r in tracing.drain_local()] == ["x"]
    finally:
        tracing.set_enabled(saved)


def test_full_ring_counts_drops_and_dump_metrics_reports_them(monkeypatch):
    monkeypatch.setattr(tracing, "_buffer", collections.deque(maxlen=4))
    monkeypatch.setattr(tracing, "_dropped", 0)
    monkeypatch.setattr(tracing, "_enabled", True)
    for i in range(7):
        tracing.record_span(f"s{i}", i, 1, trace="t")
    assert tracing.dropped_count() == 3
    dumped = obs.dump_metrics()
    (snapshot,) = dumped.values()
    assert snapshot["trace.spans_dropped"] == {"type": "counter", "value": 3}
    # a metrics read leaves the spans for a later export
    assert [r["name"] for r in tracing.drain_local()] == ["s3", "s4", "s5", "s6"]


# ---------------------------------------------------------------------------
# profiler additions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("live,windowed", [(0.3, None), (0.2, 0.8),
                                           (0.9, 0.4)])
def test_current_mem_pressure_matches(monkeypatch, live, windowed):
    """The live gauge, floored by the windowed max of the local mirror."""
    readings = []
    for prof, ts_mod, reg in ((profiler, timeseries, port_metrics.metrics),
                              (jax_profiler, jax_ts, jax_metrics.metrics)):
        monkeypatch.setattr(prof, "_mem_pressure", lambda: live)
        monkeypatch.setattr(prof, "_last_mem_sample", 0.0)
        monkeypatch.setattr(ts_mod, "local_store", ts_mod.SeriesStore())
        monkeypatch.setattr(reg.gauge("mem.pressure"), "_max", None)
        if windowed is not None:
            ts_mod.local_store.ingest(
                "driver:1", "driver",
                {"mem.pressure": {"type": "gauge", "value": windowed}})
        readings.append(prof.current_mem_pressure())
    expected = live if windowed is None else max(live, windowed)
    assert readings == [expected, expected]


def test_step_profiler_switch(monkeypatch):
    monkeypatch.setattr(profiler, "_step_profiler_on", True)
    assert profiler.step_profiler_enabled()
    assert profiler.step_recorder().enabled
    profiler.set_step_profiler(False)
    assert not profiler.step_profiler_enabled()
    assert profiler.step_recorder() is profiler._NOOP_RECORDER
    jax_profiler.set_step_profiler(False)
    try:
        assert jax_profiler.step_profiler_enabled() == \
            profiler.step_profiler_enabled()
    finally:
        jax_profiler.set_step_profiler(True)
