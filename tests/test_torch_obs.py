"""The port's obs layer (raydp_tpu_torch/obs/) against the JAX package's
(raydp_tpu/obs/): the same calls give records and snapshots of the same
structure, the analyzer gives the same report on the same span records, and
the cost model the same numbers; then the estimator's use of it.

Span and trace ids are random in both packages, so records are compared
with each id replaced by its first-seen index. Nothing here is a device
measurement: the MFU of a CPU fit is against the nominal CPU peak.
"""

import functools
import importlib
import json
import os
import threading

import numpy as np
import pytest
import torch

from raydp_tpu.obs import analysis as jax_analysis
from raydp_tpu.obs import costmodel as jax_costmodel
from raydp_tpu.obs import profiler as jax_profiler
from raydp_tpu.obs import tracing as jax_tracing
from raydp_tpu_torch import obs
from raydp_tpu_torch.estimator import Estimator
from raydp_tpu_torch.exchange.dataset import ArrayDataset
from raydp_tpu_torch.models.dlrm import DLRM
from raydp_tpu_torch.obs import analysis, costmodel, profiler, tracing
from raydp_tpu_torch.ops import _flops

# both packages' ``obs.metrics`` is the registry; these are the modules
jax_metrics = importlib.import_module("raydp_tpu.obs.metrics")
port_metrics = importlib.import_module("raydp_tpu_torch.obs.metrics")

H100 = "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------------------
# metrics and spans: the JAX package's structure
# ---------------------------------------------------------------------------


def _drive_registry(reg):
    reg.counter("estimator.steps").inc(48)
    reg.counter("estimator.steps").inc()
    reg.gauge("estimator.mfu").set(0.25)
    reg.gauge("mem.rss_bytes").set_watermark(10)
    reg.gauge("mem.rss_bytes").set_watermark(7)
    hist = reg.histogram("estimator.step.compute_ms")
    for v in (3.0, 1.0, 2.0, 5.0):
        hist.observe(v)
    reg.histogram("estimator.step.sync_ms")
    return reg.snapshot()


def test_registry_snapshot_as_jax():
    got = _drive_registry(port_metrics.Registry())
    assert got == _drive_registry(jax_metrics.Registry())
    reg = port_metrics.Registry()
    reg.counter("a")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("a")


def _normalize(records):
    ids = {}

    def idx(v):
        if v is None:
            return None
        return ids.setdefault(v, len(ids))

    out = []
    for r in records:
        r = dict(r)
        for key in ("trace", "id", "parent"):
            r[key] = idx(r[key])
        assert r.pop("dur") >= 0 and r.pop("ts") > 0
        for key in ("pid", "tid", "proc"):
            r.pop(key)
        out.append(r)
    return out


def _drive_spans(mod):
    with mod.collect() as outer:
        with mod.span("estimator.fit", epochs=2) as fit:
            with mod.span("estimator.compile", what="init"):
                pass
            with mod.collect() as inner:
                with mod.span("estimator.epoch", epoch=0) as epoch:
                    epoch.set(steps=4, compute_s=0.5)
                    mod.instant("estimator.retry", attempt=1)
            ctx = mod.current_context()
            mod.record_span("serve.request", 100, 50, ctx[0], parent=ctx[1],
                            tokens=3)
            try:
                with mod.span("estimator.eval"):
                    raise ValueError("x")
            except ValueError:
                pass
            sinks = mod.current_sinks()
            seen = []

            def helper():
                with mod.use_sinks(sinks), mod.use_context(ctx):
                    with mod.span("helper.work"):
                        pass
                seen.append(mod.current_context())

            thread = threading.Thread(target=helper)
            thread.start()
            thread.join(timeout=10)
        assert fit.duration > 0 and seen == [None]
    assert mod.current_context() is None
    return _normalize(outer), _normalize(inner)


def test_span_records_and_collect_as_jax():
    got_outer, got_inner = _drive_spans(tracing)
    ref_outer, ref_inner = _drive_spans(jax_tracing)
    assert got_outer == ref_outer
    assert got_inner == ref_inner
    assert [r["name"] for r in got_inner] == ["estimator.retry",
                                              "estimator.epoch"]


def test_disabled_span_is_the_shared_noop():
    assert not tracing.enabled()
    assert obs.span("x") is tracing._NOOP
    with obs.collect():
        assert obs.span("x") is not tracing._NOOP


def test_local_buffer_keeps_spans_when_enabled(monkeypatch):
    monkeypatch.setattr(tracing, "_enabled", True)
    tracing.drain_local()
    with obs.span("estimator.fit"):
        pass
    assert obs.flush() is False  # nothing to ship to: records stay local
    assert [r["name"] for r in tracing.drain_local()] == ["estimator.fit"]


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


def _fit_records():
    """A fit of two epochs, a compile and an eval, in microseconds; the
    second epoch carries the step recorder's phase args."""
    def rec(name, ts, dur, id_, parent, **args):
        return {"name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
                "proc": "driver", "trace": "t", "id": id_, "parent": parent,
                "args": args}

    return [
        rec("estimator.compile", 1_000, 20_000, "c", "f", what="init"),
        rec("estimator.epoch", 25_000, 300_000, "e0", "f", epoch=0),
        rec("estimator.compile", 26_000, 40_000, "c1", "e0", what="first_step"),
        rec("estimator.epoch", 330_000, 250_000, "e1", "f", epoch=1,
            ingest_s=0.02, h2d_s=0.01, compute_s=0.15, sync_s=0.03),
        rec("estimator.eval", 585_000, 30_000, "v", "f", epoch=1),
        {"name": "estimator.retry", "ph": "i", "ts": 600_000, "dur": 0,
         "id": "i", "parent": "f", "trace": "t", "args": {}},
        rec("estimator.fit", 0, 640_000, "f", None, epochs=2),
    ]


@pytest.mark.parametrize("top_k", [1, 5])
def test_explain_fit_as_jax(top_k):
    records = _fit_records()
    got = profiler.explain_fit(records, top_k=top_k)
    ref = jax_profiler.explain_fit(records, top_k=top_k)
    assert got == ref
    assert got["by_category"]["ingest"] == pytest.approx(0.02)
    assert got["text"].startswith("critical path of estimator.fit")


def test_attribute_refuses_a_missing_root():
    with pytest.raises(ValueError, match="no root span"):
        analysis.attribute(_fit_records()[:2], root_name="estimator.fit")
    assert analysis.categorize("serve.decode.step") == \
        jax_analysis.categorize("serve.decode.step")


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op_type,peak", [("bf16", 989e12), ("f32", 67e12),
                                          ("int8", 1979e12)])
def test_device_peak_flops_h100(op_type, peak, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    info = costmodel.device_peak_flops("cuda", op_type)
    assert info == {"kind": H100, "op_type": op_type, "peak": peak,
                    "peak_source": "hopper-table"}


def test_device_peak_flops_other_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert costmodel.device_peak_flops("cuda")["peak"] is None
    cpu = costmodel.device_peak_flops("cpu", "f32")
    ref = jax_costmodel.device_peak_flops(type("D", (), {"device_kind": "cpu"})())
    assert (cpu["peak"], cpu["peak_source"]) == (ref["peak"], ref["peak_source"])


def test_mfu_and_analytic_flops_as_jax():
    for args in ((1e12, 989e12), (None, 1.0), (1.0, None), (0.0, 1.0)):
        assert costmodel.mfu(*args) == jax_costmodel.mfu(*args)
    assert costmodel.lm_decode_flops_per_token(1024, 4, 2048, 1500) == \
        jax_costmodel.lm_decode_flops_per_token(1024, 4, 2048, 1500)
    assert costmodel.lm_prefill_flops(1500, 1024, 4, 2048) == \
        jax_costmodel.lm_prefill_flops(1500, 1024, 4, 2048)
    assert costmodel.lm_train_flops_per_step(2, 8192, 1024, 4, 2048) == \
        jax_costmodel.lm_train_flops_per_step(2, 8192, 1024, 4, 2048)


def test_count_flops_sees_matmuls_and_reported_kernels():
    layer = torch.nn.Linear(16, 8)
    x = torch.randn(32, 16, requires_grad=True)

    def step():
        _flops.note_flops(1000)
        layer(x).sum().backward()
        return "done"

    result, flops = costmodel.count_flops(step)
    # forward 2*B*in*out, backward twice that (input and weight gradients)
    assert result == "done" and flops == 3 * 2 * 32 * 16 * 8 + 1000
    _flops.note_flops(5)  # outside a count: ignored
    assert costmodel.count_flops(lambda: None)[1] == 0


# ---------------------------------------------------------------------------
# the profiler and the estimator's use of the layer
# ---------------------------------------------------------------------------


def test_step_recorder_totals_and_noop(monkeypatch):
    rec = profiler.step_recorder()
    rec.note("compute", 0.2, steps=4)
    rec.note("sync", 0.1)
    rec.note("ingest", -1.0)
    assert rec.steps == 4
    assert rec.totals() == {"ingest": 0.0, "h2d": 0.0, "compute": 0.2,
                            "sync": 0.1}
    monkeypatch.setattr(profiler, "_step_profiler_on", False)
    off = profiler.step_recorder()
    off.note("compute", 1.0)
    assert off.totals() == {} and not off.enabled


def test_sample_memory_and_logging(capsys):
    sample = obs.sample_memory(force=True)
    assert sample["rss_bytes"] > 0 and 0.0 <= sample["pressure"] <= 1.0
    assert "device_bytes" not in sample  # no CUDA context here
    assert obs.metrics.gauge("mem.rss_bytes").snapshot()["max"] > 0
    assert obs.sample_memory() is None  # throttled
    obs.get_logger("estimator").warning("fit failed; retrying", attempt=1)
    line = capsys.readouterr().err.strip()
    assert line.endswith("WARN [estimator] fit failed; retrying attempt=1")


def _blocks_dataset(seed=0, n=160, k=3):
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(k):
        c0 = rng.integers(0, 50, n)
        blocks.append({"d0": rng.random(n).astype(np.float32),
                       "d1": rng.random(n).astype(np.float32), "c0": c0,
                       "c1": rng.integers(0, 10, n),
                       "label": (c0 % 2).astype(np.float32)})
    return ArrayDataset.from_blocks(blocks)


def _estimator(**kw):
    return Estimator(model=functools.partial(DLRM, [50, 10], 2, 8),
                     loss="bce", feature_columns=["d0", "d1", "c0", "c1"],
                     categorical_columns=["c0", "c1"], label_column="label",
                     batch_size=32, num_epochs=2, learning_rate=1e-2,
                     device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _streamed_fit():
    est = _estimator(streaming=True, stream_scan_steps=4)
    est.fit(_blocks_dataset())
    return est


@pytest.mark.parametrize("streaming", [False, True])
def test_explain_last_fit_splits_the_epochs(streaming):
    est = _streamed_fit() if streaming else _estimator()
    if not streaming:
        est.fit(_blocks_dataset())
    report = est.explain_last_fit()
    assert report["root"] == "estimator.fit"
    assert report["attributed_frac"] == 1.0
    assert report["by_category"]["compute"] > 0
    assert "compile" in report["by_category"]
    if streaming:
        assert report["by_category"]["ingest"] > 0
    names = {r["name"] for r in est.last_fit_records_}
    assert {"estimator.fit", "estimator.compile", "estimator.epoch"} <= names
    epochs = [r for r in est.last_fit_records_ if r["name"] == "estimator.epoch"]
    assert all({"ingest_s", "h2d_s", "compute_s", "sync_s", "steps"}
               <= set(r["args"]) for r in epochs)
    with pytest.raises(RuntimeError, match="no fit"):
        _estimator().explain_last_fit()


def test_fit_stats_keys_as_jax_and_live_gauges():
    est = _streamed_fit()
    jax_keys = {"steps", "step_phase_seconds", "step_wall_s", "flops_per_step",
                "model_flops_per_sec", "mfu", "peak_flops", "device_kind",
                "peak_source", "profiler"}
    stats = est.fit_stats_
    assert jax_keys <= set(stats)
    # 2 epochs of 15 steps, the first step timed as compile
    assert stats["steps"] == 29
    assert stats["peak_source"] == "nominal-cpu"
    assert stats["flops_per_step"] > 0 and 0 < stats["mfu"] < 1
    assert obs.metrics.gauge("estimator.mfu").value == stats["mfu"]
    assert obs.metrics.gauge("estimator.model_flops_per_sec").value > 0


def test_profile_dir_writes_a_trace(tmp_path):
    est = _estimator(streaming=True, profile_dir=str(tmp_path / "prof"))
    est.fit(_blocks_dataset())
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_capture_window(tmp_path):
    with obs.profile_fit(steps=3, out_dir=str(tmp_path / "cap")) as cap:
        _estimator(streaming=True).fit(_blocks_dataset())
    result = cap.result()
    assert result["steps_captured"] >= 3
    assert os.path.exists(result["trace_path"])
    spans = json.loads((tmp_path / "cap" / "spans.json").read_text())
    assert any(r["name"] == "estimator.fit" for r in spans)
    assert profiler.armed_capture() is None
    with profiler.capture(out_dir=str(tmp_path / "c2"), torch_trace=False):
        with pytest.raises(RuntimeError, match="another profiler capture"):
            profiler.capture(out_dir=str(tmp_path / "c3")).__enter__()


def test_one_trace_at_a_time(tmp_path):
    """A capture window inside a fit with profile_dir: the profiler takes
    one trace at a time, so the fit's trace is written and the window keeps
    its spans only."""
    est = _estimator(profile_dir=str(tmp_path / "prof"))
    with obs.profile_fit(steps=3, out_dir=str(tmp_path / "cap")) as cap:
        est.fit(_blocks_dataset())
    assert (tmp_path / "prof" / "trace.json").exists()
    assert cap.result()["trace_path"] is None
    assert cap.result()["span_records"] > 0
