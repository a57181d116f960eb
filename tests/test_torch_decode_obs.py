"""The decode engine's observability in the port against the JAX engine's
(raydp_tpu_torch/serve/decode.py vs raydp_tpu/serve/decode.py), on the
CPU with converted f32 weights; after tests/test_decode_obs.py:

- the same tokens, the same deltas of ``serve.decode.{tokens,steps,
  prefills}`` and of the ``serve.ttft_ms`` / ``serve.tpot_ms`` counts, and
  the same instrument names registered (``tenant.<ns>.*`` included);
- the same ``stats()["vetoes"]`` under induced page exhaustion, the stream
  completing once the pages return;
- the memory-pressure veto, with ``current_mem_pressure`` patched high
  then low in both packages: the stream waits at the front of the queue,
  no prefill runs, then it completes with the same tokens;
- tenant histograms and goodput under an impossible TPOT SLO;
- a sampled stream's spans (one ``serve.decode.prefill`` under its root,
  a ``serve.decode.step`` fan-in per round) and its record's ``trace``;
- the ``serve.decode.state`` note and the dossier's decode section built
  from it, and ``explain_stream`` of the engine's record.
"""

import importlib
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raydp_tpu.obs import analysis as jax_analysis
from raydp_tpu.obs import recorder as jax_recorder
from raydp_tpu.obs import tracing as jax_tracing
from raydp_tpu_torch.obs import analysis, recorder, tracing

jax_metrics = importlib.import_module("raydp_tpu.obs.metrics")
port_metrics = importlib.import_module("raydp_tpu_torch.obs.metrics")
jax_decode = importlib.import_module("raydp_tpu.serve.decode")
port_decode = importlib.import_module("raydp_tpu_torch.serve.decode")

COUNTED = ("serve.decode.tokens", "serve.decode.steps", "serve.decode.prefills")
HISTS = ("serve.ttft_ms", "serve.tpot_ms")


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


@pytest.fixture(scope="module")
def tiny_lms():
    """The JAX model and params, and the port's model with the same
    weights (f32, flash attention, on the CPU)."""
    from raydp_tpu.models.transformer import TransformerLM as FlaxLM
    from raydp_tpu_torch.models.convert import params_from_flax
    from raydp_tpu_torch.models.transformer import TransformerLM

    flax_lm = FlaxLM(
        vocab_size=64, d_model=32, num_heads=2, num_layers=2,
        max_len=256, attn_impl="flash", dtype=jnp.float32,
    )
    params = flax_lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    lm = TransformerLM(64, 32, 2, 2, max_len=256, attn_impl="flash",
                       dtype=torch.float32, device="cpu")
    lm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return flax_lm, params, lm.eval()


def _engines(tiny_lms, **kw):
    """(port engine, JAX engine) with the same settings."""
    flax_lm, params, lm = tiny_lms
    return (port_decode.DecodeEngine(lm, device="cpu", **kw),
            jax_decode.DecodeEngine(flax_lm, params, **kw))


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(2, 9))).tolist()
            for _ in range(n)]


def _reading(registry):
    snap = registry.snapshot()
    out = {name: snap.get(name, {}).get("value", 0.0) for name in COUNTED}
    out.update({name: snap.get(name, {}).get("count", 0) for name in HISTS})
    return out


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def _drain(eng, sid, timeout=120.0):
    tokens = []
    deadline = time.monotonic() + timeout
    while True:
        res = eng.poll(sid, len(tokens))
        tokens.extend(res["tokens"])
        assert not res["error"], res["error"]
        if res["done"]:
            return tokens
        assert time.monotonic() < deadline, "stream timed out"
        time.sleep(0.005)


def test_engines_agree_on_tokens_and_metric_deltas(tiny_lms):
    """Streams one after another (so the rounds are the same in both
    engines): equal tokens, equal counter deltas, one TTFT and n - 1 TPOT
    observations a stream."""
    prompts, n_new = _prompts(0, 3), 6
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=2,
              max_new_tokens=8)
    tokens, deltas = [], []
    for eng, registry in zip(_engines(tiny_lms, **kw),
                             (port_metrics.metrics, jax_metrics.metrics)):
        with eng:
            before = _reading(registry)
            tokens.append([eng.generate(p, n_new, timeout=120) for p in prompts])
            deltas.append(_delta(before, _reading(registry)))
            stats = eng.stats()
        assert set(stats["vetoes"]) == {"kv_pages", "slots", "mem_pressure"}
    assert tokens[0] == tokens[1]
    assert deltas[0] == deltas[1] == {
        "serve.decode.tokens": 3 * n_new, "serve.decode.prefills": 3,
        "serve.decode.steps": 3 * (n_new - 1),
        "serve.ttft_ms": 3, "serve.tpot_ms": 3 * (n_new - 1),
    }


def test_engine_registers_the_jax_engines_instrument_names(tiny_lms,
                                                           monkeypatch):
    """Every instrument the JAX engine creates, under the same name, once
    at construction (a fresh registry in each package's decode module)."""
    port_reg = port_metrics.Registry()
    jax_reg = jax_metrics.Registry()
    monkeypatch.setattr(port_decode, "metrics", port_reg)
    monkeypatch.setattr(jax_decode, "metrics", jax_reg)
    port_eng, jax_eng = _engines(tiny_lms, capacity_tokens=64,
                                 page_tokens=16, max_seqs=2,
                                 max_new_tokens=8, tenant="acme")
    with port_eng, jax_eng:
        names = set(port_reg.snapshot())
        assert names == set(jax_reg.snapshot())
        port_eng.generate([1, 2, 3], 3, timeout=120)
        assert set(port_reg.snapshot()) == names  # nothing created later
    assert {"tenant.acme.serve.ttft_ms", "tenant.acme.serve.tpot_ms",
            "serve.decode.veto.mem_pressure", "serve.decode.admission_vetoed",
            "serve.decode.goodput", "serve.decode.token_ms"} <= names
    assert all(n.startswith(("serve.", "tenant.acme.serve.")) for n in names)


def _hog_pages(eng, seed=3):
    """Two occupants of two pages each: one page of the six stays free."""
    rng = np.random.default_rng(seed)
    for hog in ("h1", "h2"):
        eng._cache.alloc(hog)
        rows = rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
        eng._cache.append(hog, rows, rows)


def test_page_exhaustion_vetoes_match(tiny_lms):
    """Pages held by other occupants veto admission with cause
    ``kv_pages`` in both engines (every slot is free), and the queued
    stream completes, with the same tokens, once the pages return."""
    kw = dict(capacity_tokens=32, page_tokens=16, max_seqs=2,
              max_new_tokens=16)
    outcome = []
    for eng in _engines(tiny_lms, **kw):
        with eng:
            _hog_pages(eng)
            # worst case 4 + 16 = 20 tokens = 2 pages > the 1 page left
            sid = eng.submit([5, 9, 2, 7], 16)
            _wait(lambda: eng.stats()["vetoes"]["kv_pages"] >= 1)
            stats = eng.stats()
            assert stats["queued"] == 1
            outcome.append({k: v > 0 for k, v in stats["vetoes"].items()})
            eng._cache.free("h1")
            eng._cache.free("h2")
            eng._wake.set()
            outcome.append(_drain(eng, sid))
    assert outcome[0] == outcome[2] == {"kv_pages": True, "slots": False,
                                        "mem_pressure": False}
    assert outcome[1] == outcome[3] and len(outcome[1]) == 16


def test_mem_pressure_veto_holds_then_releases(tiny_lms, monkeypatch):
    """Host memory pressure above ``max_mem_pressure`` puts the stream
    back at the front of the queue before its prefill; when it drains the
    stream is served. The same in both engines."""
    level = {"value": 0.99}
    monkeypatch.setattr(port_decode, "current_mem_pressure",
                        lambda: level["value"])
    jax_profiler = importlib.import_module("raydp_tpu.obs.profiler")
    monkeypatch.setattr(jax_profiler, "current_mem_pressure",
                        lambda: level["value"])
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=2,
              max_new_tokens=8)
    got = []
    for eng, registry in zip(_engines(tiny_lms, **kw),
                             (port_metrics.metrics, jax_metrics.metrics)):
        level["value"] = 0.99
        vetoed = registry.counter("serve.decode.veto.mem_pressure")
        before = vetoed.value
        prefills = registry.counter("serve.decode.prefills").value
        with eng:
            sid = eng.submit([4, 8, 15], 5)
            _wait(lambda: eng.stats()["vetoes"]["mem_pressure"] >= 2)
            stats = eng.stats()
            assert stats["queued"] == 1 and stats["inflight"] == 0
            assert registry.counter("serve.decode.prefills").value == prefills
            assert vetoed.value - before >= 2
            assert registry.gauge("serve.decode.queued").value == 1.0
            level["value"] = 0.1
            got.append(_drain(eng, sid))
            assert eng.stats()["queued"] == 0
    assert got[0] == got[1] and len(got[0]) == 5


def test_veto_reads_the_engines_ceiling(tiny_lms):
    """``max_mem_pressure`` is read at each admission: below any pressure
    it holds the stream; set back, the stream is served."""
    _, _, lm = tiny_lms
    with port_decode.DecodeEngine(lm, capacity_tokens=64, page_tokens=16,
                                  max_seqs=2, max_new_tokens=8,
                                  device="cpu") as eng:
        eng.max_mem_pressure = -1.0
        sid = eng.submit([1, 2, 3], 4)
        _wait(lambda: eng.stats()["vetoes"]["mem_pressure"] >= 1)
        assert eng.stats()["queued"] == 1 and eng.stats()["prefills"] == 0
        eng.max_mem_pressure = 0.95
        assert len(_drain(eng, sid)) == 4


def test_tenant_histograms_and_goodput_under_impossible_tpot(tiny_lms):
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=2,
              max_new_tokens=16, ttft_slo_ms=600000.0, tpot_slo_ms=0.0001,
              tenant="acme")
    stats, deltas = [], []
    for eng, registry in zip(_engines(tiny_lms, **kw),
                             (port_metrics.metrics, jax_metrics.metrics)):
        names = ("tenant.acme.serve.ttft_ms", "tenant.acme.serve.tpot_ms")
        before = [registry.histogram(n).count for n in names]
        late = registry.counter("serve.decode.late_tokens").value
        with eng:
            assert len(eng.generate([5, 9, 2, 7], 8, timeout=120)) == 8
            stats.append(eng.stats())
        deltas.append([registry.histogram(n).count - b
                       for n, b in zip(names, before)]
                      + [registry.counter("serve.decode.late_tokens").value
                         - late])
        assert registry.gauge("serve.decode.goodput").value == 1 / 8
    keys = ("good_tokens", "late_tokens", "goodput")
    assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys] \
        == [1, 7, 1 / 8]
    assert deltas[0] == deltas[1] == [1, 7, 7]


@pytest.fixture
def tracing_on():
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


def test_sampled_stream_spans_match(tiny_lms, tracing_on):
    """A stream submitted with a trace context: one prefill span under its
    root, one step span a round parented under it and listing it, the
    record carrying its trace id; an unsampled stream adds no span."""
    kw = dict(capacity_tokens=64, page_tokens=16, max_seqs=2,
              max_new_tokens=8)
    shapes = []
    for eng, mod in zip(_engines(tiny_lms, **kw), (tracing, jax_tracing)):
        ctx = mod.mint_context()
        with eng:
            sid = eng.submit([3, 1, 4, 1], 5, trace_ctx=ctx)
            _drain(eng, sid)
            rec = eng.explain(sid)
            eng.generate([2, 7], 3, timeout=120)  # not sampled
        spans = mod.drain_local()
        assert {s["trace"] for s in spans} == {ctx[0]}
        prefill = [s for s in spans if s["name"] == "serve.decode.prefill"]
        steps = [s for s in spans if s["name"] == "serve.decode.step"]
        # 5 tokens: the prefill's and one a round (the record, sealed when
        # the last token is emitted, counts the rounds before it: 3)
        assert len(prefill) == 1 and len(steps) == 4 and rec["steps"] == 3
        assert all(s["parent"] == ctx[1] for s in prefill + steps)
        assert all(s["args"]["stream_spans"] == [ctx[1]] for s in steps)
        assert prefill[0]["args"]["stream"] == sid
        assert prefill[0]["args"]["prefill_s"] > 0
        assert rec["trace"] == ctx[0]
        shapes.append((sorted(prefill[0]["args"]), sorted(steps[0]["args"]),
                       [s["args"]["streams"] for s in steps]))
    assert shapes[0] == shapes[1]


def test_trace_context_without_tracing_records_no_span(tiny_lms):
    _, _, lm = tiny_lms
    saved = tracing.enabled()
    tracing.set_enabled(False)
    try:
        tracing.drain_local()
        with port_decode.DecodeEngine(lm, capacity_tokens=64, page_tokens=16,
                                      max_seqs=2, max_new_tokens=8,
                                      device="cpu") as eng:
            ctx = tracing.mint_context()
            sid = eng.submit([3, 1], 3, trace_ctx=ctx)
            _drain(eng, sid)
            assert eng.explain(sid)["trace"] == ctx[0]
        assert tracing.drain_local() == []
    finally:
        tracing.set_enabled(saved)


def test_state_note_and_dossier_decode_section_match(tiny_lms):
    """The same engine state gives the same ``serve.decode.state`` note in
    both packages, and the same decode section of a dossier fed from the
    process's rings."""
    kw = dict(capacity_tokens=32, page_tokens=16, max_seqs=2,
              max_new_tokens=16)
    sections = []
    for eng, rec_mod, registry in zip(
            _engines(tiny_lms, **kw), (recorder, jax_recorder),
            (port_metrics.metrics, jax_metrics.metrics)):
        with eng:
            # the loop notes its state by itself once a second; hold those
            # notes off (the loop looks the method up on the instance each
            # round) so a drain and a read more than a second apart under
            # load see only the note forced here
            note_state = eng._note_state_throttled
            eng._note_state_throttled = lambda min_interval=1.0: None
            _hog_pages(eng)
            sid = eng.submit([5, 9, 2, 7], 16, stream_id="q1")
            _wait(lambda: eng.stats()["vetoes"]["kv_pages"] >= 1)
            rec_mod.drain_logs()
            note_state(min_interval=0.0)
            logs = rec_mod.recent_logs()
            eng._cache.free("h1")
            eng._cache.free("h2")
            eng._wake.set()
            _drain(eng, sid)
        notes = [r for r in logs if r["message"] == "serve.decode.state"]
        assert len(notes) == 1
        snapshot = {k: v for k, v in registry.snapshot().items()
                    if k.startswith("serve.decode.")}
        flight = rec_mod.FlightRecorder()
        flight.note_ingest("driver:1", "driver", spans=[], snapshot=snapshot,
                           logs=logs)
        (section,) = flight.assemble("unit", victim_keys=["driver:1"])["decode"]
        sections.append(section)
    assert sections[0]["state"]["fields"] == sections[1]["state"]["fields"]
    assert set(sections[0]["metrics"]) == set(sections[1]["metrics"])
    fields = sections[0]["state"]["fields"]
    assert fields["queued"] == "1" and fields["inflight"] == "{}"
    assert "'free': 1, 'total': 6" in fields["pages"]


def test_engine_notes_its_state_at_most_once_a_second(tiny_lms):
    _, _, lm = tiny_lms
    recorder.drain_logs()
    t0 = time.monotonic()
    with port_decode.DecodeEngine(lm, capacity_tokens=64, page_tokens=16,
                                  max_seqs=2, max_new_tokens=8,
                                  device="cpu") as eng:
        _wait(lambda: recorder.recent_logs())
        eng.generate([1, 2, 3], 4, timeout=120)
        time.sleep(0.2)
    lifetime = time.monotonic() - t0
    notes = [r for r in recorder.drain_logs()
             if r["message"] == "serve.decode.state"]
    # the first loop pass notes, then at most one a second
    assert 1 <= len(notes) <= 1 + int(lifetime)
    assert set(notes[0]["fields"]) == {"inflight", "queued", "pages"}


def test_explain_stream_of_an_engine_record(tiny_lms):
    _, _, lm = tiny_lms
    with port_decode.DecodeEngine(lm, capacity_tokens=64, page_tokens=16,
                                  max_seqs=2, max_new_tokens=8,
                                  device="cpu") as eng:
        sids = [eng.submit(p, 6) for p in _prompts(4, 3)]
        for sid in sids:
            _drain(eng, sid)
        records = [eng.explain(sid) for sid in sids]
    for rec in records:
        report = analysis.explain_stream(rec, rec)
        assert report == jax_analysis.explain_stream(rec, rec)
        assert sum(report["phases"].values()) == \
            pytest.approx(rec["wall_s"], rel=1e-2)
        assert report["tokens"] == 6 and report["engine_record"]
