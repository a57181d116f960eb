"""Decode streams through the port's serving plane on a CPU cluster of the
port: a tiny f32 ``TransformerLM`` whose weights are the JAX model's
(``models/convert.py``), served by replicas on the CPU through
``Deployment.stream`` / ``generate``, as ``tests/test_decode_obs.py`` and
``tools/chaos.py``'s ``scenario_replica_kill_during_decode`` drive the JAX
package's:

- every stream's tokens equal the JAX ``DecodeEngine``'s and the port's
  in-process engine's;
- a replica SIGKILLed mid-stream: every stream's tokens identical to the
  clean run (f32 model, f32 cache: the re-prefill on a survivor continues
  bit for bit), ``serve.decode.failovers`` >= 1, the pool healed;
- ``explain_last_stream`` decomposes the last stream.

One cluster for the module. Every test runs under a 120 s alarm and every
wait polls a condition under a deadline.
"""

import functools
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.models.transformer import TransformerLM as FlaxLM
from raydp_tpu.serve.decode import DecodeEngine as JaxEngine
from raydp_tpu_torch import cluster, serve
from raydp_tpu_torch.estimator import checkpoint as ckpt
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.obs.metrics import metrics
from raydp_tpu_torch.serve.decode import DecodeEngine

GEOM = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2, max_len=256)
MODEL = functools.partial(TransformerLM, **GEOM, attn_impl="flash",
                          dtype=torch.float32)
ENGINE = dict(capacity_tokens=256, page_tokens=16, max_seqs=4)
# one intra-op thread in each replica: the tiny model gains nothing from
# more, and a loaded test machine loses a lot to oversubscription
ENV = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1",
       "RAYDP_TPU_TORCH_ZYGOTE_WARM_TORCH": "1", "OMP_NUM_THREADS": "1"}


def wait_until(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 120 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(120)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def session():
    saved = {key: os.environ.get(key) for key in ENV}
    os.environ.update(ENV)
    cluster.init(num_cpus=4)
    try:
        yield
    finally:
        cluster.shutdown()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The flax LM and params, the port's model with the same weights, and
    the checkpoint directory holding them (epoch 0)."""
    flax_lm = FlaxLM(**GEOM, attn_impl="flash", dtype=jnp.float32)
    params = flax_lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = MODEL(device="cpu").eval()
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    directory = tmp_path_factory.mktemp("lm_ckpt")
    ckpt.save_checkpoint(str(directory), 0, None, model,
                         torch.optim.Adam(model.parameters()))
    return flax_lm, params, model, directory


def _prompts(n, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GEOM["vocab_size"], int(k)).tolist()
            for k in rng.integers(3, 40, n)]


def _deploy(directory, max_new):
    conf = {"serve.decode.enabled": True,
            "serve.decode.capacity_tokens": ENGINE["capacity_tokens"],
            "serve.decode.page_tokens": ENGINE["page_tokens"],
            "serve.decode.max_seqs": ENGINE["max_seqs"],
            "serve.decode.max_new_tokens": max_new}
    return serve.deploy(model=MODEL, checkpoint_dir=str(directory),
                        replicas=2, device="cpu", conf=conf)


def _port_engine_tokens(model, prompts, max_new):
    """Every prompt through one in-process engine at once (its slots
    batch them, as the replicas' engines do), on one intra-op thread as
    the replicas run (``ENV``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _engine_tokens(model, prompts, max_new)
    finally:
        torch.set_num_threads(threads)


def _engine_tokens(model, prompts, max_new):
    with DecodeEngine(model, device="cpu", max_new_tokens=max_new,
                      **ENGINE) as eng:
        sids = [eng.submit(p, max_new) for p in prompts]
        out = {}

        def drained():
            for sid in sids:
                if sid not in out:
                    res = eng.poll(sid, 0)
                    assert not res["error"], res["error"]
                    if res["done"]:
                        out[sid] = res["tokens"]
            return len(out) == len(sids)

        wait_until(drained, 100.0, "the in-process engine's streams")
        return [out[sid] for sid in sids]


def test_streams_match_the_jax_and_the_port_engines(session, lm):
    flax_lm, params, model, directory = lm
    prompts = _prompts(4)
    with _deploy(directory, 12) as dep:
        got = [dep.generate(p, 12, timeout=60.0) for p in prompts]
        streamed = list(dep.stream(prompts[0], 12, timeout=60.0))
        stats = dep.decode_stats()
    assert got == _port_engine_tokens(model, prompts, 12)
    with JaxEngine(flax_lm, params, max_new_tokens=12, **ENGINE) as eng:
        assert got == [eng.generate(p, 12, timeout=120) for p in prompts]
    assert streamed == got[0]
    assert len(stats) == 2 and sum(s["prefills"] for s in stats) == 5


def test_sigkill_mid_stream_continues_bit_for_bit(session, lm):
    _, _, model, directory = lm
    prompts = _prompts(6, seed=5)
    max_new = 150  # long enough that the kill lands mid-stream
    clean = _port_engine_tokens(model, prompts, max_new)
    failovers = metrics.counter("serve.decode.failovers")
    replaced = metrics.counter("serve.replica_replacements")
    with _deploy(directory, max_new) as dep:
        failovers0, replaced0 = failovers.value, replaced.value
        victim = dep.infos()[0]["pid"]
        emitted = [[] for _ in prompts]
        errors = []

        def client(i):
            try:
                for tok in dep.stream(prompts[i], max_new, timeout=90.0):
                    emitted[i].append(tok)
            except Exception as exc:  # recorded: the test asserts none
                errors.append(exc)

        # round robin: streams 0, 2, 4 start on replica 0
        pool = []
        for i in range(len(prompts)):
            pool.append(threading.Thread(target=client, args=(i,)))
            pool[-1].start()
        wait_until(lambda: len(emitted[0]) >= 2, 60.0,
                   "a stream on replica 0 to emit two tokens")
        os.kill(victim, signal.SIGKILL)
        for t in pool:
            t.join(90.0)
            assert not t.is_alive()
        assert not errors
        assert emitted == clean
        assert failovers.value - failovers0 >= 1
        wait_until(lambda: dep.replica_count() == 2
                   and replaced.value > replaced0, 60.0, "the pool to heal")
        report = dep.explain_last_stream()
    assert report["text"] and "failovers" in report["text"]


def test_explain_last_stream_reads_the_serving_engine(session, lm):
    _, _, _, directory = lm
    with _deploy(directory, 8) as dep:
        with pytest.raises(RuntimeError, match="no stream"):
            dep.explain_last_stream()
        dep.generate(_prompts(1)[0], 8, timeout=60.0)
        report = dep.explain_last_stream()
    assert report["text"].startswith("decode stream")
    assert "8 tokens" in report["text"] and "0 failovers" in report["text"]
