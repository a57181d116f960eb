"""The port's serving plane end to end on a CPU cluster of the port:
``serve.deploy`` of an ``MLPRegressor`` whose weights are the JAX model's
(converted with ``models/convert.py``, written through the port's
``estimator/checkpoint.py``), replicas on the CPU by request
(``device="cpu"``), as ``tests/test_serve.py`` drives the JAX package's:

- ``predict`` within 1e-6 of the JAX estimator's ``predict`` at the bucket
  shape the batcher padded to;
- the size and deadline triggers;
- rolling reload: every response is bitwise the old weights' or the new's,
  never torn, and all new once ``reload`` returns;
- scale-out and a draining scale-in under load;
- a replica SIGKILLed under load: nothing dropped, every response bitwise
  the clean run's, the pool healed back.

One cluster for the module (the session-local zygote, with the torch warm
set). Every test runs under a 120 s alarm and every wait polls a condition
under a deadline.
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

from raydp_tpu.estimator.jax_estimator import JaxEstimator
from raydp_tpu.models.mlp import MLPRegressor as FlaxMLPRegressor
from raydp_tpu_torch import cluster, serve
from raydp_tpu_torch.estimator import checkpoint as ckpt
from raydp_tpu_torch.exchange.features import pad_rows
from raydp_tpu_torch.models.convert import mlp_params_from_flax
from raydp_tpu_torch.models.mlp import MLPRegressor
from raydp_tpu_torch.obs.metrics import metrics

FEATURES, HIDDEN = 5, (16, 8)
MODEL = functools.partial(MLPRegressor, FEATURES, HIDDEN, dtype=torch.float32)
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
        time.sleep(0.01)


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


def _save(directory, epoch, params):
    model = MODEL(device="cpu")
    model.load_state_dict(mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    ckpt.save_checkpoint(str(directory), epoch, None, model,
                         torch.optim.Adam(model.parameters()))
    return model.eval()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The flax model's params (epoch 0) written as the port's checkpoint,
    and the JAX estimator holding the same params for its ``predict``."""
    flax_model = FlaxMLPRegressor(hidden=HIDDEN, dtype=jnp.float32)
    params = flax_model.init(jax.random.PRNGKey(3),
                             jnp.zeros((1, FEATURES), jnp.float32))
    est = JaxEstimator(model=flax_model)
    est._module, est._params = flax_model, params
    directory = tmp_path_factory.mktemp("mlp_ckpt")
    _save(directory, 0, params)
    return directory, params, est


def _rows(seed, n):
    return np.random.default_rng(seed).random((n, FEATURES)).astype(np.float32)


def _deploy(directory, replicas, **conf):
    return serve.deploy(
        model=MODEL, checkpoint_dir=str(directory), replicas=replicas,
        device="cpu", example=np.zeros(FEATURES, np.float32),
        conf={f"serve.{k}": v for k, v in conf.items()})


def _load(dep, payloads, threads=4):
    """Every payload predicted once, from ``threads`` client threads;
    returns the responses in payload order (an error fails the caller)."""
    out = [None] * len(payloads)
    errors = []

    def client(start):
        for i in range(start, len(payloads), threads):
            try:
                out[i] = dep.predict(payloads[i], timeout=60.0)
            except Exception as exc:  # recorded: the test asserts none
                errors.append(exc)

    pool = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    for t in pool:
        t.start()
    return pool, out, errors


def _join(pool):
    for t in pool:
        t.join(90.0)
        assert not t.is_alive()


def test_predict_matches_the_jax_estimator_at_the_bucket_shape(session, weights):
    directory, _, est = weights
    with _deploy(directory, 1, max_batch_size=16) as dep:
        assert dep.infos()[0]["buckets_compiled"] == 5  # 1, 2, 4, 8, 16
        for n, bucket in ((1, 1), (3, 4), (7, 8), (16, 16)):
            rows = _rows(n, n)
            got = dep.predict(rows, timeout=60.0)
            ref = est.predict(pad_rows(rows, bucket))[:n]
            assert got.shape == (n, 1) and got.dtype == np.float32
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        # a 1-D row and a list are one row each
        row = _rows(99, 1)[0]
        np.testing.assert_allclose(dep.predict(row, timeout=60.0),
                                   est.predict(row[None]), rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="max_batch_size"):
            dep.predict(_rows(5, 17))


def test_size_and_deadline_triggers(session, weights):
    directory, _, _ = weights
    deadline_ms = 3000.0
    with _deploy(directory, 1, max_batch_size=8, batch_buckets=[8],
                 batch_deadline_ms=deadline_ms) as dep:
        batches = metrics.counter("serve.batches")
        # one row: nothing fills the batch, the deadline sends it
        t0 = time.monotonic()
        dep.predict(_rows(1, 1), timeout=60.0)
        assert (time.monotonic() - t0) * 1e3 >= deadline_ms
        # eight rows queued at once fill the batch: sent on size, well
        # before the deadline, as ONE dispatch of eight valid rows
        before = batches.value
        t0 = time.monotonic()
        reqs = [dep.submit(_rows(10 + i, 1)) for i in range(8)]
        outs = [r.result(60.0) for r in reqs]
        assert (time.monotonic() - t0) * 1e3 < deadline_ms
        assert batches.value - before == 1
        assert all(o.shape == (1, 1) for o in outs)


def test_rolling_reload_is_old_or_new_never_torn(session, weights, tmp_path):
    _, params, _ = weights
    _save(tmp_path, 0, params)
    payloads = [_rows(100 + i, 1 + i % 8) for i in range(16)]
    with _deploy(tmp_path, 2, max_batch_size=8, batch_buckets=[8]) as dep:
        old = [dep.predict(p, timeout=60.0) for p in payloads]
        # epoch 1: the same net with the head perturbed by a seeded draw
        rng = np.random.default_rng(1)
        bumped = jax.tree_util.tree_map(np.asarray, params)
        head = bumped["params"]["Dense_2"]
        head["kernel"] = head["kernel"] + rng.normal(
            0, 0.5, head["kernel"].shape).astype(np.float32)
        new_model = _save(tmp_path, 1, bumped)
        stop = threading.Event()
        seen, errors = [], []

        def client():
            while not stop.is_set():
                for i, p in enumerate(payloads):
                    try:
                        seen.append((i, dep.predict(p, timeout=60.0)))
                    except Exception as exc:  # recorded: the test asserts none
                        errors.append(exc)

        pool = [threading.Thread(target=client) for _ in range(3)]
        for t in pool:
            t.start()
        wait_until(lambda: len(seen) >= 16, 60.0, "traffic before the reload")
        infos = dep.reload()
        stop.set()
        _join(pool)
        assert not errors
        assert [info["epoch"] for info in infos] == [1, 1]
        new = [dep.predict(p, timeout=60.0) for p in payloads]
        for i, p in enumerate(payloads):
            assert not np.array_equal(new[i], old[i])
            with torch.no_grad():
                ref = new_model(torch.from_numpy(pad_rows(p, 8))).numpy()
            np.testing.assert_allclose(new[i], ref[:len(p)], rtol=1e-6, atol=1e-6)
        kinds = {("old" if np.array_equal(out, old[i]) else
                  "new" if np.array_equal(out, new[i]) else "torn")
                 for i, out in seen}
        assert "torn" not in kinds and "old" in kinds


def test_scale_out_then_a_draining_scale_in(session, weights):
    directory, _, est = weights
    payloads = [_rows(200 + i, 1 + i % 4) for i in range(60)]
    outs_in, outs_out = metrics.counter("serve.scale_in"), metrics.counter("serve.scale_out")
    in0, out0 = outs_in.value, outs_out.value
    with _deploy(directory, 1, max_batch_size=4, batch_buckets=[4]) as dep:
        dep.scale_to(3)
        assert dep.replica_count() == 3
        assert len({info["pid"] for info in dep.infos()}) == 3
        pool, outs, errors = _load(dep, payloads)
        wait_until(lambda: sum(o is not None for o in outs) >= 10, 60.0,
                   "traffic before the scale-in")
        dep.scale_to(1)  # drains the two youngest while requests flow
        _join(pool)
        assert not errors and dep.replica_count() == 1
        for p, out in zip(payloads, outs):
            np.testing.assert_allclose(out, est.predict(pad_rows(p, 4))[:len(p)],
                                       rtol=1e-6, atol=1e-6)
        assert dep.stats()["target_replicas"] == 1
    assert outs_out.value - out0 == 2 and outs_in.value - in0 == 2


def test_replica_sigkill_drops_nothing_and_is_bitwise_the_clean_run(
        session, weights):
    directory, _, _ = weights
    payloads = [_rows(300 + i, 1 + i % 8) for i in range(64)]
    dropped = metrics.counter("serve.dropped_requests")
    replaced = metrics.counter("serve.replica_replacements")
    with _deploy(directory, 2, max_batch_size=8, batch_buckets=[8]) as dep:
        pool, clean, errors = _load(dep, payloads)
        _join(pool)
        assert not errors
        dropped0, replaced0 = dropped.value, replaced.value
        victim = dep.infos()[0]["pid"]
        pool, outs, errors = _load(dep, payloads)
        wait_until(lambda: sum(o is not None for o in outs) >= 8, 60.0,
                   "traffic before the kill")
        os.kill(victim, signal.SIGKILL)
        _join(pool)
        assert not errors and dropped.value == dropped0
        for a, b in zip(outs, clean):
            assert np.array_equal(a, b)
        wait_until(lambda: dep.replica_count() == 2
                   and replaced.value > replaced0, 60.0, "the pool to heal")
        assert victim not in {info["pid"] for info in dep.infos()}
