"""The port's ``TFEstimator`` held against the JAX package's.

Tensorflow trains on the CPU in both packages. The ranks of the port's
cluster are fresh interpreters (not forks of its zygote), and the port's
estimator package resolves its names lazily, so a rank of the port's
``TFEstimator`` imports tensorflow without torch.

- The JAX package's ``_TFWorkerFn`` and the port's, at world 1 and 2 in
  spawned processes (``tests/tf_estimator_ranks.py``; MWMS over
  ``localhost`` ports at world 2), on the same shards and the same model
  serialized once by the port's ``_serialize``: rank 0's weights and the
  history (``loss``, ``val_loss``) are equal bit for bit, and the port's
  ranks never imported torch. The two programs
  run the same tensorflow code on the same inputs with one thread each,
  so nothing may differ.
- ``fit_on_etl`` through the port's cluster at ``num_workers=2``, with the
  JAX package's test's assertions (the loss halves, ends below 1, the
  model's prediction at (0.5, 0.5) within 2 of 8.5).
"""

import multiprocessing
import pickle
import signal
import socket
import time

import numpy as np
import pandas as pd
import pytest

import tf_estimator_ranks as ranks

tf = pytest.importorskip("tensorflow")

PACKAGES = ("raydp_tpu", "raydp_tpu_torch")
RANK_LIMIT_S = 200.0


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 240 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(240)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def port_estimator(**kw):
    from raydp_tpu_torch.estimator import TFEstimator

    settings = dict(ranks.SETTINGS, model=ranks.keras_model,
                    optimizer=tf.keras.optimizers.Adam(0.01), loss="mse",
                    metrics=["mae"])
    settings.update(kw)
    return TFEstimator(**settings)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both packages' programs at world 1 and 2, all at once; every rank's
    result by (package, world)."""
    tmp = tmp_path_factory.mktemp("tf")
    config = port_estimator()._serialize()
    ctx = multiprocessing.get_context("spawn")
    procs, outs = [], {}
    for package in PACKAGES:
        for world in (1, 2):
            ports = [free_port() for _ in range(world)]
            out = str(tmp / f"out-{package}-{world}")
            outs[(package, world)] = out
            procs += [ctx.Process(target=ranks.run, args=(
                r, world, ports, out, package, config)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_LIMIT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(5.0)
    assert not late, f"{len(late)} rank(s) ran past {RANK_LIMIT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    results = {}
    for (package, world), out in outs.items():
        results[(package, world)] = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                results[(package, world)].append(pickle.load(f))
    return results


@pytest.mark.parametrize("world", [1, 2])
def test_rank_matches_the_reference_rank(spawned, world):
    ref, port = spawned[("raydp_tpu", world)], spawned[("raydp_tpu_torch", world)]
    got, want = port[0]["weights"], ref[0]["weights"]
    assert len(got) == len(want) == 4
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(r["weights"] is None for r in port[1:])
    for mine, theirs in zip(port, ref):
        assert mine["history"] == theirs["history"]
        assert mine["torch_imported"] is False
    losses = port[0]["history"]["loss"]
    assert len(losses) == ranks.SETTINGS["num_epochs"]
    assert losses[-1] < losses[0]


@pytest.fixture(scope="module")
def session():
    import raydp_tpu_torch as rt
    from raydp_tpu_torch.cluster import api as cluster
    from raydp_tpu_torch.etl import session as etl_session

    def stop_all():
        while etl_session.active_session() is not None:
            etl_session.stop_etl()
        cluster.shutdown()

    stop_all()
    s = rt.init_etl("test-torch-tf", num_executors=2, executor_cores=1,
                    executor_memory="300M")
    try:
        yield s
    finally:
        stop_all()


def test_tf_fit_on_etl_on_the_port_cluster(session):
    rng = np.random.default_rng(0)
    n = 2048
    x = rng.random(n).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    pdf = pd.DataFrame({"x": x, "y": y, "z": 3 * x + 4 * y + 5})
    est = port_estimator(num_epochs=8, num_workers=2)
    history = est.fit_on_etl(session.from_pandas(pdf, num_partitions=4))
    losses = history["loss"]
    assert len(losses) == 8
    assert losses[-1] < losses[0] * 0.5
    assert losses[-1] < 1.0

    model = est.get_model()
    pred = model.predict(np.array([[0.5, 0.5]], dtype=np.float32), verbose=0)
    assert abs(float(pred[0, 0]) - 8.5) < 2.0
