"""The port's native GBDT and ``XGBoostEstimator`` held against the JAX
package's.

The GBDT is numpy on the host in both packages, so on the same shards the
two ``train_distributed`` must give the same model exactly: the quantile
edges, the base score, every tree's arrays, the history and the
predictions.

- The JAX package's single-process case (4000 rows of z = 3x + 4y + 5, 25
  rounds of depth 4) through both packages' trainers at world 1, and at
  world 2 through a fake job whose two ranks run in this process, each
  with its own ``_STATE`` (the module global is swapped around each call),
  for ``reg:squarederror`` and ``binary:logistic``.
- The port's ``XGBoostEstimator.fit_on_etl`` at ``num_workers=2`` on the
  port's cluster gives the booster of the two-rank fake job fed the
  dataset's equal shares.
- ``backend`` is validated, and ``auto`` takes the native backend where
  ``xgboost`` is absent (here, and on the card's machine).
- The xgboost-collective branch against ``tests/xgb_stub`` (a real TCP
  tracker on the driver): the model is the label mean allreduced across
  both ranks' shards, as the JAX package's test holds its estimator.
"""

import os
import signal
import sys
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from raydp_tpu.estimator import gbdt_native as jax_gbdt
from raydp_tpu_torch.estimator import gbdt_native as port_gbdt

MODULES = {"raydp_tpu": jax_gbdt, "raydp_tpu_torch": port_gbdt}
PARAMS = {"reg:squarederror": {"objective": "reg:squarederror", "eta": 0.3,
                               "max_depth": 4},
          "binary:logistic": {"objective": "binary:logistic", "eta": 0.3,
                              "max_depth": 3}}


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


class FakeShard:
    def __init__(self, features, labels):
        self.features, self.labels = features, labels

    def to_numpy(self, cols, label):
        return self.features, self.labels


class FakeJob:
    """``world`` ranks run in this process, one after another, each with
    its own rank state: ``module._STATE`` is swapped around each call."""

    job_name = "fake"

    def __init__(self, module, world: int):
        self.module, self.world = module, world
        self.states = [{} for _ in range(world)]

    def run(self, fn, timeout=None):
        saved = self.module._STATE
        out = []
        try:
            for rank in range(self.world):
                self.module._STATE = self.states[rank]
                out.append(fn(SimpleNamespace(rank=rank, world_size=self.world)))
        finally:
            self.module._STATE = saved
        return out


def case(objective: str, n: int = 4000):
    rng = np.random.default_rng(3)
    features = rng.random((n, 2))
    if objective == "binary:logistic":
        labels = (features.sum(axis=1) > 1.0).astype(np.float64)
    else:
        labels = 3 * features[:, 0] + 4 * features[:, 1] + 5
    return features, labels


def train(module, shards, objective, rounds):
    return module.train_distributed(FakeJob(module, len(shards)), shards,
                                    PARAMS[objective], rounds, ["x", "y"], "z")


def halves(features, labels, world):
    per = len(features) // world
    return [FakeShard(features[r * per:(r + 1) * per],
                      labels[r * per:(r + 1) * per]) for r in range(world)]


def assert_same_booster(got, want, probe):
    assert got.base_score == want.base_score
    assert (got.objective, got.learning_rate) == (want.objective,
                                                  want.learning_rate)
    assert len(got.edges) == len(want.edges)
    assert all(np.array_equal(a, b) for a, b in zip(got.edges, want.edges))
    assert len(got.trees) == len(want.trees)
    for a, b in zip(got.trees, want.trees):
        for field in ("feature", "threshold_bin", "left", "right", "value"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert np.array_equal(got.predict(probe), want.predict(probe))
    assert np.array_equal(got.predict(probe, output_margin=True),
                          want.predict(probe, output_margin=True))


@pytest.mark.parametrize("world,objective", [
    (1, "reg:squarederror"), (2, "reg:squarederror"), (2, "binary:logistic")])
def test_native_gbdt_matches_the_jax_package(world, objective):
    features, labels = case(objective)
    rounds = 25 if objective == "reg:squarederror" else 15
    got = {name: train(module, halves(features, labels, world), objective, rounds)
           for name, module in MODULES.items()}
    (port, port_hist), (ref, ref_hist) = got["raydp_tpu_torch"], got["raydp_tpu"]
    probe = np.random.default_rng(7).random((256, 2))
    assert_same_booster(port, ref, probe)
    assert port_hist == ref_hist
    if objective == "reg:squarederror":
        pred = port.predict(features)
        assert float(np.sqrt(np.mean((pred - labels) ** 2))) < 0.1
    else:
        acc = np.mean((port.predict(probe) > 0.5) == (probe.sum(axis=1) > 1.0))
        assert acc > 0.9
    again = port_gbdt.NativeBooster.load_raw(port.save_raw())
    assert np.array_equal(again.predict(probe), port.predict(probe))
    assert all(not state for state in (port_gbdt._STATE, jax_gbdt._STATE))


def test_backend_validation():
    from raydp_tpu_torch.estimator import XGBoostEstimator
    from raydp_tpu_torch.estimator.xgboost_estimator import _have_xgboost

    with pytest.raises(ValueError):
        XGBoostEstimator(backend="nope")
    est = XGBoostEstimator()
    assert est.backend == ("xgboost" if _have_xgboost() else "native")
    if not _have_xgboost():
        with pytest.raises(ImportError, match="native"):
            XGBoostEstimator(backend="xgboost")
        with pytest.raises(RuntimeError, match="fit"):
            est.get_model()


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
    s = rt.init_etl("test-torch-gbdt", num_executors=2, executor_cores=1,
                    executor_memory="300M")
    try:
        yield s
    finally:
        stop_all()


def test_fit_on_etl_equals_the_two_rank_trainer(session):
    from raydp_tpu_torch.estimator import XGBoostEstimator
    from raydp_tpu_torch.exchange.dataset import dataframe_to_dataset

    features, labels = case("reg:squarederror", 2000)
    pdf = pd.DataFrame({"x": features[:, 0], "y": features[:, 1], "z": labels})
    frame = session.from_pandas(pdf, num_partitions=4)
    est = XGBoostEstimator(params=PARAMS["reg:squarederror"], num_boost_round=10,
                           feature_columns=["x", "y"], label_column="z",
                           num_workers=2, backend="native")
    est.fit_on_etl(frame)
    shards = [FakeShard(*shard.to_numpy(["x", "y"], "z"))
              for shard in dataframe_to_dataset(frame).split(2)]
    ref, history = train(port_gbdt, shards, "reg:squarederror", 10)
    probe = np.random.default_rng(7).random((256, 2))
    assert_same_booster(est.get_model(), ref, probe)
    assert est.history == history
    assert history[-1]["train_loss"] < history[0]["train_loss"] * 0.1


def test_xgboost_collective_branch_with_stub(session, monkeypatch):
    """The collective branch, with the tracker on the driver at the address
    the port's head gives: correct only if both ranks rendezvoused and
    allreduced their shards' label sums."""
    from raydp_tpu_torch.estimator import XGBoostEstimator

    stub = os.path.join(os.path.dirname(__file__), "xgb_stub")
    monkeypatch.syspath_prepend(stub)
    monkeypatch.setenv(
        "PYTHONPATH", stub + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for mod in ("xgboost", "xgboost.tracker"):
        sys.modules.pop(mod, None)
    try:
        import xgboost

        assert xgboost.__version__.endswith("stub"), "stub did not resolve"
        n = 2000
        rng = np.random.default_rng(3)
        pdf = pd.DataFrame(
            {"x": rng.random(n), "y": (3 * rng.random(n) + 1).astype(np.float64)})
        est = XGBoostEstimator(params={"objective": "reg:squarederror"},
                               num_boost_round=3, feature_columns=["x"],
                               label_column="y", num_workers=2,
                               backend="xgboost")
        est.fit_on_etl(session.from_pandas(pdf, num_partitions=4))
        booster = est.get_model()
        assert booster.n_seen == n
        assert abs(booster.value - float(pdf["y"].mean())) < 1e-6
    finally:
        for mod in ("xgboost", "xgboost.tracker"):
            sys.modules.pop(mod, None)
