"""The port's ``TorchEstimator`` held against the JAX package's.

- **The rank against the reference's rank.** The JAX package's test case,
  z = 3x + 4y + 5 (4096 rows, a [2, 32, 1] MLP, Adam 1e-2, batch 64, 8
  epochs), with an evaluation set of 1000 rows, at world 1 and 2 in
  spawned processes over gloo (``tests/torch_estimator_ranks.py``): each
  package's per-rank program on the same fake shards, one intra-op thread
  a rank. Rank 0's parameters are equal bit for bit, and so is the history
  (``train_loss`` and ``eval_loss``): the port sums the epoch's loss on
  the device in f64, which is the reference's Python float sum, and keeps
  its f32 evaluation sums.
- **The port's own cluster.** ``fit_on_etl`` at ``num_workers=2`` through
  the port's ETL session, from the store and through ``fs_directory``,
  with the reference test's assertions (the loss below a fifth of the
  first, the model's prediction at (0.5, 0.5) within 2 of 8.5) on the same
  case in 4 partitions. The parameters and the losses equal those of the
  spawned ranks fed the dataset's two equal shares.
- ``max_retries`` restarts the job: a creator that fails on its first
  call fails the fit at 0 retries and is retried at 1.
- The optimizer forms (a name, a class, an instance, a callable) build the
  same optimizer as the reference's, in one process at world 1.
- ``get_model`` before ``fit`` raises.
"""

import multiprocessing
import pickle
import signal
import socket
import time
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import torch_estimator_ranks as ranks

PACKAGES = ("raydp_tpu", "raydp_tpu_torch")
RANK_LIMIT_S = 150.0


@pytest.fixture(autouse=True)
def alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError("test ran past its 150 s guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(150)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's rank takes one thread on the CPU; the reference's runs
    with the same count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_worlds(tmp_path, worlds: dict) -> dict:
    """Run every ``{key: (package, world, kwargs)}`` at once, each world in
    spawned processes of ``ranks.run``; every rank's result by key."""
    ctx = multiprocessing.get_context("spawn")
    procs, outs = [], {}
    for key, (package, world, kwargs) in worlds.items():
        port, out = free_port(), str(tmp_path / f"out-{package}-{key}")
        outs[key] = (out, world)
        procs += [ctx.Process(target=ranks.run,
                              args=(r, world, port, out, package, kwargs))
                  for r in range(world)]
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
    for key, (out, world) in outs.items():
        results[key] = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                results[key].append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return spawn_worlds(tmp_path_factory.mktemp("ddp"), {
        (package, world): (package, world, {})
        for package in PACKAGES for world in (1, 2)})


def states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def losses(history, key):
    return [r[key] for r in history]


@pytest.mark.parametrize("world", [1, 2])
def test_rank_matches_the_reference_rank(spawned, world):
    ref, port = spawned[("raydp_tpu", world)], spawned[("raydp_tpu_torch", world)]
    assert states_equal(port[0]["state"], ref[0]["state"])
    assert all(r["state"] is None for r in port[1:])
    for got, want in zip(port, ref):
        for key in ("train_loss", "eval_loss"):
            assert losses(got["history"], key) == losses(want["history"], key)
    assert len(port[0]["history"]) == ranks.SETTINGS["num_epochs"]
    stats = [r["stats"] for r in port]
    assert [s["rank"] for s in stats] == list(range(world))
    assert len({s["params_sha256"] for s in stats}) == 1
    assert all(s["backend"] == "gloo" and s["device"] == "cpu"
               and s["peak_bytes"] is None for s in stats)
    assert all(not any(s["launches"].values()) for s in stats)


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
    s = rt.init_etl("test-torch-ddp", num_executors=2, executor_cores=1,
                    executor_memory="300M")
    try:
        yield s
    finally:
        stop_all()


def case_frame(session, n=ranks.N_ROWS):
    features, labels = ranks.case_arrays(n)
    pdf = pd.DataFrame({"x": features[:, 0], "y": features[:, 1], "z": labels})
    return session.from_pandas(pdf, num_partitions=4)


def port_estimator(**kw):
    from raydp_tpu_torch.estimator import TorchEstimator

    settings = dict(ranks.SETTINGS, model=ranks.make_model, optimizer="Adam",
                    loss=torch.nn.MSELoss, num_workers=2, device="cpu")
    settings.update(kw)
    return TorchEstimator(**settings)


def shard_arrays(ds, world: int):
    """The features and labels of ``ds``'s equal shares, rank after rank
    (``split`` gives rank 0 blocks 0 and 2 of 4), so that the spawned
    ranks' contiguous halves are these shares."""
    parts = [shard.to_numpy(["x", "y"], "z") for shard in ds.split(world)]
    return (np.concatenate([f for f, _ in parts]),
            np.concatenate([l for _, l in parts]))


@pytest.mark.parametrize("use_fs_directory", [False, True])
def test_fit_on_etl_on_the_port_cluster(session, tmp_path, use_fs_directory):
    from raydp_tpu_torch.exchange.dataset import (
        dataframe_to_dataset, dataset_from_parquet)

    est = port_estimator()
    frame = case_frame(session)
    kwargs = {"fs_directory": str(tmp_path / "stage")} if use_fs_directory else {}
    history = est.fit_on_etl(frame, **kwargs)
    assert len(history) == 8
    assert history[-1]["train_loss"] < history[0]["train_loss"] * 0.2

    model = est.get_model()
    with torch.no_grad():
        pred = model(torch.tensor([[0.5, 0.5]]))
    assert abs(float(pred[0, 0]) - 8.5) < 2.0

    # the same shares through the spawned ranks: the same fit, bit for bit
    ds = (dataset_from_parquet(str(tmp_path / "stage" / "train"))
          if use_fs_directory else dataframe_to_dataset(frame))
    train = shard_arrays(ds, 2)
    ref = spawn_worlds(tmp_path, {"shares": (
        "raydp_tpu_torch", 2, {"train": train, "with_eval": False})})["shares"]
    assert states_equal(est._state, ref[0]["state"])
    assert losses(history, "train_loss") == losses(ref[0]["history"], "train_loss")
    stats = est.rank_stats_
    assert len({s["pid"] for s in stats}) == 2
    assert stats[0]["params_sha256"] == stats[1]["params_sha256"]


def test_max_retries_restarts_the_job(session, tmp_path):
    from raydp_tpu_torch.exchange.dataset import dataframe_to_dataset

    ds = dataframe_to_dataset(case_frame(session, 256))
    marker = tmp_path / "failed"
    est = port_estimator(model=ranks.FailsOnce(str(marker)), num_workers=1,
                         num_epochs=1)
    with pytest.raises(RuntimeError, match="first attempt fails"):
        est.fit(ds, max_retries=0)
    assert marker.exists()
    marker.unlink()
    history = est.fit(ds, max_retries=1)
    assert marker.exists() and len(history) == 1
    assert est.get_model() is not None


def optimizer_forms():
    return {
        "name": "SGD",
        "class": torch.optim.Adam,
        "instance": torch.optim.Adam([torch.zeros(1)], lr=5e-3, betas=(0.8, 0.9)),
        "callable": lambda model: torch.optim.SGD(model.parameters(), lr=0.05,
                                                  momentum=0.9),
    }


@pytest.mark.parametrize("form", ["name", "class", "instance", "callable"])
def test_optimizer_forms_match_the_reference(form):
    """One process, world 1: both packages' programs with the same
    optimizer form on 512 rows for 2 epochs end bit for bit equal."""
    data = ranks.case_arrays(512)
    results = {}
    for package in PACKAGES:
        fn = ranks.worker_fn(package, 1, f"localhost:{free_port()}",
                             optimizer=optimizer_forms()[form], train=data,
                             with_eval=False, num_epochs=2)
        results[package] = fn(SimpleNamespace(rank=0, world_size=1))
    ref, port = results["raydp_tpu"], results["raydp_tpu_torch"]
    assert states_equal(port["state"], ref["state"])
    assert losses(port["history"], "train_loss") == losses(ref["history"],
                                                            "train_loss")


def test_get_model_before_fit_raises():
    with pytest.raises(RuntimeError, match="fit"):
        port_estimator().get_model()


def test_the_ranks_take_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    from raydp_tpu_torch.estimator import TorchEstimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEstimator(model=ranks.make_model)
    assert TorchEstimator(model=ranks.make_model, device="cpu").device_type == "cpu"
