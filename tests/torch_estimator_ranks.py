"""Rank programs of ``tests/test_torch_ddp_estimator.py``: one process of a
gloo group on the CPU, started with ``multiprocessing``'s spawn.

Every rank makes the same data from the same seed with numpy
(``case_arrays``: the JAX package's TorchEstimator case, z = 3x + 4y + 5),
takes its contiguous equal share (``FakeShard``, which returns the same
numpy arrays a store shard's ``to_numpy`` would), builds the per-rank
program of one package's ``TorchEstimator`` (the JAX package's
``_TorchWorkerFn`` or the port's) and runs it with one intra-op thread.
The result (history, rank 0's state) goes to ``<out>.<rank>`` by pickle.
The module also holds the creators the tests ship to the port's cluster,
which its ranks import by reference.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import torch

N_ROWS, N_EVAL = 4096, 1000
SETTINGS = dict(feature_columns=["x", "y"], label_column="z", batch_size=64,
                num_epochs=8, learning_rate=1e-2, seed=0)


def case_arrays(n: int = N_ROWS, seed: int = 0):
    """(features [n, 2] f32, labels [n] f32) of z = 3x + 4y + 5, the JAX
    package's test data (x then y from ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    x = rng.random(n).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    return np.stack([x, y], axis=1), 3 * x + 4 * y + 5


class FakeShard:
    def __init__(self, features, labels):
        self.features, self.labels = features, labels

    def to_numpy(self, feature_columns, label_column):
        return self.features.copy(), self.labels.copy()


def fake_shards(features, labels, world: int):
    per = len(features) // world
    return [FakeShard(features[r * per:(r + 1) * per],
                      labels[r * per:(r + 1) * per]) for r in range(world)]


def make_model():
    return torch.nn.Sequential(torch.nn.Linear(2, 32), torch.nn.ReLU(),
                               torch.nn.Linear(32, 1))


class FailsOnce:
    """A creator that raises on its first call in any process (a marker
    file records the call), then builds ``make_model``."""

    def __init__(self, marker: str):
        self.marker = marker

    def __call__(self):
        if not os.path.exists(self.marker):
            with open(self.marker, "w") as f:
                f.write("failed once")
            raise RuntimeError("the creator's first attempt fails")
        return make_model()


def worker_fn(package: str, world: int, addr: str, optimizer="Adam",
              train=None, evaluation=None, with_eval=True, **settings):
    """One package's per-rank program for ``world`` ranks over the case's
    data (or ``train``/``evaluation`` arrays; no evaluation set without
    ``with_eval``), rendezvousing at ``addr``."""
    kw = dict(SETTINGS, model=make_model, optimizer=optimizer,
              loss=torch.nn.MSELoss, num_workers=world, **settings)
    if package == "raydp_tpu":
        from raydp_tpu.estimator.torch_estimator import TorchEstimator, _TorchWorkerFn
    else:
        from raydp_tpu_torch.estimator.torch_estimator import (
            TorchEstimator, _TorchWorkerFn)
        kw["device"] = "cpu"
    train = case_arrays() if train is None else train
    evaluation = case_arrays(N_EVAL, seed=1) if evaluation is None else evaluation
    shards = fake_shards(*train, world)
    eval_shards = fake_shards(*evaluation, world) if with_eval else None
    return _TorchWorkerFn(TorchEstimator(**kw), shards, eval_shards, addr)


def run(rank, world, port, out_path, package, kwargs):
    """One rank of ``package``'s program; its result to ``<out>.<rank>``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    torch.set_num_threads(1)
    fn = worker_fn(package, world, f"localhost:{port}", **kwargs)
    result = fn(SimpleNamespace(rank=rank, world_size=world))
    with open(f"{out_path}.{rank}.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(f"{out_path}.{rank}.tmp", f"{out_path}.{rank}")
