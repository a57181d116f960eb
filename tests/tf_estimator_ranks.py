"""Rank programs of ``tests/test_torch_tf_estimator.py``: one worker of a
``MultiWorkerMirroredStrategy`` on the CPU, started with
``multiprocessing``'s spawn.

Each rank takes its contiguous equal share of the same numpy data
(``FakeShard``, which returns what a store shard's ``to_numpy`` would) and
runs one package's per-rank program (the JAX package's ``_TFWorkerFn`` or
the port's) on the serialized model the test made once; the program writes
``TF_CONFIG`` and imports tensorflow itself. The result (history, rank 0's
weights, whether torch was imported) goes to ``<out>.<rank>`` by pickle. Tensorflow runs one intra-op
and one inter-op thread a rank.
"""

import importlib
import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np

N_ROWS, N_EVAL = 1024, 256
SETTINGS = dict(feature_columns=["x", "y"], label_column="z", batch_size=64,
                num_epochs=3, seed=0)


def case_arrays(n: int = N_ROWS, seed: int = 0):
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


def keras_model():
    import tensorflow as tf

    return tf.keras.Sequential([
        tf.keras.layers.Input(shape=(2,)),
        tf.keras.layers.Dense(32, activation="relu"),
        tf.keras.layers.Dense(1),
    ])


def run(rank, world, ports, out_path, package, config):
    """One rank of ``package``'s program; its result to ``<out>.<rank>``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["TF_NUM_INTRAOP_THREADS"] = "1"
    os.environ["TF_NUM_INTEROP_THREADS"] = "1"
    module = importlib.import_module(package + ".estimator.tf_estimator")
    shards = fake_shards(*case_arrays(), world)
    eval_shards = fake_shards(*case_arrays(N_EVAL, seed=1), world)
    fn = module._TFWorkerFn(config, shards, eval_shards,
                            [f"localhost:{p}" for p in ports])
    result = fn(SimpleNamespace(rank=rank, world_size=world))
    result["torch_imported"] = "torch" in sys.modules
    with open(f"{out_path}.{rank}.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(f"{out_path}.{rank}.tmp", f"{out_path}.{rank}")
