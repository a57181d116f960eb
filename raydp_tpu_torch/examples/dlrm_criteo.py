"""DLRM on Criteo-shaped data, on the port: the counterpart of the
repository's ``examples/dlrm_criteo.py``. The categorical hashing runs on
the ETL engine (``F.hash``, the category -> id step); the embedding tables
are split over the "model" axis of a mesh of ranks; the dot interaction is
the hand-written kernel on the card.

One rank, or ``torch.distributed.run``'s ranks (each starts its own ETL
session on the same seeded frame; the mesh is {"data": W // m, "model":
m}, m = 2 where W is even)::

    python -m raydp_tpu_torch.examples.dlrm_criteo [--device cpu]
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m raydp_tpu_torch.examples.dlrm_criteo [--device cpu]

``EXAMPLE_ROWS`` (50,000) and ``EXAMPLE_EPOCHS`` (3) size the run. As in
the JAX script's code, no argument names a Criteo file.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from raydp_tpu_torch.examples._common import knob, owned_runtime, parser

NUM_DENSE = 4
CAT_VOCABS = [1000, 1000, 500, 100]
DENSE_COLS = [f"i{i}" for i in range(NUM_DENSE)]
CAT_COLS = [f"c{j}" for j in range(len(CAT_VOCABS))]
MODEL = dict(vocab_sizes=CAT_VOCABS, num_dense=NUM_DENSE, embed_dim=16,
             bottom_mlp=(64, 32), top_mlp=(64, 32))


def synthetic_criteo(n_rows: int) -> pd.DataFrame:
    """Criteo-shaped rows from ``default_rng(3)``: the JAX script's frame."""
    rng = np.random.default_rng(3)
    data = {"label": rng.integers(0, 2, n_rows).astype(np.float32)}
    for i in range(NUM_DENSE):
        data[f"i{i}"] = rng.integers(0, 100, n_rows).astype(np.float32)
    for j, vocab in enumerate(CAT_VOCABS):
        data[f"c{j}"] = [f"cat{v}" for v in rng.integers(0, vocab, n_rows)]
    return pd.DataFrame(data)


def criteo_features(df, F):
    """log1p of the dense ints; each category hashed to an int32 id below
    its vocabulary (ids stay integers end to end: the estimator stages them
    as their own int32 matrix, exact at any vocabulary size)."""
    for i in range(NUM_DENSE):
        df = df.with_column(f"i{i}", F.log1p(F.col(f"i{i}")).cast("float32"))
    for j, vocab in enumerate(CAT_VOCABS):
        df = df.with_column(f"c{j}", F.hash(f"c{j}", vocab).cast("int32"))
    return df


def dlrm_mesh(world: int):
    """{"data": W // m, "model": m} over the default group's W ranks, m = 2
    where W is even."""
    from raydp_tpu_torch.parallel import make_mesh

    model_axis = 2 if world % 2 == 0 else 1
    return make_mesh({"data": world // model_axis, "model": model_axis})


def fit(model, train_df, test_df, mesh, num_epochs: int, device):
    """The estimator's fit of ``model`` (a ``DLRM`` or its state from
    elsewhere) on ``mesh``: (history, estimator)."""
    from raydp_tpu_torch.estimator import Estimator
    from raydp_tpu_torch.models import dlrm_optimizer, dlrm_sharding_rules

    est = Estimator(
        model=model,
        # Adafactor on the tables, Adam on the MLPs: dense Adam's two
        # full-table moment copies do not fit a card at real Criteo vocabs
        optimizer=dlrm_optimizer(),
        loss="bce",
        metrics=["accuracy"],
        feature_columns=DENSE_COLS + CAT_COLS,
        categorical_columns=CAT_COLS,  # (dense f32, ids i32) mixed staging
        label_column="label",
        batch_size=512,
        num_epochs=num_epochs,
        learning_rate=1e-3,
        mesh=mesh,
        param_sharding_rules=dlrm_sharding_rules(),
        device=device,
    )
    return est.fit_on_etl(train_df, test_df), est


def join_ranks(device):
    """(W, rank, device, joined): the default group where
    ``torch.distributed.run`` started this process (gloo, or NCCL where
    each rank has a card of its own), else a world of 1 with no group."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), device, False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1, 0, device, False
    if device.type == "cuda":
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0"))
            % torch.cuda.device_count())
        torch.cuda.set_device(device)
    own_cards = device.type == "cuda" and torch.cuda.device_count() >= world
    dist.init_process_group("nccl" if own_cards else "gloo",
                            init_method="env://")
    return dist.get_world_size(), dist.get_rank(), device, True


def main(argv=None) -> dict:
    """Run the example; returns its history and fitted estimator."""
    from raydp_tpu_torch._device import resolve_device

    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    world, rank, device, joined = join_ranks(device)

    import torch.distributed as dist

    import raydp_tpu_torch
    from raydp_tpu_torch.cluster import api as cluster_api
    from raydp_tpu_torch.etl import functions as F
    from raydp_tpu_torch.models import DLRM

    try:
        with owned_runtime():
            session = raydp_tpu_torch.init_etl(
                "dlrm", num_executors=2, executor_cores=2, executor_memory="1G"
            )
            if world > 1:  # each rank's session of its own
                print(f"rank {rank}/{world}: ETL session "
                      f"{cluster_api.session_dir()}", flush=True)
            rows = knob("EXAMPLE_ROWS", 50_000)
            df = criteo_features(
                session.from_pandas(synthetic_criteo(rows), num_partitions=8), F)
            train_df, test_df = df.random_split([0.9, 0.1], seed=0)
            model = DLRM(**MODEL, device=device, seed=0)
            history, est = fit(model, train_df, test_df, dlrm_mesh(world),
                               knob("EXAMPLE_EPOCHS", 3), device)
            if rank == 0:
                for record in history:
                    print(record)
            raydp_tpu_torch.stop_etl()
    finally:
        if joined:
            dist.destroy_process_group()
    return {"history": history, "estimator": est, "world": world}


if __name__ == "__main__":
    main()
