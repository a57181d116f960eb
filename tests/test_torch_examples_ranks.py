"""The port's rank examples (``raydp_tpu_torch/examples/{spmd_job_example,
long_context_lm,nyctaxi_torch,nyctaxi_tf,nyctaxi_xgboost}.py``) held
against the repository's JAX scripts.

- ``long_context_lm``: the 5 losses of the port's training loop, from the
  JAX side's ``PRNGKey(0)`` parameters (converted by
  ``models/convert.py``), against the JAX script's loop on a 1-device mesh
  (W 1, one process in a gloo group of one) and on a 2-device mesh (W 2,
  two gloo ranks spawned from ``tests/torch_examples_common.py``), within
  2e-5 relative each (f32 over 5 Adam steps, the sums in other orders).
- The DDP, Keras and GBDT scripts' queries equal the JAX scripts' over the
  same rows exactly.
- Each runs once as a user runs it (``python -m
  raydp_tpu_torch.examples.<name>``, ``--device cpu`` where it reaches the
  card, ``EXAMPLE_ROWS=5000 EXAMPLE_EPOCHS=2``, ``EXAMPLE_ROUNDS=5``),
  printing what ``tests/test_examples.py`` asserts.
"""

import dataclasses
import functools
import importlib
import signal
import time

import numpy as np
import pandas as pd
import pytest
import torch
import torch.distributed as dist

import torch_examples_common as ranks
from torch_examples_common import run_ok

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")
ROWS = 3000
RANK_LIMIT_S = 90.0
LOSS_RTOL = 2e-5


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


def stop_everything():
    for package in PACKAGES:
        etl = importlib.import_module(package + ".etl.session")
        while etl.active_session() is not None:
            etl.stop_etl()
        importlib.import_module(package + ".cluster.api").shutdown()


@pytest.fixture(scope="module", autouse=True)
def clean_clusters():
    stop_everything()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        stop_everything()


@functools.lru_cache(maxsize=None)
def jax_long_context(n_dev: int):
    """The JAX script's loop on an ``n_dev``-device mesh: (its initial
    parameters as numpy, its 5 losses)."""
    import jax
    import jax.numpy as jnp
    import optax

    from raydp_tpu.models import TransformerLM, sequence_parallel_apply
    from raydp_tpu.parallel import make_mesh

    from raydp_tpu_torch.examples import long_context_lm as ex

    mesh = make_mesh({"sp": n_dev}, jax.devices()[:n_dev])
    seq = 128 * n_dev
    model = TransformerLM(
        vocab_size=256, d_model=128, num_heads=n_dev, num_layers=2,
        max_len=seq, attn_impl="ring", dtype=jnp.float32,
    )
    tokens = jnp.asarray(ex.example_tokens(seq), jnp.int32)
    params = dataclasses.replace(model, attn_impl="full").init(
        jax.random.PRNGKey(0), tokens[:, :16]
    )
    start = jax.tree_util.tree_map(np.asarray, params)
    tx = optax.adam(3e-4)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, tokens):
        def loss_fn(p):
            logits = sequence_parallel_apply(model, p, tokens, mesh)
            shifted = jnp.roll(tokens, -1, axis=1)
            return jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(logits, shifted)
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return start, losses


def port_state(n_dev: int) -> dict:
    from raydp_tpu_torch.models.convert import params_from_flax

    return params_from_flax(jax_long_context(n_dev)[0])


def check_losses(got, want):
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_long_context_lm_matches_the_jax_loop_at_one_rank(tmp_path):
    from raydp_tpu_torch.examples import long_context_lm as ex
    from raydp_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        model = ex.make_model(1, "cpu")
        model.load_state_dict(port_state(1))
        losses = ex.train(model, ex.example_tokens(ex.TOKENS_PER_RANK),
                          make_mesh({"sp": 1}))
    finally:
        dist.destroy_process_group()
    check_losses(losses, jax_long_context(1)[1])


def test_long_context_lm_matches_the_jax_loop_at_two_ranks(tmp_path):
    state = tmp_path / "state.pt"
    torch.save(port_state(2), state)
    ctx = torch.multiprocessing.get_context("spawn")
    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    procs = [ctx.Process(target=ranks.run,
                         args=(r, 2, store, str(state), out)) for r in range(2)]
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
    assert [p.exitcode for p in procs] == [0, 0]
    got = [torch.load(f"{out}.{r}") for r in range(2)]
    assert got[0] == got[1]  # the global loss, on every rank
    check_losses(got[0], jax_long_context(2)[1])


# the JAX scripts' queries, as they stand there


def jax_ddp_query(df, F):  # examples/nyctaxi_torch.py and nyctaxi_tf.py
    return (
        df.with_column("hour", F.hour("pickup_ts").cast("float32"))
        .with_column("dow", F.dayofweek("pickup_ts").cast("float32"))
        .with_column("dx", F.col("dropoff_longitude") - F.col("pickup_longitude"))
        .with_column("dy", F.col("dropoff_latitude") - F.col("pickup_latitude"))
        .with_column(
            "dist",
            F.sqrt(F.col("dx") * F.col("dx") + F.col("dy") * F.col("dy")).cast("float32"),
        )
        .with_column("pc", F.col("passenger_count").cast("float32"))
        .with_column("label", F.col("fare_amount").cast("float32"))
        .select("hour", "dow", "dist", "pc", "label")
    )


def jax_gbdt_query(df, F):  # examples/nyctaxi_xgboost.py
    return (
        df.with_column("hour", F.hour("pickup_ts").cast("float32"))
        .with_column("dow", F.dayofweek("pickup_ts").cast("float32"))
        .with_column("pc", F.col("passenger_count").cast("float32"))
        .with_column("label", F.col("fare_amount").cast("float32"))
        .select("hour", "dow", "pc", "label")
    )


def query_output(package: str, query) -> pd.DataFrame:
    from raydp_tpu_torch.examples.nyctaxi import synthetic_taxi

    etl = importlib.import_module(package + ".etl.session")
    session = etl.init_etl(f"q-{package}", num_executors=1, executor_cores=1,
                           executor_memory="300M")
    try:
        df = session.from_pandas(synthetic_taxi(ROWS), num_partitions=4)
        return query(df, importlib.import_module(package + ".etl.functions")
                     ).to_pandas()
    finally:
        session.stop()


@pytest.mark.parametrize("example", ["nyctaxi_torch", "nyctaxi_tf",
                                     "nyctaxi_xgboost"])
def test_query_equals_the_jax_scripts(example):
    from raydp_tpu_torch.examples import nyctaxi_torch, nyctaxi_tf, nyctaxi_xgboost

    port_query, jax_query = {
        "nyctaxi_torch": (nyctaxi_torch.ddp_features, jax_ddp_query),
        "nyctaxi_tf": (nyctaxi_tf.ddp_features, jax_ddp_query),
        "nyctaxi_xgboost": (nyctaxi_xgboost.gbdt_features, jax_gbdt_query),
    }[example]
    got = query_output("raydp_tpu_torch", port_query)
    assert len(got) == ROWS
    pd.testing.assert_frame_equal(got, query_output("raydp_tpu", jax_query),
                                  check_exact=True)


@pytest.mark.parametrize("name,device,expected", [
    ("spmd_job_example", False, ("hello from rank 3/4", "sum over ranks: 79800")),
    ("long_context_lm", True, ("step 4",)),
    ("nyctaxi_torch", True, ("final train_loss",)),
    ("nyctaxi_tf", False, ("losses:",)),
    ("nyctaxi_xgboost", False, ("backend:", "prediction")),
])
def test_example_runs_as_a_user_runs_it(name, device, expected):
    args = [f"raydp_tpu_torch.examples.{name}"] + (["--device=cpu"] if device else [])
    stdout = run_ok(args)
    for text in expected:
        assert text in stdout, stdout
    if name == "spmd_job_example":
        assert [line for line in stdout.splitlines() if "hello" in line] == [
            f"hello from rank {r}/4" for r in range(4)]
