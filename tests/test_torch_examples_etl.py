"""The port's ETL examples (``raydp_tpu_torch/examples/{nyctaxi,
data_process,dlrm_criteo}.py``) held against the repository's JAX scripts
(``examples/nyctaxi_jax.py``, ``examples/data_process.py``,
``examples/dlrm_criteo.py``).

- The synthetic frames equal the JAX scripts' exactly.
- Each query's output (and its ``random_split``) equals the JAX
  package's query over the same rows exactly: the JAX scripts' queries are
  written out here as they stand, over the JAX package's session.
- ``nyctaxi``'s and ``dlrm_criteo``'s fits at W 1, from the JAX side's
  initial parameters (``PRNGKey(0)``, converted by
  ``models/convert.py``), are within 1e-4 relative per epoch's
  ``train_loss`` of ``JaxEstimator`` on a one-device mesh (the bound of
  ``tests/test_torch_etl_fit.py``).
- Each runs once as a user runs it (``python -m
  raydp_tpu_torch.examples.<name> --device cpu``, ``EXAMPLE_ROWS=5000
  EXAMPLE_EPOCHS=2``) printing what ``tests/test_examples.py`` asserts,
  and ``dlrm_criteo`` once under ``torch.distributed.run`` with two ranks
  (mesh data 1 x model 2), each rank in an ETL session of its own.
"""

import functools
import importlib
import importlib.util
import re
import signal
import socket
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from torch_examples_common import run_ok

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("raydp_tpu_torch", "raydp_tpu")
ROWS, EPOCHS = 3000, 2


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
    torch.set_num_threads(1)  # the CPU sums do not vary with the load
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        stop_everything()


def jax_script(name: str):
    """``examples/<name>.py`` of the repository, loaded as a module (its
    imports are the JAX package's)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(path.parent))  # data_process imports nyctaxi_jax
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(path.parent))
    return module


def session_of(package: str, name: str):
    etl = importlib.import_module(package + ".etl.session")
    return etl.init_etl(name, num_executors=1, executor_cores=1,
                        executor_memory="300M")


def functions_of(package: str):
    return importlib.import_module(package + ".etl.functions")


# the JAX scripts' queries, as they stand there


def jax_taxi_query(df, F):  # examples/nyctaxi_jax.py
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
        .dropna()
    )


def jax_trips_report(df, F):  # examples/data_process.py
    trips = (
        df.with_column("hour", F.hour("pickup_ts"))
        .with_column("dow", F.dayofweek("pickup_ts"))
        .with_column("fare", F.col("fare_amount").cast("float64"))
        .select("hour", "dow", "passenger_count", "fare")
        .filter(F.col("fare") > 0)
    )
    by_hour = trips.groupby("hour").agg(
        trips=("count", "*"), avg_fare=("mean", "fare")
    )
    by_dow = trips.groupby("dow").agg(dow_trips=("count", "*"))
    report = (
        trips.groupby("hour", "dow")
        .agg(n=("count", "*"), fare_sum=("sum", "fare"))
        .join(by_hour, on="hour")
        .join(by_dow, on="dow")
        .sort("n", ascending=False)
        .limit(10)
        .to_pandas()
    )
    return report, trips.count()


def jax_criteo_query(df, F, num_dense, vocabs):  # examples/dlrm_criteo.py
    for i in range(num_dense):
        df = df.with_column(f"i{i}", F.log1p(F.col(f"i{i}")).cast("float32"))
    for j, vocab in enumerate(vocabs):
        df = df.with_column(f"c{j}", F.hash(f"c{j}", vocab).cast("int32"))
    return df


def test_synthetic_frames_equal_the_jax_scripts():
    from raydp_tpu_torch.examples import dlrm_criteo, nyctaxi

    pd.testing.assert_frame_equal(nyctaxi.synthetic_taxi(ROWS),
                                  jax_script("nyctaxi_jax").synthetic_taxi(ROWS),
                                  check_exact=True)
    jax_dlrm = jax_script("dlrm_criteo")
    assert (dlrm_criteo.NUM_DENSE, dlrm_criteo.CAT_VOCABS) == (
        jax_dlrm.NUM_DENSE, jax_dlrm.CAT_VOCABS)
    pd.testing.assert_frame_equal(dlrm_criteo.synthetic_criteo(ROWS),
                                  jax_dlrm.synthetic_criteo(ROWS),
                                  check_exact=True)


def split_frames(package: str, query):
    """``query(df, F)`` over the synthetic taxi rows in ``package``'s
    session, then the JAX script's ``random_split([0.9, 0.1], seed=0)``:
    the whole output and both splits as pandas."""
    from raydp_tpu_torch.examples.nyctaxi import synthetic_taxi

    session = session_of(package, f"taxi-{package}")
    try:
        df = query(session.from_pandas(synthetic_taxi(ROWS), num_partitions=8),
                   functions_of(package))
        train, test = df.random_split([0.9, 0.1], seed=0)
        return [x.to_pandas() for x in (df, train, test)]
    finally:
        session.stop()


def test_nyctaxi_query_equals_the_jax_scripts():
    from raydp_tpu_torch.examples.nyctaxi import taxi_features

    port = split_frames("raydp_tpu_torch", taxi_features)
    ref = split_frames("raydp_tpu", jax_taxi_query)
    assert len(port[0]) == ROWS and 0 < len(port[2]) < len(port[1])
    for got, want in zip(port, ref):
        pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_data_process_report_equals_the_jax_scripts():
    from raydp_tpu_torch.examples.data_process import busiest_report, trips_query
    from raydp_tpu_torch.examples.nyctaxi import synthetic_taxi

    out = {}
    for package in PACKAGES:
        session = session_of(package, f"report-{package}")
        try:
            df = session.from_pandas(synthetic_taxi(ROWS), num_partitions=8)
            F = functions_of(package)
            if package == "raydp_tpu":
                out[package] = jax_trips_report(df, F)
            else:
                trips = trips_query(df, F)
                out[package] = (busiest_report(trips), trips.count())
        finally:
            session.stop()
    (port, port_count), (ref, ref_count) = out["raydp_tpu_torch"], out["raydp_tpu"]
    assert port_count == ref_count == ROWS
    assert len(port) == 10
    pd.testing.assert_frame_equal(port, ref, check_exact=True)


def one_device_mesh(axes):
    import jax

    from raydp_tpu.parallel import make_mesh

    return make_mesh(axes, jax.devices()[:1])


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


def taxi_fit(package: str):
    """The nyctaxi example's fit at W 1 in ``package``'s session: the port
    through ``nyctaxi.fit`` from the JAX side's initial parameters, the JAX
    package through ``JaxEstimator`` as its script builds it (one-device
    mesh)."""
    from raydp_tpu_torch.examples import nyctaxi

    session = session_of(package, f"taxi-fit-{package}")
    try:
        query = nyctaxi.taxi_features if package == "raydp_tpu_torch" else jax_taxi_query
        df = query(session.from_pandas(nyctaxi.synthetic_taxi(ROWS),
                                       num_partitions=8), functions_of(package))
        train_df, test_df = df.random_split([0.9, 0.1], seed=0)
        if package == "raydp_tpu_torch":
            from raydp_tpu_torch.models import MLPRegressor
            from raydp_tpu_torch.models.convert import mlp_params_from_flax

            model = MLPRegressor(len(nyctaxi.FEATURES), device="cpu")
            model.load_state_dict(mlp_params_from_flax(flax_mlp_start()))
            return nyctaxi.fit(model, train_df, test_df, EPOCHS, "cpu")[0]
        from raydp_tpu.estimator import JaxEstimator
        from raydp_tpu.models import MLPRegressor as FlaxMLP

        est = JaxEstimator(
            model=FlaxMLP(), optimizer="adam", loss="mse",
            metrics=["mse", "mae"], feature_columns=nyctaxi.FEATURES,
            label_column="label", batch_size=256, num_epochs=EPOCHS,
            learning_rate=1e-3, mesh=one_device_mesh({"data": 1}),
        )
        return est.fit_on_etl(train_df, test_df, stop_etl_after_conversion=True)
    finally:
        session.stop()


@functools.lru_cache(maxsize=None)
def flax_mlp_start():
    """``JaxEstimator``'s initial parameters of the script's
    ``MLPRegressor()``: ``PRNGKey(0)`` over a batch of 4 features."""
    import jax
    import jax.numpy as jnp

    from raydp_tpu.models import MLPRegressor as FlaxMLP

    params = FlaxMLP().init(jax.random.PRNGKey(0), jnp.zeros((256, 4)))
    return jax.tree_util.tree_map(np.asarray, params)


def test_nyctaxi_fit_matches_jax_estimator():
    port = taxi_fit("raydp_tpu_torch")
    ref = taxi_fit("raydp_tpu")
    assert [r["epoch"] for r in port] == [r["epoch"] for r in ref] == [0, 1]
    for got, want in zip(port, ref):
        assert rel(got["train_loss"], want["train_loss"]) <= 1e-4, (got, want)
        assert rel(got["eval_loss"], want["eval_loss"]) <= 1e-4, (got, want)


def criteo_frames(package: str):
    """The DLRM example's query over the synthetic Criteo rows in
    ``package``'s session: (session, df, train, test)."""
    from raydp_tpu_torch.examples import dlrm_criteo as ex

    session = session_of(package, f"criteo-{package}")
    df = ex.synthetic_criteo(ROWS)
    df = session.from_pandas(df, num_partitions=8)
    F = functions_of(package)
    if package == "raydp_tpu_torch":
        df = ex.criteo_features(df, F)
    else:
        df = jax_criteo_query(df, F, ex.NUM_DENSE, ex.CAT_VOCABS)
    train, test = df.random_split([0.9, 0.1], seed=0)
    return session, df, train, test


def test_dlrm_query_equals_the_jax_scripts():
    out = {}
    for package in PACKAGES:
        session, *frames = criteo_frames(package)
        try:
            out[package] = [x.to_pandas() for x in frames]
        finally:
            session.stop()
    assert len(out["raydp_tpu"][0]) == ROWS
    assert out["raydp_tpu"][0]["c0"].dtype == np.int32
    for got, want in zip(out["raydp_tpu_torch"], out["raydp_tpu"]):
        pd.testing.assert_frame_equal(got, want, check_exact=True)


@functools.lru_cache(maxsize=None)
def flax_dlrm():
    """The script's flax DLRM and ``JaxEstimator``'s initial parameters of
    it (``PRNGKey(0)`` over a batch of dense f32 and id i32 columns)."""
    import jax
    import jax.numpy as jnp

    from raydp_tpu.models import DLRM as FlaxDLRM
    from raydp_tpu_torch.examples.dlrm_criteo import MODEL, NUM_DENSE

    model = FlaxDLRM(**MODEL)
    n_cat = len(MODEL["vocab_sizes"])
    params = model.init(jax.random.PRNGKey(0),
                        (jnp.zeros((512, NUM_DENSE), jnp.float32),
                         jnp.zeros((512, n_cat), jnp.int32)))
    return model, jax.tree_util.tree_map(np.asarray, params)


def test_dlrm_fit_matches_jax_estimator():
    """W 1: the port's mesh {"data": 1, "model": 1} with no process group
    against ``JaxEstimator`` on the script's mesh over one device, both
    with ``dlrm_optimizer()`` and ``dlrm_sharding_rules()``."""
    from raydp_tpu_torch.examples import dlrm_criteo as ex
    from raydp_tpu_torch.models import DLRM
    from raydp_tpu_torch.models.convert import dlrm_params_from_flax

    session, _, train_df, test_df = criteo_frames("raydp_tpu_torch")
    try:
        model = DLRM(**ex.MODEL, device="cpu")
        model.load_state_dict(dlrm_params_from_flax(flax_dlrm()[1]))
        port = ex.fit(model, train_df, test_df, ex.dlrm_mesh(1), EPOCHS,
                      "cpu")[0]
    finally:
        session.stop()

    from raydp_tpu.estimator import JaxEstimator
    from raydp_tpu.models import dlrm_optimizer, dlrm_sharding_rules

    session, _, train_df, test_df = criteo_frames("raydp_tpu")
    try:
        est = JaxEstimator(
            model=flax_dlrm()[0], optimizer=dlrm_optimizer(), loss="bce",
            metrics=["accuracy"], feature_columns=ex.DENSE_COLS + ex.CAT_COLS,
            categorical_columns=ex.CAT_COLS, label_column="label",
            batch_size=512, num_epochs=EPOCHS, learning_rate=1e-3,
            mesh=one_device_mesh({"data": 1, "model": 1}),
            param_sharding_rules=dlrm_sharding_rules(),
        )
        ref = est.fit_on_etl(train_df, test_df)
    finally:
        session.stop()
    assert [r["epoch"] for r in port] == [r["epoch"] for r in ref] == [0, 1]
    for got, want in zip(port, ref):
        assert rel(got["train_loss"], want["train_loss"]) <= 1e-4, (got, want)
        assert rel(got["eval_loss"], want["eval_loss"]) <= 1e-4, (got, want)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("name,expected", [
    ("nyctaxi", ("train_loss",)),
    ("data_process", ("total trips:",)),
    ("dlrm_criteo", ("train_loss",)),
])
def test_example_runs_as_a_user_runs_it(name, expected):
    args = [f"raydp_tpu_torch.examples.{name}"]
    if name != "data_process":
        args.append("--device=cpu")
    stdout = run_ok(args)
    for text in expected:
        assert text in stdout, stdout
    if name == "data_process":
        assert "total trips: 5000" in stdout


def test_dlrm_under_torchrun_splits_the_tables_over_two_ranks():
    """``python -m torch.distributed.run --nproc-per-node 2``: W 2, the mesh
    {"data": 1, "model": 2}; each rank runs an ETL session of its own on
    the same seeded frame, and the two never meet (two session directories
    and heads; both ranks finish, so neither's shutdown took the other's
    session). The loss falls."""
    stdout = run_ok(
        ["torch.distributed.run", "--nproc-per-node", "2", "--master-addr",
         "localhost", "--master-port", str(free_port()), "-m",
         "raydp_tpu_torch.examples.dlrm_criteo", "--device", "cpu"],
        timeout=100)
    sessions = dict(re.findall(r"rank (\d)/2: ETL session (\S+)", stdout))
    assert set(sessions) == {"0", "1"}, stdout
    assert sessions["0"] != sessions["1"]
    losses = [float(x) for x in re.findall(r"'train_loss': ([0-9.e-]+)", stdout)]
    assert len(losses) == 2 and losses[1] < losses[0], stdout
