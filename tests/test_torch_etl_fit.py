"""``Estimator.fit_on_etl`` (the port) held against
``JaxEstimator.fit_on_etl`` and against the port's own fit from numpy.

The DataFrame is ``bench.py``'s ``make_criteo_frame`` query at a small
size: ``from_pandas`` in 4 partitions, ``log1p`` on the dense columns,
``F.hash`` on the id columns, and the label the parity of the hashed
``c0`` (``(F.col("c0") % 2).cast("float32")``), so the loss can fall. Each
package runs it in its own ETL session (1 executor, 1 core) and fits a
small DLRM through ``fit_on_etl``: through the object store and through
``fs_directory``, with and without ``stop_etl_after_conversion``.

- Against the JAX package: per-epoch ``train_loss`` within 1e-4 relative,
  the bound of ``tests/test_torch_dlrm_fit.py`` (the same f32 arithmetic in
  two orders).
- Inside the port, bit for bit: every loss and every parameter of the fit
  from the ETL ``Dataset`` equal those of ``Estimator.fit`` on an
  ``ArrayDataset`` of the same columns in the same blocks, staged and
  streamed; the streamed fit decodes on the session's executors
  (``stream_stats_["executor_decode"]``).
- A pandas frame goes through ``_check_and_convert`` as in the JAX
  package, and its refusals carry the same messages.
"""

import functools
import importlib
import signal

import numpy as np
import pandas as pd
import pytest
import torch

PACKAGES = ("raydp_tpu_torch", "raydp_tpu")
VOCABS = [97, 13]
DENSE = ["d0", "d1", "d2"]
IDS = ["c0", "c1"]


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
    """No session of either package is left up before or after."""
    stop_everything()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU sums do not vary with the load
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        stop_everything()


def source_frame(n=1024, seed=0):
    """``make_criteo_source`` at a small width: dense columns >= 0, raw ids
    in a wide range."""
    rng = np.random.default_rng(seed)
    data = {c: (rng.standard_normal(n) ** 2).astype(np.float32) for c in DENSE}
    data.update({c: rng.integers(0, 1 << 40, n) for c in IDS})
    return pd.DataFrame(data)


def criteo_query(session, F, pdf, parts=4):
    df = session.from_pandas(pdf, num_partitions=parts)
    for c in DENSE:
        df = df.with_column(c, F.log1p(F.col(c)))
    for c, vocab in zip(IDS, VOCABS):
        df = df.with_column(c, F.hash(c, vocab))
    return df.with_column("label", (F.col("c0") % 2).cast("float32"))


def settings(**kw):
    out = dict(optimizer="adam", loss="bce", feature_columns=DENSE + IDS,
               categorical_columns=IDS, label_column="label", batch_size=64,
               num_epochs=2, learning_rate=1e-2, seed=0)
    out.update(kw)
    return out


@functools.lru_cache(maxsize=None)
def flax_start():
    """The flax DLRM and its initial parameters (``PRNGKey(0)``, as the JAX
    estimator initialises), and the port's DLRM state converted from them."""
    import jax
    import jax.numpy as jnp

    from raydp_tpu.models import DLRM as FlaxDLRM
    from raydp_tpu_torch.models.convert import dlrm_params_from_flax

    flax_model = FlaxDLRM(vocab_sizes=VOCABS, num_dense=len(DENSE),
                          embed_dim=8)
    params = flax_model.init(
        jax.random.PRNGKey(0),
        (jnp.zeros((64, len(DENSE)), jnp.float32),
         jnp.zeros((64, len(IDS)), jnp.int32)))
    state = dlrm_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return flax_model, state


def port_model():
    from raydp_tpu_torch.models.dlrm import DLRM

    model = DLRM(VOCABS, len(DENSE), 8, device="cpu")
    model.load_state_dict(flax_start()[1])
    return model


def one_device_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("data",))


def fit_on_etl(package, path, stop, tmp, **kw):
    """One ``fit_on_etl`` of ``package`` in a session of its own: (history,
    estimator)."""
    etl = importlib.import_module(package + ".etl.session")
    F = importlib.import_module(package + ".etl.functions")
    session = etl.init_etl(f"fit-{path}-{stop}", num_executors=1,
                           executor_cores=1, executor_memory="300M")
    try:
        df = criteo_query(session, F, source_frame())
        if package == "raydp_tpu":
            from raydp_tpu.estimator import JaxEstimator

            est = JaxEstimator(model=flax_start()[0], mesh=one_device_mesh(),
                               **settings(**kw))
        else:
            from raydp_tpu_torch.estimator import Estimator

            est = Estimator(model=port_model(), device="cpu", **settings(**kw))
        fs = str(tmp / f"{package}-{path}-{stop}") if path == "fs" else None
        history = est.fit_on_etl(df, fs_directory=fs,
                                 stop_etl_after_conversion=stop)
        assert session._stopped is stop
        return history, est
    finally:
        session.stop()


@functools.lru_cache(maxsize=None)
def array_dataset():
    """The query's columns in the query's 4 blocks, as numpy: the port's
    ETL ``Dataset`` read block by block into an ``ArrayDataset``."""
    import raydp_tpu_torch as rt
    from raydp_tpu_torch.etl import functions as F
    from raydp_tpu_torch.exchange.dataset import ArrayDataset

    session = rt.init_etl("fit-arrays", num_executors=1, executor_cores=1,
                          executor_memory="300M")
    try:
        ds = rt.dataframe_to_dataset(criteo_query(session, F, source_frame()))
        assert ds.num_blocks == 4 and ds.count() == 1024
        blocks = [ds.get_block(i) for i in range(ds.num_blocks)]
        return ArrayDataset.from_blocks(
            [{c: b.column(c).to_numpy() for c in b.column_names}
             for b in blocks])
    finally:
        session.stop()


def assert_same_fit(a, b):
    ha, hb = a[0], b[0]
    assert [r["train_loss"] for r in ha] == [r["train_loss"] for r in hb]
    sa, sb = a[1].get_model().state_dict(), b[1].get_model().state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


@pytest.mark.parametrize("path,stop", [("store", False), ("store", True),
                                       ("fs", False), ("fs", True)])
def test_fit_on_etl_matches_jax_and_numpy(path, stop, tmp_path):
    port = fit_on_etl("raydp_tpu_torch", path, stop, tmp_path)
    ref = fit_on_etl("raydp_tpu", path, stop, tmp_path)
    assert [r["epoch"] for r in port[0]] == [r["epoch"] for r in ref[0]]
    for got, want in zip(port[0], ref[0]):
        rel = abs(got["train_loss"] - want["train_loss"]) / abs(
            want["train_loss"])
        assert rel <= 1e-4, (got["train_loss"], want["train_loss"])

    assert_same_fit(port, numpy_fit())


@functools.lru_cache(maxsize=None)
def numpy_fit():
    """``Estimator.fit`` on ``array_dataset()``: (history, estimator)."""
    from raydp_tpu_torch.estimator import Estimator

    est = Estimator(model=port_model(), device="cpu", **settings())
    return est.fit(array_dataset()), est


def test_streamed_fit_on_etl_decodes_on_the_executors():
    """``streaming=True`` with the session alive: the spans are decoded on
    the ETL executors, and the fit equals the streamed fit from the
    ``ArrayDataset`` bit for bit (losses and parameters)."""
    from raydp_tpu_torch.estimator import Estimator

    kw = dict(streaming=True, stream_scan_steps=4)
    port = fit_on_etl("raydp_tpu_torch", "store", False, None, **kw)
    assert port[1].stream_stats_["executor_decode"] is True
    est = Estimator(model=port_model(), device="cpu", **settings(**kw))
    from_arrays = (est.fit(array_dataset()), est)
    assert est.stream_stats_["executor_decode"] is False
    assert_same_fit(port, from_arrays)
    off = fit_on_etl("raydp_tpu_torch", "store", False, None,
                     stream_executor_decode=False, **kw)
    assert off[1].stream_stats_["executor_decode"] is False
    assert_same_fit(off, from_arrays)


def test_check_and_convert_takes_pandas_as_the_jax_package():
    from raydp_tpu.estimator import JaxEstimator
    from raydp_tpu_torch.estimator import Estimator

    pdf = source_frame(n=50)
    estimators = {"raydp_tpu_torch": Estimator(device="cpu"),
                  "raydp_tpu": JaxEstimator()}
    out = {}
    for package, est in estimators.items():
        with pytest.raises(RuntimeError) as no_session:
            est._check_and_convert(pdf)
        with pytest.raises(TypeError) as bad_type:
            est._check_and_convert([1, 2])
        etl = importlib.import_module(package + ".etl.session")
        session = etl.init_etl("fit-pandas", num_executors=1,
                               executor_cores=1, executor_memory="300M")
        try:
            df = est._check_and_convert(pdf)
            assert est._check_and_convert(df) is df
            table = df.to_arrow().combine_chunks()
        finally:
            session.stop()
        out[package] = (str(no_session.value), str(bad_type.value), table)
    port, ref = out["raydp_tpu_torch"], out["raydp_tpu"]
    assert port[0] == ref[0].replace("raydp_tpu.", "raydp_tpu_torch.")
    assert port[1] == ref[1].replace("raydp_tpu.", "raydp_tpu_torch.")
    assert port[2].equals(ref[2], check_metadata=True)
