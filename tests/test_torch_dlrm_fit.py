"""The port's estimator (raydp_tpu_torch/estimator/) against
``raydp_tpu.estimator.JaxEstimator``, and its numpy data source
``ArrayDataset`` against the JAX package's staging rules.

``JaxEstimator`` stages through ``to_numpy`` / ``to_numpy_grouped`` when it
does not stream, so both estimators are fed the same ``ArrayDataset``. It
runs on a one-device mesh, the counterpart of the port's one card (its
single-device runners; on the suite's 8-device CPU mesh its per-batch
evaluation would drop the tail batch). The
port's model starts from the flax model's initial parameters (the JAX
estimator initialises with ``PRNGKey(seed)`` on the first batch), and both
shuffle with ``np.random.default_rng(seed + epoch)``, so the two fits take
the same steps on the same batches.

Tolerances, with their reasons: per-epoch ``train_loss``, ``eval_loss`` and
``evaluate`` within 1e-4 relative (measured ~2e-7: the same f32 arithmetic
in two orders over 24 Adam steps; a ReLU whose input sits at f32 noise
could amplify that, so the learning rate is one where none does).
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from raydp_tpu.estimator import JaxEstimator
from raydp_tpu.exchange.dataset import _table_to_numpy_grouped
from raydp_tpu.models import DLRM as FlaxDLRM
from raydp_tpu.models.mlp import MLPRegressor as FlaxMLPRegressor
from raydp_tpu_torch.estimator import Estimator
from raydp_tpu_torch.exchange.dataset import ArrayDataset
from raydp_tpu_torch.models.convert import dlrm_params_from_flax, mlp_params_from_flax
from raydp_tpu_torch.models.dlrm import DLRM
from raydp_tpu_torch.models.mlp import MLPRegressor

ROOT = Path(__file__).resolve().parents[1]

COLS = ["d0", "d1", "c0", "c1"]
VOCABS = [100, 20]


@pytest.fixture
def one_thread():
    """One intra-op thread, so the CPU kernels' sums do not vary with the
    machine's load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def criteo_like(n, seed, vocab0=100):
    """Two dense columns, two id columns, and the parity of c0 as the label
    (the signal of test_jax_estimator.py's criteo_df)."""
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, vocab0, n)
    return ArrayDataset({
        "d0": rng.random(n).astype(np.float32),
        "d1": rng.random(n).astype(np.float32),
        "c0": c0.astype(np.int64),
        "c1": rng.integers(0, 20, n).astype(np.int64),
        "label": (c0 % 2).astype(np.float32),
    })


def _settings(**kw):
    settings = dict(optimizer="adam", loss="bce", metrics=["accuracy", "mse"],
                    feature_columns=COLS, categorical_columns=["c0", "c1"],
                    label_column="label", batch_size=64, num_epochs=3,
                    learning_rate=1e-2, seed=0)
    settings.update(kw)
    return settings


@functools.lru_cache(maxsize=None)
def _fits():
    """(JAX history, JAX evaluate, port history, port evaluate, port
    estimator) from the same start, data and seed."""
    train, evaluation = criteo_like(512, 3), criteo_like(200, 4)
    flax_model = FlaxDLRM(vocab_sizes=VOCABS, num_dense=2, embed_dim=8)
    jax_est = JaxEstimator(model=flax_model, mesh=_one_device_mesh(),
                           **_settings())
    jax_history = jax_est.fit(train, evaluation)
    jax_eval = jax_est.evaluate(evaluation)

    feats, _ = train.to_numpy_grouped(
        [(["d0", "d1"], np.float32), (["c0", "c1"], np.int32)], "label")
    params = flax_model.init(jax.random.PRNGKey(0),
                             tuple(jnp.asarray(a[:64]) for a in feats))
    model = DLRM(VOCABS, 2, 8, device="cpu")
    model.load_state_dict(dlrm_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        est = Estimator(model=model, device="cpu", **_settings())
        history = est.fit(train, evaluation)
        port_eval = est.evaluate(evaluation)
    finally:
        torch.set_num_threads(threads)
    return jax_history, jax_eval, history, port_eval, est


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("key", ["train_loss", "eval_loss", "eval_mse",
                                 "eval_accuracy"])
def test_fit_history_matches_jax_estimator(key):
    jax_history, _, history, _, _ = _fits()
    assert [r["epoch"] for r in history] == [0, 1, 2]
    for got, ref in zip(history, jax_history):
        assert _rel(got[key], ref[key]) <= 1e-4, (key, got[key], ref[key])


def test_evaluate_matches_jax_estimator():
    _, jax_eval, _, port_eval, _ = _fits()
    assert port_eval.keys() == jax_eval.keys()
    for key, ref in jax_eval.items():
        assert _rel(port_eval[key], ref) <= 1e-4, (key, port_eval[key], ref)


def test_history_records_have_the_jax_keys():
    jax_history, _, history, _, est = _fits()
    assert est.history is history
    for got, ref in zip(history, jax_history):
        assert got.keys() == ref.keys()
        assert got["epoch_seconds"] > 0


def test_loss_falls_on_the_categorical_signal(one_thread):
    """As test_dlrm_mixed_dtype_fit: the label is the parity of c0, which
    only the embedding of c0 carries; a creator builds the model."""
    ds = criteo_like(768, 3, vocab0=1000)
    est = Estimator(model=functools.partial(DLRM, [1000, 50], 2, 8),
                    device="cpu", **_settings(num_epochs=4, learning_rate=2e-2))
    history = est.fit(ds)
    assert history[-1]["train_loss"] < history[0]["train_loss"] * 0.9
    assert np.isfinite(est.evaluate(ds)["eval_loss"])


def test_predict_and_get_model_take_the_tuple_form():
    *_, est = _fits()
    ds = criteo_like(10, 7)
    x, _ = ds.to_numpy_grouped(
        [(["d0", "d1"], np.float32), (["c0", "c1"], np.int32)])
    pred = est.predict(x)
    assert pred.shape == (10, 1) and pred.dtype == np.float32
    assert np.isfinite(pred).all()
    with torch.no_grad():
        again = est.get_model()(tuple(torch.from_numpy(a) for a in x))
    np.testing.assert_array_equal(again.numpy(), pred)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_dense_fit_matches_jax_estimator(optimizer, one_thread):
    """The single-matrix path (an MLP, no categorical columns), with the
    optimizer resolved by name and learning_rate as optax's."""
    rng = np.random.default_rng(0)
    n = 300
    x, y = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    ds = ArrayDataset({"x": x, "y": y, "z": 3 * x + 4 * y + 5})
    settings = dict(optimizer=optimizer, loss="mse", feature_columns=["x", "y"],
                    label_column="z", batch_size=32, num_epochs=3,
                    learning_rate=1e-2, seed=1)
    flax_model = FlaxMLPRegressor(hidden=(16, 8))
    jax_history = JaxEstimator(model=flax_model, mesh=_one_device_mesh(),
                               **settings).fit(ds)
    params = flax_model.init(jax.random.PRNGKey(1),
                             jnp.asarray(np.stack([x, y], 1)[:32]))
    model = MLPRegressor(2, (16, 8), device="cpu")
    model.load_state_dict(mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    history = Estimator(model=model, device="cpu", **settings).fit(ds)
    for got, ref in zip(history, jax_history):
        assert _rel(got["train_loss"], ref["train_loss"]) <= 1e-4


# ---------------------------------------------------------------------------
# ArrayDataset: the JAX package's staging rules
# ---------------------------------------------------------------------------


def _jax_error(columns, groups):
    with pytest.raises(ValueError) as err:
        _table_to_numpy_grouped(pa.table(columns), groups, None, np.float32)
    return str(err.value)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_ids_refused_as_in_jax(bad):
    columns = {"c0": np.array([1.0, bad, 3.0])}
    groups = [(["c0"], np.int32)]
    with pytest.raises(ValueError) as err:
        ArrayDataset(columns).to_numpy_grouped(groups)
    assert str(err.value) == _jax_error(columns, groups)


def test_ids_outside_the_target_range_refused_as_in_jax():
    columns = {"c0": np.array([1, 2**40], dtype=np.int64)}
    groups = [(["c0"], np.int32)]
    with pytest.raises(ValueError) as err:
        ArrayDataset(columns).to_numpy_grouped(groups)
    assert str(err.value) == _jax_error(columns, groups)
    wide, _ = ArrayDataset(columns).to_numpy_grouped([(["c0"], np.int64)])
    assert wide[0][1, 0] == 2**40


def test_staging_matches_jax():
    ds = criteo_like(50, 1)
    groups = [(["d0", "d1"], np.float32), (["c0", "c1"], np.int32)]
    got, labels = ds.to_numpy_grouped(groups, "label")
    ref, ref_labels = _table_to_numpy_grouped(
        pa.table(ds.columns), groups, "label", np.float32)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(labels, ref_labels)
    matrix, no_labels = ds.to_numpy(COLS)
    assert matrix.shape == (50, 4) and no_labels is None
    assert ds.count() == 50
    with pytest.raises(ValueError, match="differ in length"):
        ArrayDataset({"a": np.zeros(3), "b": np.zeros(4)})


# ---------------------------------------------------------------------------
# what the port does not have yet, and the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option,value", [
    pytest.param("mesh", object(), id="mesh-value4"),
    ("param_sharding_rules", lambda mesh, p: p),
])
def test_later_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="ported in"):
        Estimator(model=functools.partial(DLRM, VOCABS, 2), device="cpu",
                  **{option: value})


def test_later_methods_raise():
    est = Estimator(model=functools.partial(DLRM, VOCABS, 2), device="cpu",
                    **_settings())
    with pytest.raises(NotImplementedError, match="ETL"):
        est.fit_on_etl(None)


def test_argument_checks_as_in_jax():
    with pytest.raises(ValueError, match="not in feature_columns"):
        Estimator(feature_columns=["a"], categorical_columns=["b"], device="cpu")
    with pytest.raises(ValueError, match="integer dtype"):
        Estimator(feature_columns=["a"], categorical_columns=["a"],
                  categorical_dtype=np.float32, device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        Estimator(model=functools.partial(DLRM, VOCABS, 2), optimizer="lamb",
                  device="cpu", **{k: v for k, v in _settings().items()
                                   if k != "optimizer"}).fit(criteo_like(64, 0))
    with pytest.raises(RuntimeError, match="fit"):
        Estimator(device="cpu").predict(np.zeros((1, 2)))


def test_entry_points_without_device_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: DLRM(VOCABS, 2), lambda: MLPRegressor(2),
                  lambda: Estimator(model=None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_port_imports_no_optax_or_arrow():
    """The AST scan of test_torch_isolation.py, for the modules the
    estimator slice must also stay clear of."""
    files = sorted((ROOT / "raydp_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("optax", "pyarrow", "pandas")]
    assert not bad, bad
