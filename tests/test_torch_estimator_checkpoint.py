"""The port's checkpoints, resume and retries
(raydp_tpu_torch/estimator/checkpoint.py and the estimator's fit) against
the JAX package's.

A resumed port fit must end on the uninterrupted port fit's parameters bit
for bit (one thread: the same ops on the same batches). Its history is held
to ``JaxEstimator``'s resumed fit within 1e-4 relative, the tolerance of
``tests/test_torch_dlrm_fit.py`` (the same f32 arithmetic in two orders).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from raydp_tpu.estimator import JaxEstimator
from raydp_tpu.estimator.jax_estimator import (
    latest_checkpoint as jax_latest_checkpoint,
    latest_checkpoint_epoch as jax_latest_checkpoint_epoch,
)
from raydp_tpu.models import DLRM as FlaxDLRM
from raydp_tpu_torch.estimator import (
    Estimator,
    latest_checkpoint,
    latest_checkpoint_epoch,
)
from raydp_tpu_torch.exchange.dataset import ArrayDataset
from raydp_tpu_torch.models.convert import dlrm_params_from_flax
from raydp_tpu_torch.models.dlrm import DLRM, dlrm_optimizer

COLS = ["d0", "d1", "c0", "c1"]
VOCABS = [100, 20]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread (bitwise comparisons), and no wait before a
    retry."""
    from raydp_tpu_torch.estimator import estimator as port_estimator

    monkeypatch.setattr(port_estimator, "RETRY_DELAY_S", 0.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def criteo_like(n=512, seed=3):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, VOCABS[0], n)
    return ArrayDataset({
        "d0": rng.random(n).astype(np.float32),
        "d1": rng.random(n).astype(np.float32),
        "c0": c0.astype(np.int64),
        "c1": rng.integers(0, VOCABS[1], n).astype(np.int64),
        "label": (c0 % 2).astype(np.float32),
    })


def _settings(**kw):
    settings = dict(loss="bce", feature_columns=COLS,
                    categorical_columns=["c0", "c1"], label_column="label",
                    batch_size=64, num_epochs=3, learning_rate=1e-2, seed=0)
    settings.update(kw)
    return settings


def _port(**kw):
    model = kw.pop("model", functools.partial(DLRM, VOCABS, 2, 8))
    return Estimator(model=model, device="cpu", **_settings(**kw))


def _crash_at(est, at, times=1):
    """Make ``est`` raise right after writing checkpoint ``at`` = (epoch,
    step), ``times`` times."""
    save = est._save_checkpoint
    left = {"n": times}

    def crashing(model, opt, epoch, step=None):
        save(model, opt, epoch, step)
        if (epoch, step) == at and left["n"]:
            left["n"] -= 1
            raise RuntimeError(f"planted crash after {at}")

    est._save_checkpoint = crashing


def _spy_resumes(est):
    resumes = []
    fit_once = est._fit_once

    def spying(train_ds, evaluate_ds):
        resumes.append(est.resume_from_epoch)
        return fit_once(train_ds, evaluate_ds)

    est._fit_once = spying
    return resumes


def _params(est):
    return [p.detach().clone() for p in est.get_model().parameters()]


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the directory layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("names", [
    [],
    ["epoch_0_step_3"],
    ["epoch_0", "epoch_0_step_3", "epoch_1_step_6", "epoch_1_step_12"],
    ["epoch_2", "epoch_2_step_40", "epoch_10_step_1", "epoch_9", "stray"],
    ["epoch_1", "epoch_3", ".tmp-epoch_4-77", "epoch_4_step_x"],
])
def test_latest_checkpoint_as_jax(names, tmp_path):
    for name in names:
        (tmp_path / name).mkdir()
    (tmp_path / "epoch_7").write_text("a file, not a checkpoint")
    assert latest_checkpoint(str(tmp_path)) == \
        jax_latest_checkpoint(str(tmp_path))
    assert latest_checkpoint_epoch(str(tmp_path)) == \
        jax_latest_checkpoint_epoch(str(tmp_path))
    assert latest_checkpoint(None) is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------------
# resume, bit for bit
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _uninterrupted():
    est = _port()
    est.fit(criteo_like())
    return _params(est), est.history


@pytest.mark.parametrize("resume", [(0, 3), (1, 6), 0, 1])
def test_resume_ends_bitwise_on_the_uninterrupted_fit(resume, tmp_path):
    ds = criteo_like()
    ref_params, ref_history = _uninterrupted()
    at = resume if isinstance(resume, tuple) else (resume, None)
    crashed = _port(checkpoint_dir=str(tmp_path), save_every_steps=3)
    _crash_at(crashed, at)
    with pytest.raises(RuntimeError, match="planted crash"):
        crashed.fit(ds)
    resumed = _port(checkpoint_dir=str(tmp_path), resume_from_epoch=resume)
    history = resumed.fit(ds)
    _assert_bitwise(_params(resumed), ref_params)
    first = at[0] if at[1] is not None else at[0] + 1
    assert [r["epoch"] for r in history] == list(range(first, 3))
    # whole epochs after the resumed one train as the uninterrupted ones
    for got, ref in zip(history[1:], ref_history[first + 1:]):
        assert got["train_loss"] == ref["train_loss"]


def test_resume_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        _port(resume_from_epoch=0).fit(criteo_like())


def _flax_start():
    flax_model = FlaxDLRM(vocab_sizes=VOCABS, num_dense=2, embed_dim=8)
    sample = tuple(jnp.zeros((64, 2), d) for d in (jnp.float32, jnp.int32))
    params = flax_model.init(jax.random.PRNGKey(0), sample)
    model = DLRM(VOCABS, 2, 8, device="cpu")
    model.load_state_dict(dlrm_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return flax_model, model


def test_resumed_history_matches_jax(tmp_path):
    """Both packages crash after the step-3 checkpoint of epoch 0 and resume
    at (0, 3): the resumed histories (epoch 0's loss over its last five
    steps, then two whole epochs) agree."""
    ds = criteo_like()
    flax_model, model = _flax_start()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    crashed = JaxEstimator(model=flax_model, mesh=mesh, **_settings(
        checkpoint_dir=str(jax_dir), save_every_steps=3))
    save = crashed._save_checkpoint

    def crash(params, epoch, opt_state, step=None):
        save(params, epoch, opt_state, step=step)
        if (epoch, step) == (0, 3):
            raise RuntimeError("planted crash")

    crashed._save_checkpoint = crash
    with pytest.raises(RuntimeError):
        crashed.fit(ds)
    jax_history = JaxEstimator(model=flax_model, mesh=mesh, **_settings(
        checkpoint_dir=str(jax_dir), resume_from_epoch=(0, 3))).fit(ds)

    port_crashed = _port(model=model, checkpoint_dir=str(port_dir),
                         save_every_steps=3)
    _crash_at(port_crashed, (0, 3))
    with pytest.raises(RuntimeError):
        port_crashed.fit(ds)
    _, model = _flax_start()
    history = _port(model=model, checkpoint_dir=str(port_dir),
                    resume_from_epoch=(0, 3)).fit(ds)
    assert [r["epoch"] for r in history] == [r["epoch"] for r in jax_history]
    for got, ref in zip(history, jax_history):
        rel = abs(got["train_loss"] - ref["train_loss"]) / abs(ref["train_loss"])
        assert rel <= 1e-4, (got, ref)


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------


def test_retry_resumes_mid_epoch_at_the_newest_step_checkpoint(tmp_path):
    """The counterpart of
    tests/test_jax_estimator.py::test_retry_resumes_midepoch_from_step_checkpoint."""
    est = _port(checkpoint_dir=str(tmp_path), save_every_steps=3, num_epochs=1)
    _crash_at(est, (0, 6))
    resumes = _spy_resumes(est)
    history = est.fit(criteo_like(), max_retries=2)
    assert resumes == [None, (0, 6)]
    assert [r["epoch"] for r in history] == [0]
    assert est.retried_errors_ == ["RuntimeError: planted crash after (0, 6)"]
    assert est.resume_from_epoch is None  # not leaked into a later fit


def test_retry_ends_bitwise_on_the_uninterrupted_fit(tmp_path):
    ref_params, _ = _uninterrupted()
    est = _port(checkpoint_dir=str(tmp_path), save_every_steps=3)
    _crash_at(est, (1, 6))
    est.fit(criteo_like(), max_retries=1)
    _assert_bitwise(_params(est), ref_params)
    assert sorted(os.listdir(tmp_path)) == ["epoch_0", "epoch_1", "epoch_2"]


def test_retry_ignores_a_checkpoint_of_an_earlier_fit(tmp_path):
    """A newer checkpoint already in the directory is the baseline: the
    retry starts over instead of resuming from it."""
    (tmp_path / "epoch_5").mkdir()
    est = _port(checkpoint_dir=str(tmp_path), save_every_steps=3)
    _crash_at(est, (0, 3))
    resumes = _spy_resumes(est)
    history = est.fit(criteo_like(), max_retries=1)
    assert resumes == [None, None]
    assert [r["epoch"] for r in history] == [0, 1, 2]


def test_retry_never_resumes_past_the_last_epoch(tmp_path):
    est = _port(checkpoint_dir=str(tmp_path))
    _crash_at(est, (2, None))
    resumes = _spy_resumes(est)
    history = est.fit(criteo_like(), max_retries=1)
    assert resumes == [None, 1]
    assert [r["epoch"] for r in history] == [2]


def test_retry_restarts_an_instance_from_its_start(tmp_path):
    """Without a checkpoint to resume from, a retry starts over from the
    state the model and the optimizer instances had when the fit began,
    and ends bitwise on an uninterrupted fit from that state."""
    ds = criteo_like()

    def instances():
        model = DLRM(VOCABS, 2, 8, device="cpu", seed=4)
        return model, torch.optim.Adam(model.parameters(), lr=1e-2)

    model, opt = instances()
    ref = _port(model=model, optimizer=opt)
    ref.fit(ds)
    model, opt = instances()
    est = _port(model=model, optimizer=opt)
    calls = {"n": 0}
    run_epoch = est._run_epoch

    def failing_epoch(*args):
        record = run_epoch(*args)
        if calls["n"] == 0 and args[3] == 1:
            calls["n"] += 1
            raise RuntimeError("planted crash in epoch 1")
        return record

    est._run_epoch = failing_epoch
    est.fit(ds, max_retries=1)
    assert est.retried_errors_ == ["RuntimeError: planted crash in epoch 1"]
    _assert_bitwise(_params(est), _params(ref))


def test_retries_run_out(tmp_path):
    est = _port(checkpoint_dir=str(tmp_path), save_every_steps=3)

    def failing(train_ds, evaluate_ds):
        raise RuntimeError("planted fault")

    est._fit_once = failing
    with pytest.raises(RuntimeError, match="planted fault"):
        est.fit(criteo_like(), max_retries=2)
    assert est.retried_errors_ == ["RuntimeError: planted fault"] * 2


# ---------------------------------------------------------------------------
# retention, loading, the dlrm optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep,left", [(None, ["epoch_0", "epoch_1", "epoch_2"]),
                                       (1, ["epoch_2"]),
                                       (2, ["epoch_1", "epoch_2"])])
def test_gc_and_keep_checkpoints(keep, left, tmp_path):
    est = _port(checkpoint_dir=str(tmp_path), save_every_steps=3,
                keep_checkpoints=keep)
    est.fit(criteo_like())
    assert sorted(os.listdir(tmp_path)) == left
    assert est.checkpoint_stats_["saves"] == 3 + 3 * 2  # 2 step saves an epoch
    assert est.checkpoint_stats_["bytes"] > 0


def test_load_latest_checkpoint_then_predict(tmp_path):
    ds = criteo_like()
    est = _port(checkpoint_dir=str(tmp_path))
    est.fit(ds)
    x, _ = ds.to_numpy_grouped([(["d0", "d1"], np.float32),
                                (["c0", "c1"], np.int32)])
    server = _port(checkpoint_dir=str(tmp_path), seed=9)
    with pytest.raises(RuntimeError, match="no model"):
        server.predict(x)
    assert server.load_latest_checkpoint() == (2, None)
    np.testing.assert_array_equal(server.predict(x), est.predict(x))
    params = server.load_checkpoint(1)
    assert set(params) == set(est.get_model().state_dict())
    with pytest.raises(FileNotFoundError):
        _port(checkpoint_dir=str(tmp_path / "none")).load_latest_checkpoint()


def test_dlrm_optimizer_fit_resumes(tmp_path):
    """MultiTransform's state_dict carries Adafactor's factored moments and
    Adam's through the checkpoint: the resumed fit ends bit for bit on the
    uninterrupted one."""
    ds = criteo_like()
    ref = _port(optimizer=dlrm_optimizer())
    ref.fit(ds)
    crashed = _port(optimizer=dlrm_optimizer(), checkpoint_dir=str(tmp_path),
                    save_every_steps=3)
    _crash_at(crashed, (1, 3))
    with pytest.raises(RuntimeError):
        crashed.fit(ds)
    resumed = _port(optimizer=dlrm_optimizer(), checkpoint_dir=str(tmp_path),
                    resume_from_epoch=(1, 3))
    resumed.fit(ds)
    _assert_bitwise(_params(resumed), _params(ref))
