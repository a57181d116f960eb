"""The port's streamed fit (raydp_tpu_torch/estimator/stream.py and
exchange/) against ``JaxEstimator(streaming=...)``, on the same blocks.

The JAX side reads a ``raydp_tpu.exchange.dataset.Dataset`` whose blocks
are Arrow tables held in memory (``_MemoryDataset``: only the store read
is replaced, so no cluster is needed; its ``StreamingBatchIterator`` is the
JAX package's own). The port reads an ``ArrayDataset`` built from the same
columns in the same blocks. Both estimators run one device; the port's
model starts from the flax model's initial parameters.

Tolerances, with their reasons: batch order, ``quantize_rows`` and the
widen are exact (integer rows; numpy on both sides; one f32 multiply).
Streamed, hybrid and wire-quant histories within 1e-4 relative, as in
``tests/test_torch_dlrm_fit.py`` (the same f32 arithmetic in two orders).
Port-internal comparisons (segments against the per-step path, a fallen
back hybrid against plain streaming) are bitwise, on one thread.
"""

import functools

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from raydp_tpu.estimator import JaxEstimator
from raydp_tpu.exchange import jax_io
from raydp_tpu.exchange.dataset import Dataset, streaming_shard_plan
from raydp_tpu.models import DLRM as FlaxDLRM
from raydp_tpu_torch.estimator import Estimator
from raydp_tpu_torch.exchange import torch_io
from raydp_tpu_torch.exchange.dataset import ArrayDataset
from raydp_tpu_torch.exchange.dataset import streaming_shard_plan as port_plan
from raydp_tpu_torch.models.convert import dlrm_params_from_flax
from raydp_tpu_torch.models.dlrm import DLRM

COLS = ["d0", "d1", "c0", "c1"]
VOCABS = [100, 20]
GROUPS = [(["d0", "d1"], np.float32), (["c0", "c1"], np.int32)]
COUNTS = [150, 97, 0, 203]  # one empty block, rows that straddle batches


class _MemoryDataset(Dataset):
    """The JAX package's ``Dataset`` over Arrow tables held in memory."""

    def __init__(self, tables):
        super().__init__(list(range(len(tables))), tables[0].schema,
                         [t.num_rows for t in tables])
        self._tables = tables

    def get_block(self, index):
        return self._tables[index]


def column_blocks(counts=COUNTS, seed=3):
    rng = np.random.default_rng(seed)
    blocks = []
    for n in counts:
        c0 = rng.integers(0, VOCABS[0], n)
        blocks.append({
            "d0": rng.random(n).astype(np.float32),
            "d1": (rng.random(n) * 4 - 2).astype(np.float32),
            "c0": c0.astype(np.int64),
            "c1": rng.integers(0, VOCABS[1], n).astype(np.int64),
            "label": (c0 % 2).astype(np.float32),
        })
    return blocks


def both(counts=COUNTS, seed=3):
    blocks = column_blocks(counts, seed)
    return (_MemoryDataset([pa.table(b) for b in blocks]),
            ArrayDataset.from_blocks(blocks))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _settings(**kw):
    settings = dict(loss="bce", metrics=["accuracy"], feature_columns=COLS,
                    categorical_columns=["c0", "c1"], label_column="label",
                    batch_size=32, num_epochs=3, learning_rate=1e-2, seed=0,
                    stream_scan_steps=4)
    settings.update(kw)
    return settings


def _rel(a, b):
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# batch order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("rows,drop_last", [(32, True), (128, False)])
def test_batch_order_matches_jax(shuffle, rows, drop_last):
    jax_ds, port_ds = both()
    kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last,
              feature_groups=GROUPS)
    ref = list(jax_ds.iter_batches(rows, COLS, "label", streaming=True,
                                   executor_decode=False, **kw))
    got = list(port_ds.iter_batches(rows, COLS, "label", **kw))
    assert len(got) == len(ref) > 3
    for (gx, gy), (rx, ry) in zip(got, ref):
        for g, r in zip(gx, rx):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(gy, ry)


@pytest.mark.parametrize("shards,rank", [(1, 0), (3, 0), (3, 2), (7, 5)])
def test_shard_plan_matches_jax(shards, rank):
    plan = port_plan(COUNTS, shards, rank)
    assert plan == streaming_shard_plan(COUNTS, shards, rank)
    jax_ds, port_ds = both()
    ref = list(jax_ds.iter_batches(16, COLS, "label", shuffle=True, seed=1,
                                   streaming=True, block_plan=plan,
                                   feature_groups=GROUPS,
                                   executor_decode=False))
    got = list(port_ds.iter_batches(16, COLS, "label", shuffle=True, seed=1,
                                    block_plan=plan, feature_groups=GROUPS))
    assert len(got) == len(ref)
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(gx[1], rx[1])
        np.testing.assert_array_equal(gy, ry)


def test_blocks_and_counts():
    _, port_ds = both()
    assert port_ds.num_blocks == 4 and port_ds.counts == COUNTS
    assert port_ds.count() == sum(COUNTS)
    block = port_ds.get_block(1)
    assert block.count() == 97
    np.testing.assert_array_equal(block.columns["d0"],
                                  column_blocks()[1]["d0"])
    with pytest.raises(ValueError, match="differ in columns"):
        ArrayDataset.from_blocks([{"a": [1]}, {"b": [1]}])


# ---------------------------------------------------------------------------
# streamed fits against JaxEstimator
# ---------------------------------------------------------------------------


def _port_model(jax_ds):
    """The port's DLRM from the flax model's initial parameters (the JAX
    estimator initialises with PRNGKey(seed) on a sample of the first
    block)."""
    flax_model = FlaxDLRM(vocab_sizes=VOCABS, num_dense=2, embed_dim=8)
    sample = tuple(jnp.zeros((32, 2), d) for d in (jnp.float32, jnp.int32))
    params = flax_model.init(jax.random.PRNGKey(0), sample)
    model = DLRM(VOCABS, 2, 8, device="cpu")
    model.load_state_dict(dlrm_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return flax_model, model


@functools.lru_cache(maxsize=None)
def _streamed_fits(mode):
    streaming, wire = {"stream": (True, False), "hybrid": ("hybrid", False),
                       "int8": (True, "int8")}[mode]
    jax_ds, port_ds = both()
    flax_model, model = _port_model(jax_ds)
    settings = _settings(streaming=streaming, stream_wire_quant=wire)
    jax_est = JaxEstimator(model=flax_model,
                           mesh=Mesh(np.array(jax.devices()[:1]), ("data",)),
                           **settings)
    jax_history = jax_est.fit(jax_ds, jax_ds)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        est = Estimator(model=model, device="cpu", **settings)
        history = est.fit(port_ds, port_ds)
    finally:
        torch.set_num_threads(threads)
    return jax_history, jax_est.stream_stats_, history, est.stream_stats_


@pytest.mark.parametrize("mode", ["stream", "hybrid", "int8"])
@pytest.mark.parametrize("key", ["train_loss", "eval_loss"])
def test_streamed_history_matches_jax(mode, key):
    jax_history, _, history, _ = _streamed_fits(mode)
    assert [r["epoch"] for r in history] == [0, 1, 2]
    for got, ref in zip(history, jax_history):
        assert _rel(got[key], ref[key]) <= 1e-4, (mode, key, got[key], ref[key])


@pytest.mark.parametrize("mode", ["stream", "hybrid", "int8"])
def test_stream_stats_match_jax(mode):
    _, jax_stats, _, stats = _streamed_fits(mode)
    for key in ("bytes_uploaded", "segments", "cached_epochs",
                "wire_bytes_saved", "wire_dtype"):
        assert stats[key] == jax_stats[key], key
    if mode == "hybrid":
        assert list(stats["bytes_by_epoch"]) == [0]
        assert stats["cached_epochs"] == 2


def test_segments_match_per_step(one_thread, tmp_path):
    """Segments of 7 steps train as the per-step feed does, bit for bit,
    and so does a fit resumed from a step checkpoint on a segment boundary
    that the save cadence set (the counterpart of
    tests/test_jax_estimator.py::test_stream_segments_match_per_step)."""
    _, ds = both([400, 333, 211])
    common = _settings(streaming=True, num_epochs=2, batch_size=16)

    def fit(**kw):
        est = Estimator(model=functools.partial(DLRM, VOCABS, 2, 8),
                        device="cpu", **(common | kw))
        history = est.fit(ds)
        return est, history

    ref, ref_history = fit(stream_scan_steps=0)
    seg, seg_history = fit(stream_scan_steps=7)
    assert [r["train_loss"] for r in seg_history] == \
        [r["train_loss"] for r in ref_history]
    for a, b in zip(ref.get_model().parameters(), seg.get_model().parameters()):
        assert torch.equal(a, b)

    crashed = Estimator(model=functools.partial(DLRM, VOCABS, 2, 8),
                        device="cpu", **(common | dict(
                            stream_scan_steps=16, save_every_steps=10,
                            checkpoint_dir=str(tmp_path))))
    save = crashed._save_checkpoint

    def crash_at_20(model, opt, epoch, step=None):
        save(model, opt, epoch, step)
        if epoch == 1 and step == 20:
            raise RuntimeError("boom")

    crashed._save_checkpoint = crash_at_20
    with pytest.raises(RuntimeError, match="boom"):
        crashed.fit(ds)
    assert crashed.stream_stats_["segment_steps"] == 10
    assert (tmp_path / "epoch_1_step_20").is_dir()
    resumed, _ = fit(stream_scan_steps=16, checkpoint_dir=str(tmp_path),
                     resume_from_epoch=(1, 20))
    for a, b in zip(ref.get_model().parameters(),
                    resumed.get_model().parameters()):
        assert torch.equal(a, b)


def test_hybrid_overflow_falls_back(one_thread):
    """A cache budget below one epoch's segments: the fit streams every
    epoch and trains as plain streaming does, bit for bit."""
    _, ds = both()
    runs = {}
    for streaming, limit in ((True, None), ("hybrid", 1000)):
        est = Estimator(model=functools.partial(DLRM, VOCABS, 2, 8),
                        device="cpu", stream_cache_memory_limit=limit,
                        **_settings(streaming=streaming))
        runs[streaming] = (est.fit(ds), est.stream_stats_)
    (plain, plain_stats), (hybrid, stats) = runs[True], runs["hybrid"]
    assert stats["cached_epochs"] == 0
    assert stats["bytes_by_epoch"] == plain_stats["bytes_by_epoch"]
    assert len(stats["bytes_by_epoch"]) == 3
    assert [r["train_loss"] for r in hybrid] == [r["train_loss"] for r in plain]


def test_hybrid_resumed_mid_epoch_streams_every_epoch(one_thread, tmp_path):
    """A fit resumed mid-epoch caches nothing (its first epoch is partial,
    and the JAX runner drops the cache for the fit), so every epoch
    streams."""
    _, ds = both()
    settings = _settings(streaming="hybrid", checkpoint_dir=str(tmp_path),
                         save_every_steps=4, num_epochs=3)
    est = Estimator(model=functools.partial(DLRM, VOCABS, 2, 8), device="cpu",
                    **settings)
    save = est._save_checkpoint

    def crash(model, opt, epoch, step=None):
        save(model, opt, epoch, step)
        if (epoch, step) == (0, 8):
            raise RuntimeError("boom")

    est._save_checkpoint = crash
    with pytest.raises(RuntimeError):
        est.fit(ds)
    resumed = Estimator(model=functools.partial(DLRM, VOCABS, 2, 8),
                        device="cpu", resume_from_epoch=(0, 8), **settings)
    history = resumed.fit(ds)
    stats = resumed.stream_stats_
    assert [r["epoch"] for r in history] == [0, 1, 2]
    assert sorted(stats["bytes_by_epoch"]) == [0, 1, 2]
    assert stats["cached_epochs"] == 0


# ---------------------------------------------------------------------------
# the int8 wire
# ---------------------------------------------------------------------------


def _wire_input(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((5, 32, 8)) * rng.random((5, 32, 1)) * 50)
    x = x.astype(np.float32)
    x[0, 3] = 0.0  # an all-zero row gets scale 1
    x[1, 4] = [127.0, -127.0, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5]
    return x


def test_quantize_rows_bitwise_as_jax():
    x = _wire_input()
    q, s = torch_io.quantize_rows(x)
    ref_q, ref_s = jax_io.quantize_rows(x)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == (5, 32, 1)
    np.testing.assert_array_equal(q, ref_q)
    np.testing.assert_array_equal(s, ref_s)
    assert s[0, 3, 0] == 1.0


def test_widen_bitwise_as_dequantize_rows():
    q, s = torch_io.quantize_rows(_wire_input(1))
    ref = jax_io.dequantize_rows(q, s)
    np.testing.assert_array_equal(torch_io.dequantize_rows(q, s), ref)
    for i in range(q.shape[0]):  # per step, as the streamed fit widens
        got = torch_io.widen_wire(torch.from_numpy(q[i]), torch.from_numpy(s[i]))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref[i])


class _IdProbe(torch.nn.Module):
    """Records the ids it is fed and predicts 0 from the dense part."""

    def __init__(self, device=None, seed=0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))
        self.ids = []

    def forward(self, x):
        dense, ids = x
        self.ids.append(ids.clone())
        return dense @ self.w


def test_wire_keeps_large_vocab_ids_exact():
    """Ids past 2^24 (a float32 would merge them) reach the model exactly
    over the int8 wire; only the float leaf is quantized."""
    n = 256
    rng = np.random.default_rng(0)
    ids = np.stack([2**30 + rng.integers(0, 2**20, n),
                    rng.integers(0, 10, n)], 1).astype(np.int64)
    ds = ArrayDataset.from_blocks([{
        "d0": rng.random(n // 2).astype(np.float32),
        "d1": rng.random(n // 2).astype(np.float32),
        "c0": ids[i:i + n // 2, 0], "c1": ids[i:i + n // 2, 1],
        "label": np.zeros(n // 2, np.float32)} for i in (0, n // 2)])
    probe = _IdProbe()
    est = Estimator(model=probe, device="cpu", categorical_dtype=np.int64,
                    **_settings(streaming=True, stream_wire_quant="int8",
                                shuffle=False, num_epochs=1, loss="mse",
                                metrics=None))
    est.fit(ds)
    seen = torch.cat(probe.ids[:n // 32]).numpy()
    np.testing.assert_array_equal(seen, ids)
    assert est.stream_stats_["wire_dtype"] == "int8"
    # 2 dense f32 (8 bytes) went up as 2 int8 + one f32 scale (6 bytes)
    assert est.stream_stats_["wire_bytes_saved"] == 2 * n


def test_unknown_wire_and_streaming_refused():
    with pytest.raises(ValueError, match="only 'int8'"):
        Estimator(stream_wire_quant="fp8", device="cpu")
    with pytest.raises(ValueError, match="streaming="):
        Estimator(streaming="lazy", device="cpu")
