"""Data and model parallelism of the port (``raydp_tpu_torch/parallel/
{sharding,partitioner}.py``, ``ops/embedding.py``, ``models/dlrm.py``'s
split tables, ``optim.Adafactor`` on blocks, the estimator's ``mesh`` and
``param_sharding_rules``) against the JAX package's.

The JAX side runs as its own tests run it, on the virtual CPU devices
(``make_mesh(axes, jax.devices()[:n])``, ``shard_map`` / GSPMD). The port
side runs gloo ranks on the CPU, spawned with ``torch.multiprocessing`` (a
``FileStore``, every rank under a time limit) from
``tests/torch_sharding_ranks.py``, one spawn a world shared by the module.
Inputs come from numpy seeds; flax weights are carried across with
``models.convert``.

- ``sharded_embedding_lookup`` at model 2 and 4: the rows and the table's
  gradient against ``jnp.take`` and the JAX package's ``shard_map`` lookup,
  within 1e-6 (as ``tests/test_models_parallel.py``).
- ``shard_params_by_rules``: the same decisions as the JAX rules on the
  same parameters, a vocab the axis does not divide replicated.
- ``DataParallelPartitioner``: the rows each coordinate gets equal the JAX
  device shard there, plain and stacked, driver-staged and shard-direct;
  ``_effective_batch`` rounds as the JAX estimator's.
- The DLRM forward with ``dlrm_sharding_rules`` at {"data": 2, "model":
  2} against ``jax.jit(model.apply)`` on sharded params, within 1e-5.
- ``Adafactor`` on blocks over 2 ranks against it whole on one: four steps
  of a table split by rows, a matrix split by columns and a whole vector,
  within 1e-6 (max abs).
- A fit of 8 steps (a tiny DLRM, ``dlrm_optimizer()``) of the port's
  estimator at 4 ranks {"data": 2, "model": 2} against ``JaxEstimator(mesh=
  ..., param_sharding_rules=dlrm_sharding_rules())`` fed the same global
  batches: the epoch losses within 1e-5 relative, the parameters gathered
  whole within 1e-5 (max abs). Its step checkpoint, written at model 2,
  resumed at {"data": 2, "model": 1}: the last epoch's loss and the
  parameters as the uninterrupted fit's, within 1e-5; resumed at the mesh
  that wrote it: bit for bit.
- ``dot_interaction_fused`` under a 2-rank group: the plain version on a
  CPU tensor, the kernel's launch (mocked) or the library's error on a
  tensor the wrapper takes for a card's.
"""

import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_sharding_ranks as ranks
from raydp_tpu.estimator import JaxEstimator
from raydp_tpu.models import DLRM as FlaxDLRM
from raydp_tpu.models import dlrm_optimizer as jax_dlrm_optimizer
from raydp_tpu.models import dlrm_sharding_rules as jax_dlrm_rules
from raydp_tpu.ops import sharded_embedding_lookup as jax_lookup
from raydp_tpu.parallel import make_mesh as jax_make_mesh
from raydp_tpu.parallel.sharding import shard_params_by_rules as jax_rules
from raydp_tpu_torch.estimator import Estimator
from raydp_tpu_torch.exchange.dataset import ArrayDataset
from raydp_tpu_torch.models import DLRM, dlrm_sharding_rules
from raydp_tpu_torch.models.convert import dlrm_params_from_flax, table_shard
from raydp_tpu_torch.parallel import (
    DataParallelPartitioner,
    make_mesh,
    shard_params_by_rules,
)
from raydp_tpu_torch.parallel import mesh as mesh_mod

RANK_LIMIT_S = 150.0
LOOKUP_TOL, FORWARD_TOL, ADAFACTOR_TOL = 1e-6, 1e-5, 1e-6
FIT_LOSS_RTOL, FIT_PARAM_TOL = 1e-5, 1e-5


def _spawn_ranks(tmp_path, world, tasks, arg=None):
    """Run ``tasks`` on ``world`` gloo ranks; every rank's results."""
    ctx = torch.multiprocessing.get_context("spawn")
    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    procs = [ctx.Process(target=ranks.run,
                         args=(r, world, store, out, tasks, arg))
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
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(f"{out}.{r}") for r in range(world)]


def _flax_forward():
    model = FlaxDLRM(**ranks.FORWARD)
    x = jnp.asarray(ranks.forward_inputs())
    return model, model.init(jax.random.PRNGKey(0), x), x


def _flax_fit_model():
    return FlaxDLRM(**ranks.FIT_MODEL)


@functools.lru_cache(maxsize=None)
def _fit_params():
    """The JAX estimator's initial parameters (``module.init`` with its
    seed's key on a batch's shapes)."""
    cols = ranks.fit_columns()
    sample = (np.stack([cols["d0"], cols["d1"]], 1)[:2 * ranks.FIT_BATCH],
              np.stack([cols["c0"], cols["c1"]], 1).astype(np.int32)[
                  :2 * ranks.FIT_BATCH])
    params = _flax_fit_model().init(jax.random.PRNGKey(0),
                                    tuple(jnp.asarray(a) for a in sample))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """The flax weights of the forward and the fit, converted, in a file
    the ranks read."""
    path = tmp_path_factory.mktemp("sharding") / "states.pt"
    _, params, _ = _flax_forward()
    torch.save({"forward": dlrm_params_from_flax(
                    jax.tree_util.tree_map(np.asarray, params)),
                "fit": dlrm_params_from_flax(_fit_params())}, path)
    return str(path)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, states):
    return _spawn_ranks(tmp_path_factory.mktemp("w4"), 4,
                        ["lookup", "forward", "fit", "resume"], states)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, states, world4):
    """After world4: its step checkpoint is resumed here."""
    return _spawn_ranks(tmp_path_factory.mktemp("w2"), 2,
                        ["lookup", "adafactor", "resume", "interaction"],
                        states)


# ---------------------------------------------------------------------------
# the vocab-sharded lookup
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_lookup(world):
    table, ids, g = (jnp.asarray(a) for a in ranks.lookup_inputs())
    mesh = jax_make_mesh({"model": world}, jax.devices()[:world])

    def loss(t, fn):
        return jnp.sum(fn(t) * g)

    take = functools.partial(jnp.take, indices=ids, axis=0)
    sharded = lambda t: jax_lookup(t, ids, mesh, axis="model")  # noqa: E731
    return {"take": (np.asarray(take(table)),
                     np.asarray(jax.grad(loss)(table, take))),
            "shard_map": (np.asarray(sharded(table)),
                          np.asarray(jax.grad(loss)(table, sharded)))}


@pytest.mark.parametrize("world", [2, 4], ids=["model2", "model4"])
def test_sharded_lookup_and_its_gradient_match_jax(world, world2, world4,
                                                   cpu_mesh_devices):
    results = {2: world2, 4: world4}[world]
    outs = [r["lookup"]["out"].numpy() for r in results]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])  # whole on every rank
    grad = np.concatenate([r["lookup"]["grad"].numpy() for r in results])
    for what, (want_out, want_grad) in _jax_lookup(world).items():
        np.testing.assert_allclose(outs[0], want_out, rtol=0, atol=LOOKUP_TOL,
                                   err_msg=f"rows vs {what}")
        np.testing.assert_allclose(grad, want_grad, rtol=0, atol=LOOKUP_TOL,
                                   err_msg=f"table gradient vs {what}")


def test_table_shard_takes_a_coordinates_rows():
    table = np.arange(24).reshape(6, 4)
    np.testing.assert_array_equal(table_shard(table, 3, 1), table[2:4])
    with pytest.raises(ValueError, match="do not split"):
        table_shard(table, 4, 0)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _jax_specs(mesh, params, rules):
    shardings = jax_rules(mesh, params, rules)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in flat}


def _trimmed(spec) -> tuple:
    """A spec without its trailing Nones (the same placement)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_rules_decide_as_the_jax_rules(cpu_mesh_devices):
    """The same tree of names and shapes through both packages' rules on
    {"data": 2, "model": 2}: a rule that matches and divides, a vocab the
    axis does not divide (replicated), a tuple of axes, no rule."""
    shapes = {"embedding_0": (32, 8), "embedding_1": (15, 8),
              "Dense_0/kernel": (8, 4), "Dense_0/bias": (4,),
              "blocks/w": (16, 12)}
    rules = [(r"embedding_\d+", ("model", None)),
             (r"blocks/w", (("data", "model"), None))]
    jax_mesh = jax_make_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    tree = {}
    for name, shape in shapes.items():
        node = tree
        *outer, leaf = name.split("/")
        for key in outer:
            node = node.setdefault(key, {})
        node[leaf] = np.zeros(shape, np.float32)
    want = _jax_specs(jax_mesh, tree, [(p, P(*s)) for p, s in rules])
    mesh = make_mesh({"data": 2, "model": 2}, range(4))
    got = shard_params_by_rules(
        mesh, {n.replace("/", "."): torch.zeros(s) for n, s in shapes.items()},
        rules)
    for name in shapes:
        assert _trimmed(got[name.replace("/", ".")].spec) == \
            _trimmed(want[name]), name
    assert got["embedding_1"].replicated and not got["embedding_0"].replicated
    assert got["blocks.w"].split(0) == 4 and got["blocks.w"].split(1) == 1


def test_dlrm_rules_split_the_tables_the_jax_rules_split(cpu_mesh_devices):
    model, params, _ = _flax_forward()
    jax_mesh = jax_make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    want = {k: v for k, v in _jax_specs(jax_mesh, params,
                                        [(r"embedding_\d+",
                                          P("model", None))]).items()}
    got = dlrm_sharding_rules()(make_mesh({"data": 4, "model": 2}, range(8)),
                                DLRM(**ranks.FORWARD, device="cpu"))
    for i in range(3):
        assert tuple(got[f"embedding_{i}"].spec) == ("model", None)
        assert want[f"params/embedding_{i}"] == ("model", None)
    assert all(p.replicated for n, p in got.items() if "embedding" not in n)
    assert all(s == () for n, s in want.items() if "embedding" not in n)


# ---------------------------------------------------------------------------
# the partitioner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [{"data": 4}, {"data": 2, "model": 2}],
                         ids=["data4", "data2xmodel2"])
def test_partitioner_rows_are_the_jax_device_shards(axes, monkeypatch,
                                                    cpu_mesh_devices):
    """For each rank of the mesh, the rows ``shard_inputs`` (leading dim)
    and ``shard_stacked`` (second dim) give it, driver-staged from the
    global batch and shard-direct from its coordinate's rows, equal the
    shard a ``NamedSharding`` over "data" puts on the device at that
    coordinate."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 3)).astype(np.float32)
    stacked = rng.standard_normal((2, 8, 3)).astype(np.float32)
    jax_mesh = jax_make_mesh(axes, jax.devices()[:4])
    shards = {}
    for arr, spec in ((x, P("data", None)), (stacked, P(None, "data", None))):
        placed = jax.device_put(arr, NamedSharding(jax_mesh, spec))
        shards[arr.ndim] = {s.device: np.asarray(s.data)
                            for s in placed.addressable_shards}
    mesh = make_mesh(axes, range(4))
    data = int(axes["data"])
    for rank in range(4):
        monkeypatch.setattr(mesh_mod, "_world_rank", lambda r=rank: r)
        device = jax_mesh.devices.reshape(-1)[rank]
        d = mesh.axis_index("data")
        staged = DataParallelPartitioner(mesh, shard_direct=False, device="cpu")
        direct = DataParallelPartitioner(mesh, device="cpu")
        rows = slice(d * 8 // data, (d + 1) * 8 // data)
        for got in (staged.shard_inputs(x), direct.shard_inputs(x[rows])):
            np.testing.assert_array_equal(got.numpy(), shards[2][device])
        for got in (staged.shard_stacked(stacked),
                    direct.shard_stacked(stacked[:, rows])):
            np.testing.assert_array_equal(got.numpy(), shards[3][device])
        y, none = staged.shard_inputs((x[:, 0], None))
        assert none is None and y.shape == (8 // data,)


@pytest.mark.parametrize("batch", [1, 63, 64, 65])
@pytest.mark.parametrize("data", [1, 2, 4])
def test_effective_batch_rounds_as_the_jax_estimator(batch, data,
                                                     cpu_mesh_devices):
    jax_mesh = jax_make_mesh({"data": data}, jax.devices()[:data])
    want = JaxEstimator(batch_size=batch)._effective_batch(jax_mesh)
    got = Estimator(batch_size=batch, device="cpu")._effective_batch(
        make_mesh({"data": data}, range(data)))
    assert got == want


def test_one_rank_mesh_is_a_plain_path():
    mesh = make_mesh({"data": 1})
    part = DataParallelPartitioner(mesh, device="cpu")

    def step():
        return torch.ones(())

    assert part.partition_step(step) is step  # no collective at all
    x = np.arange(6, dtype=np.float32)
    np.testing.assert_array_equal(part.shard_inputs(x).numpy(), x)


# ---------------------------------------------------------------------------
# the model, the optimizer and the fit
# ---------------------------------------------------------------------------


def test_dp_tp_dlrm_forward_matches_jax(world4, cpu_mesh_devices):
    model, params, x = _flax_forward()
    jax_mesh = jax_make_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    sharded = jax.device_put(params, jax_rules(
        jax_mesh, params, [(r"embedding_\d+", P("model", None))]))
    with jax_mesh:
        want = np.asarray(jax.jit(model.apply)(sharded, x))
    got = {}
    for r in world4:
        got.setdefault(r["forward"]["data"], r["forward"]["out"].numpy())
        assert r["forward"]["table_rows"] == 32  # 64 rows over model 2
    out = np.concatenate([got[d] for d in sorted(got)])
    np.testing.assert_allclose(out, want, rtol=0, atol=FORWARD_TOL)


def test_adafactor_on_blocks_matches_it_whole(world2):
    from raydp_tpu_torch.optim import Adafactor

    params = [torch.nn.Parameter(torch.from_numpy(v))
              for v in ranks.adafactor_start().values()]
    opt = Adafactor(params, ranks.ADAFACTOR_LR, 0)
    for step, grads in enumerate(ranks.adafactor_grads()):
        for p, g in zip(params, grads.values()):
            p.grad = torch.from_numpy(g)
        opt.step()
        for r in world2:
            for (name, got), want in zip(r["adafactor"][step].items(), params):
                np.testing.assert_allclose(
                    got.numpy(), want.detach().numpy(), rtol=0,
                    atol=ADAFACTOR_TOL, err_msg=f"step {step} {name}")


@functools.lru_cache(maxsize=None)
def _jax_fit():
    """``JaxEstimator`` on {"data": 2, "model": 2} fed the port's global
    batches in order (twice the batch, no shuffle)."""
    cols = ranks.fit_columns()
    order = ranks.global_batch_order()
    ds = ArrayDataset({k: v[order] for k, v in cols.items()})
    mesh = jax_make_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    est = JaxEstimator(model=_flax_fit_model(),
                       optimizer=jax_dlrm_optimizer(), mesh=mesh,
                       param_sharding_rules=jax_dlrm_rules(),
                       **ranks.fit_settings(
                           batch_size=2 * ranks.FIT_BATCH))
    history = est.fit(ds)
    params = jax.tree_util.tree_map(np.asarray, est._params)
    return [r["train_loss"] for r in history], dlrm_params_from_flax(params)


def test_dp_tp_fit_matches_the_jax_estimator(world4, cpu_mesh_devices):
    losses, params = _jax_fit()
    for r in world4:
        fit = r["fit"]
        np.testing.assert_allclose(fit["losses"], losses, rtol=FIT_LOSS_RTOL)
        assert fit["local_rows"] == 16  # 32 rows over model 2
        assert fit["puts"]["partitioner.shard_direct_puts"] > 0
        for name, want in params.items():
            np.testing.assert_allclose(fit["params"][name].numpy(),
                                       want.numpy(), rtol=0,
                                       atol=FIT_PARAM_TOL, err_msg=name)


def test_step_checkpoint_at_model_2_resumes_at_model_1(world2, world4):
    whole = world4[0]["fit"]
    for r in world2:
        resumed = r["resume"]
        assert resumed["epochs"] == [0, 1]
        np.testing.assert_allclose(resumed["losses"][-1], whole["losses"][-1],
                                   rtol=FIT_LOSS_RTOL)
        for name, want in whole["params"].items():
            np.testing.assert_allclose(resumed["params"][name].numpy(),
                                       want.numpy(), rtol=0,
                                       atol=FIT_PARAM_TOL, err_msg=name)


def test_step_checkpoint_at_model_2_resumes_there_bit_for_bit(world4):
    """The whole tensors of the step checkpoint cut to blocks again (the
    tables, their Adam and Adafactor state): the resumed fit ends where
    the uninterrupted one did, bit for bit."""
    for r in world4:
        whole, resumed = r["fit"], r["resume"]
        assert resumed["epochs"] == [0, 1]
        assert resumed["losses"][-1] == whole["losses"][-1]
        for name, want in whole["params"].items():
            assert torch.equal(resumed["params"][name], want), name


def test_interaction_under_a_group_is_the_kernel_per_rank(world2):
    for r in world2:
        got = r["interaction"]
        assert got["world"] == 2
        assert got["plain_equal"] and got["plain_launches"] == 0
        assert got["kernel_launches"] == 1 and got["library_calls"] == 1
        assert got["raised"] == "nvcc not found"
