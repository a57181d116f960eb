"""The port's DLRM, MLPs and optimizers (raydp_tpu_torch/models/{dlrm,mlp}.py,
raydp_tpu_torch/optim.py) against the JAX package's flax models and optax.

One set of flax weights, made from a seed, is carried across with
``dlrm_params_from_flax`` / ``mlp_params_from_flax``; the same numpy inputs
go through both. On the CPU the JAX package's Pallas interaction runs in
interpret mode and the port's kernel wrapper runs its plain version.

Tolerances, with their reasons:

- f32 forwards atol 1e-5 * max|ref|: the same products summed in f32 in
  different orders.
- bf16 forwards atol 3e-2 * max|ref|: both round activations to bf16 after
  each layer, at places that differ (flax's dot in bf16, torch's with an
  f32 accumulator), a few bf16 steps (2^-8) after four layers.
- Optimizers: three steps from the same parameters with the same seeded
  gradients (half of each table's rows zero, as for ids a batch does not
  hold), parameters within 1e-5 relative per tensor: the same f32
  arithmetic in two orders.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raydp_tpu.exchange import features as jax_features
from raydp_tpu.models import DLRM as FlaxDLRM
from raydp_tpu.models.dlrm import dlrm_optimizer as jax_dlrm_optimizer
from raydp_tpu.models.mlp import MLPClassifier as FlaxMLPClassifier
from raydp_tpu.models.mlp import MLPRegressor as FlaxMLPRegressor
from raydp_tpu.obs import costmodel as jax_costmodel
from raydp_tpu_torch import optim
from raydp_tpu_torch.exchange import features
from raydp_tpu_torch.models.convert import dlrm_params_from_flax, mlp_params_from_flax
from raydp_tpu_torch.models.dlrm import DLRM, dlrm_optimizer
from raydp_tpu_torch.models.mlp import MLPClassifier, MLPRegressor
from raydp_tpu_torch.obs import costmodel

VOCABS = [50, 20, 7]
NUM_DENSE, EMBED, BATCH = 3, 8, 37
BOTTOM, TOP = (16, 8), (16, 8)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0):
    """Dense features and ids, some ids out of range on both sides."""
    rng = np.random.default_rng(seed)
    dense = rng.random((BATCH, NUM_DENSE)).astype(np.float32)
    ids = np.stack([rng.integers(-3, v + 3, BATCH) for v in VOCABS],
                   axis=1).astype(np.int32)
    return dense, ids


@functools.lru_cache(maxsize=None)
def _flax_params():
    model = FlaxDLRM(vocab_sizes=VOCABS, num_dense=NUM_DENSE, embed_dim=EMBED,
                     bottom_mlp=BOTTOM, top_mlp=TOP)
    dense, ids = _inputs()
    return _tree_np(model.init(jax.random.PRNGKey(0),
                               (jnp.asarray(dense), jnp.asarray(ids))))


def _port_dlrm(dtype=torch.float32, use_pallas=None):
    model = DLRM(VOCABS, NUM_DENSE, EMBED, BOTTOM, TOP, use_pallas, dtype,
                 device="cpu", seed=3)
    model.load_state_dict(dlrm_params_from_flax(_flax_params()))
    return model


def _close(got: torch.Tensor, ref, rel_atol: float):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel_atol * float(np.abs(ref).max()))


def test_converted_tree_names_every_parameter():
    model = _port_dlrm()
    state = dlrm_params_from_flax(_flax_params())
    assert set(state) == set(model.state_dict())
    assert state["dense.2.weight"].shape == (TOP[0], EMBED + 4 * 3 // 2)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("port_path", [None, False])
@pytest.mark.parametrize("jax_pallas", [True, False])
@pytest.mark.parametrize("form", ["tuple", "matrix"])
def test_dlrm_forward_matches_flax(form, jax_pallas, port_path, dtype_name):
    """Both input forms; the JAX side through its Pallas kernel or its
    einsum, the port through its kernel wrapper (None) or its einsum
    (False); ids out of range are clipped on both."""
    tdtype, jdtype, tol = DTYPES[dtype_name]
    dense, ids = _inputs()
    x = (dense, ids) if form == "tuple" else np.concatenate(
        [dense, ids.astype(np.float32)], axis=1)
    flax_model = FlaxDLRM(vocab_sizes=VOCABS, num_dense=NUM_DENSE,
                          embed_dim=EMBED, bottom_mlp=BOTTOM, top_mlp=TOP,
                          use_pallas_interaction=jax_pallas, dtype=jdtype)
    ref = flax_model.apply(_flax_params(), x)
    with torch.no_grad():
        got = _port_dlrm(tdtype, port_path)(x)
    assert got.dtype == tdtype
    _close(got, ref, tol)


def test_ids_out_of_range_are_clipped():
    dense, ids = _inputs()
    clipped = np.stack([np.clip(ids[:, i], 0, v - 1)
                        for i, v in enumerate(VOCABS)], axis=1)
    assert (clipped != ids).any()
    model = _port_dlrm()
    with torch.no_grad():
        torch.testing.assert_close(model((dense, ids)), model((dense, clipped)),
                                   rtol=0, atol=0)


def _flax_guard_message(x):
    bad = FlaxDLRM(vocab_sizes=[2**24 + 2], num_dense=2, embed_dim=4)
    with pytest.raises(ValueError) as err:
        jax.eval_shape(lambda a: bad.init(jax.random.PRNGKey(0), a), x)
    return str(err.value)


@pytest.mark.parametrize("form", ["tuple", "matrix"])
def test_float_id_guard_raises_the_same_error(form):
    """Float ids past float32's exact-integer range collapse rows: both
    packages refuse them with the same text."""
    dense = np.zeros((4, 2), np.float32)
    ids = np.zeros((4, 1), np.float32)
    x = (dense, ids) if form == "tuple" else np.zeros((4, 3), np.float32)
    message = _flax_guard_message(x)
    port = DLRM([2**24 + 2], 2, 4, device="cpu")
    with pytest.raises(ValueError) as err:
        port(x)
    assert str(err.value) == message
    port_ok = DLRM([2**24 + 1], 2, 4, device="cpu")  # max id 2^24: exact
    assert port_ok((dense, ids)).shape == (4, 1)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_mlp_matches_flax(kind, dtype_name):
    tdtype, jdtype, tol = DTYPES[dtype_name]
    x = np.random.default_rng(4).standard_normal((29, 5)).astype(np.float32)
    if kind == "regressor":
        flax_model = FlaxMLPRegressor(hidden=(16, 8, 4), dtype=jdtype)
        port = MLPRegressor(5, (16, 8, 4), tdtype, device="cpu")
    else:
        flax_model = FlaxMLPClassifier(hidden=(16, 8), num_classes=3,
                                       dtype=jdtype)
        port = MLPClassifier(5, (16, 8), 3, tdtype, device="cpu")
    params = _tree_np(flax_model.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    port.load_state_dict(mlp_params_from_flax(params))
    with torch.no_grad():
        got = port(x)
    assert got.dtype == tdtype
    _close(got, flax_model.apply(params, x), tol)


# ---------------------------------------------------------------------------
# optimizers on the DLRM tree
# ---------------------------------------------------------------------------

STEPS = 3


def _grad_trees():
    """STEPS seeded gradient trees of the flax DLRM's shapes; half of each
    table's rows are zero."""
    rng = np.random.default_rng(9)
    trees = []
    for _ in range(STEPS):
        def leaf(path, a):
            g = rng.standard_normal(a.shape).astype(np.float32)
            if "embedding_" in jax.tree_util.keystr(path):
                g[rng.random(a.shape[0]) < 0.5] = 0.0
            return g

        trees.append(jax.tree_util.tree_map_with_path(leaf, _flax_params()))
    return trees


def _optax_run(tx):
    params = _flax_params()
    state = tx.init(params)
    for g in _grad_trees():
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return dlrm_params_from_flax(_tree_np(params))


def _port_run(factory):
    model = _port_dlrm()
    opt = factory(list(model.named_parameters()))
    params = dict(model.named_parameters())
    for g in _grad_trees():
        for name, grad in dlrm_params_from_flax(g).items():
            params[name].grad = grad
        opt.step()
    return {n: p.detach() for n, p in params.items()}


OPTIMIZER_CASES = {
    "dlrm_optimizer": (dlrm_optimizer(), jax_dlrm_optimizer()),
    "adafactor": (optim.adafactor(1e-2), optax.adafactor(1e-2)),
    "adafactor_factored": (optim.adafactor(1e-2, min_dim_size_to_factor=0),
                           optax.adafactor(1e-2, min_dim_size_to_factor=0)),
    "adam": (optim.adam(1e-3), optax.adam(1e-3)),
    "adamw": (optim.adamw(1e-3), optax.adamw(1e-3)),
    "sgd": (optim.sgd(1e-2), optax.sgd(1e-2)),
}


@pytest.mark.parametrize("case", list(OPTIMIZER_CASES))
def test_optimizer_steps_match_optax(case):
    factory, tx = OPTIMIZER_CASES[case]
    got, ref = _port_run(factory), _optax_run(tx)
    init = dlrm_params_from_flax(_flax_params())
    assert got.keys() == ref.keys()
    for name, p in got.items():
        rel = float((p - ref[name]).norm() / ref[name].norm())
        assert rel <= 1e-5, (name, rel)
        assert not torch.equal(p, init[name]), name


def test_dlrm_optimizer_routes_tables_to_adafactor():
    opt = dlrm_optimizer()(list(_port_dlrm().named_parameters()))
    embed, dense = opt.optimizers["embed"], opt.optimizers["dense"]
    assert isinstance(embed, optim.Adafactor)
    assert isinstance(dense, torch.optim.Adam)
    assert len(embed.param_groups[0]["params"]) == len(VOCABS)
    # min_dim_size_to_factor=0 factors a [vocab, D] table: O(vocab + D) state
    table = _port_dlrm().embedding_0
    table.grad = torch.ones_like(table)
    factored = optim.Adafactor([table], 1e-2, min_dim_size_to_factor=0)
    factored.step()
    state = factored.state[table]
    assert state["v_row"].shape == (EMBED,) and state["v_col"].shape == (VOCABS[0],)


def test_multi_transform_refuses_unknown_labels():
    with pytest.raises(ValueError, match="no transform"):
        optim.multi_transform({"dense": optim.adam(1e-3)}, lambda name: name)(
            list(_port_dlrm().named_parameters()))


# ---------------------------------------------------------------------------
# the port's own copies of small helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(8, 128, 64, 16), (37, 128, 64, 1), (3, 1)])
def test_mlp_costmodel_matches_jax_package(dims):
    for batch in (1, 2048):
        assert costmodel.mlp_train_flops_per_step(batch, dims) == \
            jax_costmodel.mlp_train_flops_per_step(batch, dims)


def test_feature_helpers_match_jax_package():
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.arange(8, dtype=np.int32).reshape(4, 2)
    for x in (a, (a, ids)):
        assert features.f_nbytes(x) == jax_features.f_nbytes(x)
        assert features.f0(x) is jax_features.f0(x)
        got, ref = (mod.fmap(lambda v: v[1:], x)
                    for mod in (features, jax_features))
        for g, r in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (got, ref))):
            np.testing.assert_array_equal(g, r)
        stacked = features.f_stack([x, x])
        ref_stacked = jax_features.f_stack([x, x])
        for g, r in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (stacked, ref_stacked))):
            np.testing.assert_array_equal(g, r)
