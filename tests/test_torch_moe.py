"""Expert parallelism of the port (``raydp_tpu_torch/parallel/moe.py``)
against the JAX package's (``raydp_tpu/parallel/moe.py``).

The port side runs W gloo ranks on the CPU, spawned from
``tests/torch_parallel_ranks.py``: every rank makes the same seeded numpy
inputs (``moe_inputs``), holds its own expert and its shard of the tokens,
and saves its output shard, the aux scalars and its gradients (the
expert's and the router's, for sum(out²), plus 0.01 · load_balance_loss
where the case says). The JAX side runs ``moe_sharded`` on the virtual CPU
devices on the same numpy inputs.

- Every case of ``tests/test_models_parallel.py``'s MoE tests on the port
  at W 4: top-1 against the dense computation of its routing, top-2 with
  aux against the dense two-expert mixture (no drop at capacity factor 8,
  load_balance_loss >= 1), the drop fraction visible under a collapsed
  router, and 120 Adam steps of the aux loss rebalancing the router (its
  aux-loss bounds; the router within 1e-3 of JAX's over the first 40
  steps; the drops falling, see the test for why not to JAX's endpoint).
- Against the JAX package's ``moe_sharded`` at W 2 and 4 on the same
  inputs: out within 1e-5, load_balance_loss within 1e-5, drop_fraction
  equal, the gradients of each expert and of the router within 1e-4
  (absolute), top-2 at capacity factor 1.25 where pairs drop, with the aux
  term in the loss.
- Ties: a router with columns of zeros gives exactly equal gates; the
  second choice goes to the lowest index, as ``lax.top_k`` picks it.
- Overflow: the collapsed router's drop fraction equals JAX's exactly.
- bf16 tokens with more than 256 pairs to one expert (slots past 256,
  where a bf16 cumsum would collide them): the drop fraction equals JAX's
  exactly and the output agrees to bf16 rounding.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_parallel_ranks as ranks
from raydp_tpu.parallel import make_mesh as jax_make_mesh
from raydp_tpu.parallel import moe_sharded as jax_moe_sharded

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
CASES = ("top1", "top2", "drop", "tie", "vs_jax")
AUX_WEIGHT = {"vs_jax": 0.01}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return ranks.spawn(tmp_path_factory.mktemp("ep2"), 2,
                       ["moe_cases", "moe_bf16"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return ranks.spawn(tmp_path_factory.mktemp("ep4"), 4,
                       ["moe_cases", "moe_rebalance"])


def _jax_expert(kind):
    if kind == "relu":
        return lambda w, t: jax.nn.relu(t @ w)
    return lambda w, t: t @ w


@functools.lru_cache(maxsize=None)
def _jax_case(case, world):
    """(out, aux, d experts, d router) of the JAX package's moe_sharded on
    the case's inputs, for the loss the port's ranks take."""
    ws, wr, x, kw, kind, dtype = ranks.moe_inputs(case, world)
    mesh = jax_make_mesh({"ep": world}, jax.devices()[:world])
    dt = jnp.dtype(dtype)
    ws, wr, x = jnp.asarray(ws, dt), jnp.asarray(wr), jnp.asarray(x, dt)
    weight = AUX_WEIGHT.get(case, 0.0)

    def loss(ws, wr):
        got = jax_moe_sharded(_jax_expert(kind), ws, wr, x, mesh, **kw)
        out, aux = got if kw.get("return_aux") else (got, {})
        value = jnp.sum(out.astype(jnp.float32) ** 2)
        if weight:
            value = value + weight * aux["load_balance_loss"]
        return value, (out, aux)

    (_, (out, aux)), (dws, dwr) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(ws, wr)
    return (np.asarray(out.astype(jnp.float32)),
            {k: np.asarray(v) for k, v in aux.items()},
            np.asarray(dws.astype(jnp.float32)), np.asarray(dwr))


def _gathered(results, task, case=None):
    runs = [r[task] if case is None else r[task][case] for r in results]
    return torch.cat([run["out"].float() for run in runs]).numpy(), runs


@functools.lru_cache(maxsize=None)
def _dense(case, world):
    """The JAX tests' dense references: every expert on every token, the
    top-k gates (renormalized for top-2) picking the rows; with their
    gradients of sum(out²) in the experts."""
    ws, wr, x, kw, kind, _ = ranks.moe_inputs(case, world)
    ws, wr, x = jnp.asarray(ws), jnp.asarray(wr), jnp.asarray(x)
    expert = _jax_expert(kind)
    k = kw.get("top_k", 1)
    gates = jax.nn.softmax(x @ wr, -1)
    top_vals, top_idx = jax.lax.top_k(gates, k)
    w = top_vals / jnp.sum(top_vals, -1, keepdims=True) if k > 1 else top_vals
    rows = jnp.arange(x.shape[0])

    def out_of(ws):
        d = jnp.stack([expert(ws[e], x) for e in range(world)], 1)
        return sum(d[rows, top_idx[:, c]] * w[:, c:c + 1] for c in range(k))

    grad = jax.jit(jax.grad(lambda ws: jnp.sum(out_of(ws) ** 2)))(ws)
    return np.asarray(jax.jit(out_of)(ws)), np.asarray(grad)


@pytest.mark.parametrize("case", ["top1", "top2"])
def test_experts_match_the_dense_routing(world4, case):
    """test_moe_expert_parallel_matches_dense and test_moe_top2_matches_dense
    on the port at W 4."""
    out, runs = _gathered(world4, "moe_cases", case)
    ref, ref_grad = _dense(case, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=FWD_TOL)
    for rank, run in enumerate(runs):
        np.testing.assert_allclose(run["dw"].numpy(), ref_grad[rank], rtol=0,
                                   atol=GRAD_TOL, err_msg=f"rank {rank}")
    if case == "top2":
        for run in runs:
            assert float(run["aux"]["drop_fraction"]) == 0.0
            assert float(run["aux"]["load_balance_loss"]) >= 1.0


def test_drop_fraction_visible(world4):
    """test_moe_drop_fraction_visible on the port; the same scalars on
    every rank."""
    runs = [r["moe_cases"]["drop"] for r in world4]
    for run in runs:
        assert float(run["aux"]["drop_fraction"]) > 0.2
        assert float(run["aux"]["load_balance_loss"]) > 1.5
        for key in ("drop_fraction", "load_balance_loss"):
            assert torch.equal(run["aux"][key], runs[0]["aux"][key])


@functools.lru_cache(maxsize=None)
def _jax_rebalance_router(steps):
    """The JAX test's router after ``steps`` Adam(0.05) steps on
    load_balance_loss."""
    ws, wr, x, kw, kind, _ = ranks.moe_inputs("rebalance", 4)
    mesh = jax_make_mesh({"ep": 4}, jax.devices()[:4])
    ws, x = jnp.asarray(ws), jnp.asarray(x)
    tx = optax.adam(0.05)

    def lb(w):
        _, aux = jax_moe_sharded(_jax_expert(kind), ws, w, x, mesh, **kw)
        return aux["load_balance_loss"]

    @jax.jit
    def step(w, state):
        updates, state = tx.update(jax.grad(lb)(w), state, w)
        return optax.apply_updates(w, updates), state

    w = jnp.asarray(wr)
    state = tx.init(w)
    for _ in range(steps):
        w, state = step(w, state)
    return np.asarray(w)


def test_aux_loss_reduces_imbalance(world4):
    """test_moe_aux_loss_reduces_imbalance on the port: 120 Adam(0.05)
    steps of the router on load_balance_loss alone; every rank keeps the
    same router (its gradient is summed over the axis). The JAX test's
    bounds on the aux loss hold (collapsed above 1.5 at the start, below
    1.15 at the end), the router follows the JAX package's within 1e-3
    over the first 40 steps, and the drops fall.

    The JAX test also asks for drop_fraction < 0.05 after the 120th step.
    That endpoint rests on the last bits of the router's gradient, which
    cancels to 1e-4 of its terms (softmax derivatives of gates near 0 and
    1): the port's gradient at the JAX router of any step agrees within
    5e-8, the routers part by 1e-4 by step 45, and from step 71 a gate
    near a tie flips a choice. The JAX package itself, given relative
    noise of 1e-4 on its gradient, ends at drop fractions from 0.0 to
    0.203, 7 of 8 seeds above 0.05 (``tests/moe_rebalance_spread.py``);
    so the drop is held to fall, not to that endpoint."""
    runs = [r["moe_rebalance"] for r in world4]
    for run in runs[1:]:
        assert torch.equal(run["router"], runs[0]["router"])
    run = runs[0]
    assert run["lb_first"] > 1.5, run
    assert run["lb_last"] < 1.15, run
    assert run["drop_last"] < run["drop_first"], run
    early = _jax_rebalance_router(ranks.REBALANCE_EARLY)
    np.testing.assert_allclose(run["router_early"].numpy(), early, rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", [2, 4], ids=["w2", "w4"])
def test_experts_match_the_jax_package(world, case, world2, world4):
    results = {2: world2, 4: world4}[world]
    out, runs = _gathered(results, "moe_cases", case)
    ref_out, ref_aux, ref_dws, ref_dwr = _jax_case(case, world)
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=FWD_TOL)
    for rank, run in enumerate(runs):
        for key, want in ref_aux.items():
            got = float(run["aux"][key])
            if key == "drop_fraction":
                assert got == float(want), (rank, got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=FWD_TOL)
        np.testing.assert_allclose(run["dw"].numpy(), ref_dws[rank], rtol=0,
                                   atol=GRAD_TOL, err_msg=f"rank {rank} dw")
        np.testing.assert_allclose(run["drouter"].numpy(), ref_dwr, rtol=0,
                                   atol=GRAD_TOL, err_msg=f"rank {rank} router")


def test_ties_go_to_the_lowest_index(world4):
    """The router's zero columns give experts 1-3 exactly equal gates:
    every token's second choice is expert 1, as lax.top_k picks it, so
    expert 1 takes every second choice and experts 2 and 3 none (their
    gradients are exactly 0)."""
    _, runs = _gathered(world4, "moe_cases", "tie")
    _, wr, x, _, _, _ = ranks.moe_inputs("tie", 4)
    gates = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wr), -1)
    _, idx = jax.lax.top_k(gates, 2)
    assert set(np.asarray(idx[:, 1]).tolist()) == {1}
    assert float(runs[1]["dw"].abs().max()) > 0
    assert float(runs[2]["dw"].abs().max()) == 0.0
    assert float(runs[3]["dw"].abs().max()) == 0.0


def test_bf16_tokens_past_256_slots_keep_their_slots(world2):
    """1024 bf16 tokens a rank, every one to expert 0 at capacity 512: the
    positions run past 256 and each kept token keeps its own slot (a bf16
    cumsum stalls at 256 and collides them). Half drop, as in JAX, whose
    bookkeeping is f32; the kept rows agree with JAX's to bf16 rounding
    and the dropped rows are exactly 0."""
    out, runs = _gathered(world2, "moe_bf16")
    ref_out, ref_aux, _, _ = _jax_case("bf16", 2)
    for run in runs:
        assert run["out"].dtype == torch.bfloat16
        assert float(run["aux"]["drop_fraction"]) == float(ref_aux["drop_fraction"])
        assert float(run["aux"]["drop_fraction"]) == 0.5
    np.testing.assert_allclose(out, ref_out, rtol=2e-2, atol=2e-2)
    _, wr, x, _, _, _ = ranks.moe_inputs("bf16", 2)
    shard = x.shape[0] // 2
    for rank, run in enumerate(runs):
        got = run["out"].float()
        kept = got.abs().sum(-1) > 0
        assert int(kept.sum()) == shard // 2  # the first 512 tokens' slots
        assert bool(kept[:shard // 2].all()) and not bool(kept[shard // 2:].any())
        # each kept token's row is its own: distinct tokens, distinct rows
        xs = torch.from_numpy(x[rank * shard:rank * shard + shard // 2])
        ref_rows = xs.to(torch.bfloat16) @ torch.from_numpy(
            ranks.moe_inputs("bf16", 2)[0][0]).to(torch.bfloat16)
        gate = torch.softmax(xs @ torch.from_numpy(wr), -1)[:, :1]
        np.testing.assert_allclose(got[:shard // 2].numpy(),
                                   (ref_rows.float() * gate).numpy(),
                                   rtol=2e-2, atol=2e-2)
