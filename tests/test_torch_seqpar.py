"""Sequence parallelism of the port (``raydp_tpu_torch/parallel/``,
``models.sequence_parallel_apply``) against the JAX package's
(``raydp_tpu/parallel/ring_attention.py``, ``mesh.py``,
``models/transformer.py``).

The JAX side runs as its own tests run it, on the virtual CPU devices
(``make_mesh({"sp": W}, jax.devices()[:W])``, ``shard_map``). The port side
runs W gloo ranks on the CPU, spawned with ``torch.multiprocessing`` (a
``FileStore`` under ``tmp_path``, every rank under its own time limit),
from ``tests/torch_seqpar_ranks.py``: every rank makes the same seeded
numpy inputs and saves its shards, which are gathered here.

- ``ring``, ``ring_flash``, ``ulysses`` and ``ulysses_flash`` at W 2 and 4,
  causal and not: the output and the q/k/v gradients against the JAX
  package's ``ring_attention_sharded`` / ``ulysses_attention`` under
  ``shard_map`` and against the port's ``full_attention``. f32; forward
  within 1e-5 and gradients within 1e-4 (max abs; measured below 2e-6).
- A ring over the "sp" axis of a 2 x 2 mesh: each data row its own ring.
- ``make_mesh`` shapes and errors, as ``test_make_mesh_shapes``; an
  unbound axis raises ``NameError``; Ulysses with heads not divisible by
  the axis raises the reference's ``ValueError``.
- A tiny ``TransformerLM`` (2 layers, d_model 64, 4 heads, T 64) under
  ``sequence_parallel_apply`` with ``ring`` and ``ulysses`` at W 2, from
  flax weights (``params_from_flax``): the logits against the JAX
  package's ``sequence_parallel_apply`` (1e-5), then one Adam(1e-3) step
  of the global mean cross-entropy as ``test_transformer_train_step_sp``
  takes it: loss rtol 1e-6, gradients 1e-4 relative per tensor, the update
  held as ``tests/test_torch_training.py`` holds it.
- ``examples/long_context_lm.py``'s loop on the port: 5 Adam steps of a
  ring LM under ``sequence_parallel_apply`` at W 2; the loss falls.
"""

import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import torch_seqpar_ranks as ranks
from raydp_tpu.models.transformer import TransformerLM as FlaxLM
from raydp_tpu.models.transformer import sequence_parallel_apply as jax_spa
from raydp_tpu.parallel import make_mesh as jax_make_mesh
from raydp_tpu.parallel import mesh_axis_size as jax_mesh_axis_size
from raydp_tpu.parallel import ring_attention_sharded as jax_ring_sharded
from raydp_tpu.parallel import ulysses_attention as jax_ulysses
from raydp_tpu.parallel.sharding import shard_map_compat
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.parallel import (
    axis_env_size,
    bound_axes,
    full_attention,
    make_mesh,
    mesh_axis_size,
    multihost_mesh,
    ring_attention,
)

RANK_LIMIT_S = 150.0
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


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


def _flax_lm(attn_impl):
    return FlaxLM(**ranks.LM, attn_impl=attn_impl, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _flax_params():
    tokens = jnp.asarray(ranks.lm_tokens())
    params = _flax_lm("full").init(jax.random.PRNGKey(0), tokens[:, :8])
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp2")
    state = tmp / "lm_state.pt"
    torch.save(params_from_flax(_flax_params()), state)
    return _spawn_ranks(tmp, 2, ["attention", "bad_heads", "lm", "example"],
                        str(state))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn_ranks(tmp_path_factory.mktemp("sp4"), 4,
                        ["attention", "mesh2d"])


def _gathered(results, key):
    """[out, dq, dk, dv] of the whole sequence from the ranks' shards."""
    parts = [r["attention"][key] for r in results]
    return [torch.cat([p[i] for p in parts], dim=2).numpy() for i in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_attention(impl, world, causal):
    mesh = jax_make_mesh({"sp": world}, jax.devices()[:world])
    q, k, v, g = (jnp.asarray(x) for x in ranks.attention_inputs())
    use_flash = impl.endswith("_flash")
    if impl.startswith("ring"):
        def fn(a, b, c):
            return jax_ring_sharded(a, b, c, mesh, axis="sp", causal=causal,
                                    use_flash=use_flash)
    else:
        spec = P(None, None, "sp", None)
        fn = shard_map_compat(
            functools.partial(jax_ulysses, axis_name="sp", causal=causal,
                              use_flash=use_flash),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False if use_flash else None)
    @jax.jit
    def forward_and_grads(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g))

    return [np.asarray(x) for x in forward_and_grads(q, k, v, g)]


def _port_full(causal):
    q, k, v, g = (torch.from_numpy(x) for x in ranks.attention_inputs())
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = full_attention(*leaves, causal=causal)
    out.backward(g)
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


def _check(got, want, what):
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (FWD_TOL,) + (GRAD_TOL,) * 3):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("impl", ranks.IMPLS)
@pytest.mark.parametrize("world", [2, 4], ids=["w2", "w4"])
def test_attention_matches_the_jax_package_and_full(world, impl, causal,
                                                    world2, world4):
    results = {2: world2, 4: world4}[world]
    got = _gathered(results, f"{impl} causal={causal}")
    _check(got, _jax_attention(impl, world, causal), f"{impl} vs JAX")
    _check(got, _port_full(causal), f"{impl} vs full_attention")


def test_ring_over_one_axis_of_a_2d_mesh(world4):
    rows = {}
    for r in world4:
        got = r["mesh2d"]
        rows.setdefault(got["row"], {})[got["col"]] = got["out"]
    assert sorted(rows) == [0, 1]
    for row, cols in rows.items():
        out = torch.cat([cols[c] for c in sorted(cols)], dim=2)
        q, k, v, _ = (torch.from_numpy(x) for x in ranks.attention_inputs(40 + row))
        np.testing.assert_allclose(out.numpy(),
                                   full_attention(q, k, v, True).numpy(),
                                   rtol=0, atol=FWD_TOL)


def test_ulysses_refuses_heads_not_divisible_by_the_axis(world2):
    msgs = [r["bad_heads"] for r in world2]
    assert msgs == ["heads 3 not divisible by sequence axis 2"] * 2


def test_make_mesh_shapes_and_errors(cpu_mesh_devices):
    """``test_make_mesh_shapes`` on both packages, over 8 ranks (no process
    group is needed for the shape logic)."""
    for make, size, n8 in ((jax_make_mesh, jax_mesh_axis_size,
                            jax.devices()[:8]),
                           (make_mesh, mesh_axis_size, range(8))):
        mesh = make({"data": -1}, n8)
        assert size(mesh, "data") == 8
        mesh = make({"data": 2, "model": -1}, n8)
        assert dict(mesh.shape) == {"data": 2, "model": 4}
        assert size(mesh, "absent") == 1
        for axes in ({"data": 16}, {"data": -1, "model": -1},
                     {"data": 3, "model": -1}):
            with pytest.raises(ValueError):
                make(axes, n8)
    mesh = make_mesh({"data": 2, "sp": 4}, range(8))
    assert mesh.ranks.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert (mesh.axis_index("sp", 6), mesh.axis_index("data", 6)) == (2, 1)
    assert make_mesh({"sp": -1}).shape == {"sp": 1}  # no process group: rank 0
    with pytest.raises(NotImplementedError, match="spmd/bootstrap"):
        multihost_mesh({"data": -1})


def test_an_unbound_axis_raises():
    x = torch.zeros((1, 2, 4, 8))
    with pytest.raises(NameError, match="unbound axis name: sp"):
        ring_attention(x, x, x, "sp")
    with bound_axes(make_mesh({"sp": 1})):
        assert axis_env_size("sp") == 1
        with pytest.raises(NameError, match="unbound axis name: tp"):
            axis_env_size("tp")


@functools.lru_cache(maxsize=None)
def _jax_lm_run(attn_impl):
    """(logits, loss, grads, params after one Adam step) of the flax model
    under the JAX package's ``sequence_parallel_apply`` at W 2."""
    mesh = jax_make_mesh({"sp": 2}, jax.devices()[:2])
    model = _flax_lm(attn_impl)
    params = jax.tree_util.tree_map(jnp.asarray, _flax_params())
    tokens = jnp.asarray(ranks.lm_tokens())
    tx = optax.adam(ranks.LM_LR)

    @jax.jit
    def step(p):
        def loss_fn(p):
            logits = jax_spa(model, p, tokens[:, :-1], mesh)
            return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
                logits, tokens[:, 1:])), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return logits, loss, grads, optax.apply_updates(p, updates)

    logits, loss, grads, new = step(params)
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (np.asarray(logits), float(loss), params_from_flax(tree(grads)),
            params_from_flax(tree(new)))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_lm_logits_match_the_jax_package(world2, attn_impl):
    logits = torch.cat([r["lm"][attn_impl]["logits"] for r in world2], dim=1)
    want, _, _, _ = _jax_lm_run(attn_impl)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_lm_adam_step_matches_the_jax_package(world2, attn_impl):
    """Every rank holds the global loss's gradients and the same parameters
    after the step; against the JAX package's recipe."""
    _, ref_loss, ref_grads, ref_params = _jax_lm_run(attn_impl)
    init = params_from_flax(_flax_params())
    runs = [r["lm"][attn_impl] for r in world2]
    for run in runs[1:]:
        assert all(torch.equal(run["params"][n], p)
                   for n, p in runs[0]["params"].items())
    run = runs[0]
    np.testing.assert_allclose(float(run["loss"]), ref_loss, rtol=1e-6)
    assert run["grads"].keys() == ref_grads.keys()
    for name, g in run["grads"].items():
        assert _rel(g, ref_grads[name]) <= 1e-4, (name, _rel(g, ref_grads[name]))
    for name, p in run["params"].items():
        g = ref_grads[name].abs()
        signal = g >= 1e-3 * g.max()
        upd = (p - init[name])[signal]
        ref_upd = (ref_params[name] - init[name])[signal]
        assert _rel(upd, ref_upd) <= 1e-4, (name, _rel(upd, ref_upd))
        worst = float((p - ref_params[name]).abs().max())
        assert worst <= 2 * ranks.LM_LR * 1.01, (name, worst)


def test_long_context_example_loss_falls(world2):
    losses = [r["example"] for r in world2]
    assert losses[0] == losses[1]  # the global loss, on every rank
    assert len(losses[0]) == ranks.EXAMPLE_STEPS
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]


def test_sequence_parallel_apply_refuses_a_sequence_off_the_axis():
    from raydp_tpu_torch.models import TransformerLM, sequence_parallel_apply

    lm = TransformerLM(**ranks.LM, attn_impl="ring", dtype=torch.float32,
                       device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        sequence_parallel_apply(lm, torch.zeros((1, 7), dtype=torch.int64),
                                make_mesh({"sp": 2}, [0, 1]))


def test_sequence_parallel_apply_at_one_rank_is_the_model(tmp_path):
    """A ring of one rank is the whole sequence: on a one-rank gloo group
    in this process, every impl gives ``attn_impl="full"``'s loss and
    gradients (the ring sends nothing; Ulysses' all-to-alls and the
    parameters' all-reduce run on the group)."""
    from raydp_tpu_torch.models import TransformerLM, sequence_parallel_apply

    tokens = torch.from_numpy(ranks.lm_tokens()).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def loss_and_grads(lm, apply):
        lm.zero_grad(set_to_none=True)
        logits = apply(lm)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        loss.backward()
        return loss.item(), {n: p.grad for n, p in lm.named_parameters()}

    full = TransformerLM(**ranks.LM, attn_impl="full", dtype=torch.float32,
                         device="cpu")
    ref_loss, ref_grads = loss_and_grads(full, lambda lm: lm(inputs))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh({"sp": -1})
        for impl in ranks.IMPLS:
            lm = TransformerLM(**ranks.LM, attn_impl=impl, dtype=torch.float32,
                               device="cpu")
            loss, grads = loss_and_grads(
                lm, lambda m: sequence_parallel_apply(m, inputs, mesh))
            np.testing.assert_allclose(loss, ref_loss, rtol=1e-6, err_msg=impl)
            for name, g in grads.items():
                assert _rel(g, ref_grads[name]) <= 1e-4, (impl, name)
    finally:
        dist.destroy_process_group()
