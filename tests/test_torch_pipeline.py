"""Pipeline parallelism of the port (``raydp_tpu_torch/parallel/pipeline.py``)
against the JAX package's (``raydp_tpu/parallel/pipeline.py``).

The JAX side runs as its own tests run it, on the virtual CPU devices
(``make_mesh({"pp": W}, jax.devices()[:W])``). The port side runs W gloo
ranks on the CPU, spawned from ``tests/torch_parallel_ranks.py``: every
rank makes the same seeded numpy inputs, holds its own stage (rank r's
slice of the stacked weights, ``models.convert.stacked_slice``) and saves
what it got.

- The relu stages of ``test_pipeline_parallel_matches_sequential`` at W 2
  and 4, 8 microbatches: every rank's output against the JAX package's
  ``pipeline_sharded`` within 1e-5, its stage's gradient against the JAX
  gradient's slice and the input's gradient (the same on every rank)
  within 1e-4, for the loss sum(out²) taken on every rank alike.
- A loss on the first of 2 microbatches at W 4 (three bubble ticks a
  rank, every later microbatch with a zero cotangent): every rank
  finishes its backward within the ranks' time limit, and the gradients
  match the JAX package's.
- Both errors of the reference, on every rank: a stage that changes the
  activation's shape, a batch that M does not divide.
- A tiny ``TransformerLM`` (4 layers, d_model 64, 4 heads, T 64, f32,
  ``attn_impl="flash"`` on both sides, the JAX kernels in interpret mode)
  whose blocks are 2 stages of 2 at W 2: the port's stages from the
  stacked flax blocks (``stage_blocks_from_flax``), against the JAX
  package's ``pipeline_apply`` over flax ``Block.apply`` under
  ``pipeline_sharded``'s body (with ``shard_map``'s varying-axes check
  off, which the Pallas kernels in interpret mode need): the loss
  (rtol 1e-5), every gradient of every rank (1e-4 relative per tensor),
  and the parameters after one Adam(1e-3) step held as
  ``tests/test_torch_training.py`` holds an update.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

import torch_parallel_ranks as ranks
from raydp_tpu.models.transformer import Block as FlaxBlock
from raydp_tpu.models.transformer import TransformerLM as FlaxLM
from raydp_tpu.parallel import make_mesh as jax_make_mesh
from raydp_tpu.parallel import pipeline_sharded as jax_pipeline_sharded
from raydp_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from raydp_tpu.parallel.sharding import shard_map_compat
from raydp_tpu_torch.models.convert import params_from_flax

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _flax_lm():
    return FlaxLM(**ranks.LM, attn_impl="flash", dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _flax_params():
    tokens = jnp.asarray(ranks.lm_tokens())
    params = _flax_lm().init(jax.random.PRNGKey(0), tokens[:, :8])
    return jax.tree_util.tree_map(np.asarray, params)


def _stacked_blocks(params, world):
    """{"Block_i": the i-th block of every stage, stacked on a leading
    stage dim}: stage s holds the whole model's blocks s*L/W + i."""
    tree = params["params"]
    per = ranks.LM["num_layers"] // world
    return {f"Block_{i}": jax.tree_util.tree_map(
        lambda *leaves: np.stack(leaves),
        *[tree[f"Block_{s * per + i}"] for s in range(world)])
        for i in range(per)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp2")
    state = tmp / "lm_state.pt"
    params = _flax_params()
    torch.save({"whole": params_from_flax(params),
                "stacked": _stacked_blocks(params, 2)}, state)
    return ranks.spawn(tmp, 2, ["pp_relu", "pp_errors", "pp_lm"], str(state))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return ranks.spawn(tmp_path_factory.mktemp("pp4"), 4,
                       ["pp_relu", "pp_bubble"])


@functools.lru_cache(maxsize=None)
def _jax_relu(world, m, rows):
    """(out, d stacked weights, dx) of the JAX package's pipeline for the
    loss sum(out[:rows]²)."""
    mesh = jax_make_mesh({"pp": world}, jax.devices()[:world])
    ws, x = (jnp.asarray(a) for a in ranks.pp_inputs(world))

    def stage_fn(w, t):
        return jax.nn.relu(t @ w)

    def loss(ws, x):
        out = jax_pipeline_sharded(stage_fn, ws, x, mesh, num_microbatches=m)
        return jnp.sum(out[:rows] ** 2), out

    (_, out), (dws, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(ws, x)
    return np.asarray(out), np.asarray(dws), np.asarray(dx)


def _check_relu(results, world, m, rows):
    out, dws, dx = _jax_relu(world, m, rows)
    for rank, got in enumerate(results):
        np.testing.assert_allclose(got["out"].numpy(), out, rtol=0,
                                   atol=FWD_TOL, err_msg=f"rank {rank} out")
        np.testing.assert_allclose(got["dw"].numpy(), dws[rank], rtol=0,
                                   atol=GRAD_TOL, err_msg=f"rank {rank} dw")
        np.testing.assert_allclose(got["dx"].numpy(), dx, rtol=0,
                                   atol=GRAD_TOL, err_msg=f"rank {rank} dx")


@pytest.mark.parametrize("world", [2, 4], ids=["w2", "w4"])
def test_relu_stages_match_the_jax_package(world, world2, world4):
    results = {2: world2, 4: world4}[world]
    _check_relu([r["pp_relu"] for r in results], world, ranks.PP_M, ranks.PP_B)


def test_a_rank_whose_bubble_ticks_get_no_gradient_finishes(world4):
    """The loss reads microbatch 0 alone: every rank still runs the whole
    reverse schedule and its shifts (the fixture's ranks ended within
    their time limit), and the gradients are the JAX package's."""
    _check_relu([r["pp_bubble"] for r in world4], 4, ranks.BUBBLE_M,
                ranks.BUBBLE_ROWS)
    assert all(float(r["pp_bubble"]["dx"][ranks.BUBBLE_ROWS:].abs().max()) == 0.0
               for r in world4)


def test_both_errors_are_raised_on_every_rank(world2):
    assert [r["pp_errors"] for r in world2] == [[
        "pipeline stages must preserve activation shape "
        "(got (4, 16) -> (4, 8))",
        "batch 32 not divisible by 5 microbatches"]] * 2


def _jax_pipeline_flash(stage_fn, stacked, x, mesh, m):
    """The JAX package's ``pipeline_sharded`` with its body under
    ``shard_map(check_vma=False)``: the Pallas kernels in interpret mode
    carry no varying-axes types, which the checked ``shard_map`` of
    ``pipeline_sharded`` refuses (its ring tests turn the check off for
    flash the same way). The body is the wrapper's: the JAX package's
    ``pipeline_apply`` on the device's stage, then the masked ``psum``."""
    from jax import lax
    from jax.sharding import PartitionSpec as P

    b = x.shape[0]
    micro = x.reshape(m, b // m, *x.shape[1:])

    def body(params_local, micro_all):
        params = jax.tree.map(lambda p: p[0], params_local)
        outs = jax_pipeline_apply(stage_fn, params, micro_all, axis_name="pp")
        n = lax.psum(1, "pp")
        mask = (lax.axis_index("pp") == n - 1).astype(outs.dtype)
        return lax.psum(outs * mask, "pp")

    out = shard_map_compat(body, mesh=mesh,
                           in_specs=(jax.tree.map(lambda _: P("pp"), stacked), P()),
                           out_specs=P(), check_vma=False)(stacked, micro)
    return out.reshape(b, *out.shape[2:])


@functools.lru_cache(maxsize=None)
def _jax_lm_run():
    """(loss, grads, params after one Adam step) of the flax LM with its
    blocks through the JAX package's pipeline_sharded at W 2, as the
    port's state_dict names: the stages' slices map to the whole model's
    blocks."""
    world = 2
    mesh = jax_make_mesh({"pp": world}, jax.devices()[:world])
    params = jax.tree_util.tree_map(jnp.asarray, _flax_params())
    tree = params["params"]
    outer = {k: v for k, v in tree.items() if not k.startswith("Block_")}
    stacked = jax.tree_util.tree_map(jnp.asarray, _stacked_blocks(_flax_params(), world))
    block = FlaxBlock(num_heads=ranks.LM["num_heads"], attn_impl="flash",
                      dtype=jnp.float32)
    per = ranks.LM["num_layers"] // world
    tokens = jnp.asarray(ranks.lm_tokens())
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def stage_fn(p, x):
        for i in range(per):
            x = block.apply({"params": p[f"Block_{i}"]}, x)
        return x

    vocab, d = ranks.LM["vocab_size"], ranks.LM["d_model"]

    def loss_fn(outer, stacked):
        # the flax TransformerLM's own modules around the pipeline
        x = nn.Embed(vocab, d, dtype=jnp.float32).apply(
            {"params": outer["Embed_0"]}, inputs)
        x = x + outer["pos_embed"][:ranks.LM_T]
        h = _jax_pipeline_flash(stage_fn, stacked, x, mesh, ranks.LM_M)
        h = nn.LayerNorm(dtype=jnp.float32).apply(
            {"params": outer["LayerNorm_0"]}, h)
        logits = nn.Dense(vocab, dtype=jnp.float32).apply(
            {"params": outer["lm_head"]}, h)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, targets))

    loss, (g_outer, g_stacked) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1)))(outer, stacked)
    # back to the whole model's tree: stage s's Block_i is Block_{s*per+i}
    grads = dict(g_outer)
    for s in range(world):
        for i in range(per):
            grads[f"Block_{s * per + i}"] = jax.tree_util.tree_map(
                lambda a: a[s], g_stacked[f"Block_{i}"])
    tx = optax.adam(ranks.LM_LR)
    new = optax.apply_updates(tree, tx.update(grads, tx.init(tree), tree)[0])
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (float(loss), params_from_flax(to_np(grads)),
            params_from_flax(to_np(new)))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_lm_blocks_as_stages_match_the_jax_package(world2):
    ref_loss, ref_grads, ref_params = _jax_lm_run()
    init = params_from_flax(_flax_params())
    runs = [r["pp_lm"] for r in world2]
    assert float(runs[0]["loss"]) == float(runs[1]["loss"])
    held = set()
    for rank, run in enumerate(runs):
        np.testing.assert_allclose(float(run["loss"]), ref_loss, rtol=1e-5)
        for name, g in run["grads"].items():
            assert _rel(g, ref_grads[name]) <= GRAD_TOL, (rank, name)
        for name, p in run["params"].items():
            g = ref_grads[name].abs()
            signal = g >= 1e-3 * g.max()
            upd = (p - init[name])[signal]
            ref_upd = (ref_params[name] - init[name])[signal]
            assert _rel(upd, ref_upd) <= GRAD_TOL, (rank, name)
            worst = float((p - ref_params[name]).abs().max())
            assert worst <= 2 * ranks.LM_LR * 1.01, (rank, name, worst)
        held |= set(run["grads"])
    # between them the ranks hold every parameter; the outer ones on both
    assert held == set(ref_grads)
    for name in ("embed.weight", "pos_embed", "ln_f.weight", "lm_head.weight"):
        assert torch.equal(runs[0]["grads"][name], runs[1]["grads"][name])


def test_pipeline_at_one_rank_is_the_stage_chain(tmp_path):
    """A pipeline of one rank sends nothing: on a one-rank gloo group in
    this process, 8 microbatches through 4 relu stages chained in one
    stage give the sequential result and gradients, and with no gradient
    the forward alone."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh, pipeline_sharded

    ws, x = (torch.from_numpy(a) for a in ranks.pp_inputs(4))

    def chain(w, t):
        for i in range(w.shape[0]):
            t = torch.relu(t @ w[i])
        return t

    w = ws.clone().requires_grad_(True)
    ref = chain(w, x)
    (ref ** 2).sum().backward()
    ref_grad = w.grad.clone()
    w.grad = None
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh({"pp": 1})
        out = pipeline_sharded(chain, w, x, mesh, 8)
        (out ** 2).sum().backward()
        with torch.no_grad():
            plain = pipeline_sharded(chain, w, x, mesh, 8)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(w.grad.numpy(), ref_grad.numpy(), rtol=0,
                               atol=GRAD_TOL)
    assert torch.equal(plain, out.detach()) and not plain.requires_grad
