"""The rank program of ``tests/test_torch_pipeline.py`` and
``tests/test_torch_moe.py``: one process of a gloo group on the CPU,
started with ``torch.multiprocessing``'s spawn.

Every rank makes the same inputs from the same seeds with numpy (the
``*_inputs`` functions, which the tests call too for the JAX side), runs
the port's pipeline or experts with its own stage or expert, and writes
what it got (``torch.save``) to ``<out>.<rank>`` for the test to gather
and compare. It imports torch and the port only.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# the JAX package's test_pipeline_parallel_matches_sequential: relu stages
# of [16, 16], x [32, 16], 8 microbatches
PP_D, PP_B, PP_M, PP_SEED = 16, 32, 8, 9
# a pipeline whose loss reads the first of 2 microbatches alone
BUBBLE_M, BUBBLE_ROWS = 2, 16
# the tiny LM whose 4 blocks are 2 stages of 2: T 64, batch 2 in 2
# microbatches, one Adam(1e-3) step of the mean cross-entropy
LM = dict(vocab_size=50, d_model=64, num_heads=4, num_layers=4, max_len=64)
LM_BATCH, LM_T, LM_M, LM_LR, LM_SEED = 2, 64, 2, 1e-3, 6
# the JAX package's MoE tests: N experts of [8, 8] over 64 tokens
MOE_D, MOE_B = 8, 64


def pp_inputs(world: int):
    """(stacked stage weights [W, D, D], x [B, D]) f32."""
    rng = np.random.default_rng(PP_SEED)
    ws = (rng.standard_normal((world, PP_D, PP_D)) * 0.3).astype(np.float32)
    return ws, rng.standard_normal((PP_B, PP_D)).astype(np.float32)


def relu_stage(w, t):
    return torch.relu(t @ w)


def lm_tokens():
    return np.random.default_rng(LM_SEED).integers(
        0, LM["vocab_size"], (LM_BATCH, LM_T + 1)).astype(np.int32)


def moe_inputs(case: str, world: int):
    """(stacked expert weights [N, D, D], router [D, N], x [B, D], the
    moe keyword arguments, the expert: "relu" or "linear", dtype) of each
    case, N the axis size. The first four are the JAX package's tests
    (its seeds); "vs_jax" drops pairs at capacity 1.25; "tie" routes with
    columns of exactly equal gates; "bf16" sends more than 256 tokens to
    one expert of a bf16 batch."""
    n, d = world, MOE_D
    if case in ("top1", "top2", "vs_jax"):
        rng = np.random.default_rng({"top1": 10, "top2": 21, "vs_jax": 31}[case])
        ws = rng.standard_normal((n, d, d)) * 0.5
        wr = rng.standard_normal((d, n)) * 0.5
        x = rng.standard_normal((MOE_B, d))
        kw = {"top1": dict(capacity_factor=8.0),
              "top2": dict(capacity_factor=8.0, top_k=2, return_aux=True),
              "vs_jax": dict(capacity_factor=1.25, top_k=2, return_aux=True)}[case]
        return (ws.astype(np.float32), wr.astype(np.float32),
                x.astype(np.float32), kw, "relu", "float32")
    if case == "drop":
        rng = np.random.default_rng(22)
        ws = rng.standard_normal((n, d, d))
        wr = np.concatenate([np.full((d, 1), 3.0), np.zeros((d, n - 1))], axis=1)
        x = np.abs(rng.standard_normal((MOE_B, d)))
        return (ws.astype(np.float32), wr.astype(np.float32),
                x.astype(np.float32),
                dict(capacity_factor=1.0, top_k=1, return_aux=True), "linear",
                "float32")
    if case == "rebalance":
        rng = np.random.default_rng(23)
        ws = rng.standard_normal((n, d, d)) * 0.5
        wr = (np.concatenate([np.full((d, 1), 2.0), np.zeros((d, n - 1))], 1)
              + rng.standard_normal((d, n)) * 0.01)
        x = np.abs(rng.standard_normal((MOE_B, d)))
        return (ws.astype(np.float32), wr.astype(np.float32),
                x.astype(np.float32),
                dict(capacity_factor=1.25, top_k=2, return_aux=True), "linear",
                "float32")
    if case == "tie":
        rng = np.random.default_rng(41)
        ws = rng.standard_normal((n, d, d)) * 0.5
        wr = np.concatenate([np.full((d, 1), 3.0), np.zeros((d, n - 1))], axis=1)
        x = np.abs(rng.standard_normal((MOE_B, d)))
        return (ws.astype(np.float32), wr.astype(np.float32),
                x.astype(np.float32),
                dict(capacity_factor=2.0, top_k=2, return_aux=True), "relu",
                "float32")
    if case == "bf16":
        rng = np.random.default_rng(42)
        ws = rng.standard_normal((n, d, d)) * 0.5
        wr = np.concatenate([np.full((d, 1), 3.0), np.zeros((d, n - 1))], axis=1)
        x = np.abs(rng.standard_normal((1024 * n, d)))
        return (ws.astype(np.float32), wr.astype(np.float32),
                x.astype(np.float32),
                dict(capacity_factor=1.0, top_k=1, return_aux=True), "linear",
                "bfloat16")
    raise ValueError(case)


def _leaf(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).requires_grad_(True)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def _pp_run(rank, world, m, rows):
    from raydp_tpu_torch.models.convert import stacked_slice
    from raydp_tpu_torch.parallel import make_mesh, pipeline_sharded

    ws, x = pp_inputs(world)
    w = stacked_slice(ws, rank).requires_grad_(True)
    xx = _leaf(x)
    out = pipeline_sharded(relu_stage, w, xx, make_mesh({"pp": world}), m)
    (out[:rows] ** 2).sum().backward()
    return {"out": out.detach(), "dw": w.grad, "dx": xx.grad}


def pp_relu_task(rank, world, _):
    return _pp_run(rank, world, PP_M, PP_B)


def pp_bubble_task(rank, world, _):
    """Two microbatches over the ranks, the loss on the first one's rows:
    every rank's later microbatch has a zero cotangent, and three of a
    rank's five ticks at W 4 are bubble ticks, each with no graph."""
    return _pp_run(rank, world, BUBBLE_M, BUBBLE_ROWS)


def pp_errors_task(rank, world, _):
    """The two errors, raised on every rank before any collective."""
    from raydp_tpu_torch.parallel import make_mesh, pipeline_sharded

    ws, x = pp_inputs(world)
    mesh = make_mesh({"pp": world})
    msgs = []
    for stage, m in ((lambda w, t: t @ w[:, :8], PP_M), (relu_stage, 5)):
        try:
            pipeline_sharded(stage, torch.from_numpy(ws[rank]),
                             torch.from_numpy(x), mesh, m)
            msgs.append(None)
        except ValueError as exc:
            msgs.append(str(exc))
    return msgs


def pp_lm_task(rank, world, state_path):
    """The tiny LM's blocks as stages (``stage_blocks_from_flax`` of the
    stacked flax blocks), the outer parameters from the whole flax tree:
    the loss, every gradient this rank holds, its parameters after one
    Adam step."""
    from raydp_tpu_torch.models import TransformerLM
    from raydp_tpu_torch.models.convert import stage_blocks_from_flax
    from raydp_tpu_torch.models.transformer import Block
    from raydp_tpu_torch.parallel import make_mesh, pipeline_sharded
    from raydp_tpu_torch.parallel.pipeline import module_stage

    state = torch.load(state_path, weights_only=False)
    lm = TransformerLM(**LM, attn_impl="flash", dtype=torch.float32, device="cpu")
    lm.load_state_dict(state["whole"])
    per = LM["num_layers"] // world
    stage = torch.nn.Sequential(*(
        Block(LM["d_model"], LM["num_heads"], "flash", torch.float32)
        for _ in range(per)))
    stage.load_state_dict(stage_blocks_from_flax(state["stacked"], rank))
    lm.blocks = torch.nn.ModuleList()
    named = dict(lm.named_parameters())
    for name, p in stage.named_parameters():
        i, rest = name.split(".", 1)
        named[f"blocks.{rank * per + int(i)}.{rest}"] = p
    stage_fn, stage_params = module_stage(stage)
    tokens = torch.from_numpy(lm_tokens()).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    opt = torch.optim.Adam(named.values(), lr=LM_LR)
    x = F.embedding(inputs, lm.embed.weight) + lm.pos_embed[:LM_T]
    h = pipeline_sharded(stage_fn, stage_params, x, make_mesh({"pp": world}),
                         LM_M)
    logits = lm.lm_head(lm.ln_f(h).float())
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in named.items()}
    opt.step()
    return {"loss": loss.detach(), "grads": grads,
            "params": {n: p.detach().clone() for n, p in named.items()}}


# ---------------------------------------------------------------------------
# experts
# ---------------------------------------------------------------------------


def moe_expert(kind: str):
    if kind == "relu":
        return lambda w, t: torch.relu(t @ w)
    return lambda w, t: t @ w


def _moe_run(rank, world, case, aux_weight):
    """One case on this rank's expert and token shard: the output shard,
    the aux scalars, and the gradients of the expert and the router for
    sum(out²) (+ ``aux_weight`` · load_balance_loss)."""
    from raydp_tpu_torch.parallel import make_mesh, moe_sharded

    ws, wr, x, kw, kind, dtype = moe_inputs(case, world)
    dt = getattr(torch, dtype)
    w = _leaf(ws[rank], dt)
    router = _leaf(wr)
    shard = x.shape[0] // world
    xs = torch.from_numpy(x[rank * shard:(rank + 1) * shard]).to(dt)
    got = moe_sharded(moe_expert(kind), w, router, xs,
                      make_mesh({"ep": world}), **kw)
    out, aux = got if kw.get("return_aux") else (got, {})
    loss = out.float().pow(2).sum()
    if aux_weight:
        loss = loss + aux_weight * aux["load_balance_loss"]
    loss.backward()
    return {"out": out.detach(), "aux": {k: v.detach() for k, v in aux.items()},
            "dw": w.grad, "drouter": router.grad}


def moe_cases_task(rank, world, _):
    cases = {case: _moe_run(rank, world, case, 0.0)
             for case in ("top1", "top2", "drop", "tie")}
    cases["vs_jax"] = _moe_run(rank, world, "vs_jax", 0.01)
    return cases


def moe_bf16_task(rank, world, _):
    return _moe_run(rank, world, "bf16", 0.0)


REBALANCE_STEPS, REBALANCE_EARLY = 120, 40


def moe_rebalance_task(rank, world, _):
    """test_moe_aux_loss_reduces_imbalance on the port: REBALANCE_STEPS
    Adam(0.05) steps of the router on load_balance_loss alone, the experts
    fixed; the aux scalars of the first and last routers, and the router
    after REBALANCE_EARLY steps and at the end."""
    from raydp_tpu_torch.parallel import make_mesh, moe_sharded

    ws, wr, x, kw, kind, _ = moe_inputs("rebalance", world)
    mesh = make_mesh({"ep": world})
    shard = x.shape[0] // world
    xs = torch.from_numpy(x[rank * shard:(rank + 1) * shard])
    w = torch.from_numpy(ws[rank])
    router = _leaf(wr)
    opt = torch.optim.Adam([router], lr=0.05)
    out = {}
    for step in range(REBALANCE_STEPS):
        opt.zero_grad(set_to_none=True)
        _, aux = moe_sharded(moe_expert(kind), w, router, xs, mesh, **kw)
        aux["load_balance_loss"].backward()
        opt.step()
        if step == 0:
            out["lb_first"] = float(aux["load_balance_loss"].detach())
            out["drop_first"] = float(aux["drop_fraction"])
        if step + 1 == REBALANCE_EARLY:
            out["router_early"] = router.detach().clone()
    with torch.no_grad():
        _, aux = moe_sharded(moe_expert(kind), w, router, xs, mesh, **kw)
    return dict(out, lb_last=float(aux["load_balance_loss"]),
                drop_last=float(aux["drop_fraction"]), router=router.detach())


TASKS = {"pp_relu": pp_relu_task, "pp_bubble": pp_bubble_task,
         "pp_errors": pp_errors_task, "pp_lm": pp_lm_task,
         "moe_cases": moe_cases_task, "moe_bf16": moe_bf16_task,
         "moe_rebalance": moe_rebalance_task}


def run(rank, world, store_path, out_path, tasks, arg=None):
    """Join the gloo group through the FileStore at ``store_path``, run
    ``tasks`` in order and save {task: result} to ``<out_path>.<rank>``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        results = {task: TASKS[task](rank, world, arg) for task in tasks}
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_path}.{rank}.tmp")
    os.replace(f"{out_path}.{rank}.tmp", f"{out_path}.{rank}")


def spawn(tmp_path, world, tasks, arg=None, limit_s=150.0):
    """Run ``tasks`` on ``world`` ranks of ``run``, spawned; every rank's
    results. Every rank must end within ``limit_s`` with exit code 0."""
    ctx = torch.multiprocessing.get_context("spawn")
    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    procs = [ctx.Process(target=run, args=(r, world, store, out, tasks, arg))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(5.0)
    assert not late, f"{len(late)} rank(s) ran past {limit_s} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
