"""The rank program of ``tests/test_torch_seqpar.py``: one process of a
gloo group on the CPU, started with ``torch.multiprocessing``'s spawn.

Every rank makes the same inputs from the same seeds with numpy, runs the
port's sequence-parallel layers on its shard, and writes what it got
(``torch.save``) to ``<out>.<rank>`` for the test to gather and compare.
It imports torch and the port only; the test holds the results against
the JAX package.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# attention: per-rank q/k/v [B, H, T/W, D] of one sequence of ATTN_T rows
ATTN_B, ATTN_H, ATTN_T, ATTN_D, ATTN_SEED = 1, 4, 64, 16, 31
IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
# the tiny LM: 2 layers, d_model 64, 4 heads, T 64 (tokens [2, 65] drawn,
# inputs the first 64, targets the last 64), one Adam(1e-3) step
LM = dict(vocab_size=50, d_model=64, num_heads=4, num_layers=2, max_len=64)
LM_BATCH, LM_T, LM_LR, LM_SEED = 2, 64, 1e-3, 6
# examples/long_context_lm.py at W ranks: 128 tokens a rank, W heads
EXAMPLE = dict(vocab_size=256, d_model=128, num_layers=2)
EXAMPLE_STEPS, EXAMPLE_LR = 5, 3e-4


def attention_inputs(seed: int = ATTN_SEED):
    """(q, k, v, g) [B, H, T, D] f32, the whole sequence."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((ATTN_B, ATTN_H, ATTN_T, ATTN_D))
                 .astype(np.float32) for _ in range(4))


def lm_tokens():
    """[2, 65] int32: the JAX package's recipe pads 64 drawn tokens with
    the first one so that 64 inputs divide the axis."""
    tok = np.random.default_rng(LM_SEED).integers(0, LM["vocab_size"],
                                                  (LM_BATCH, LM_T))
    return np.concatenate([tok, tok[:, :1]], axis=1).astype(np.int32)


def _shard(x, rank, world):
    t = x.shape[2] // world
    return x[:, :, rank * t:(rank + 1) * t]


def _attend(impl, q, k, v, mesh, causal):
    from raydp_tpu_torch.parallel import (
        bound_axes,
        ring_attention_sharded,
        ulysses_attention,
    )

    use_flash = impl.endswith("_flash")
    if impl.startswith("ring"):
        return ring_attention_sharded(q, k, v, mesh, "sp", causal, use_flash)
    with bound_axes(mesh):
        return ulysses_attention(q, k, v, "sp", causal, use_flash)


def attention_task(rank, world, _):
    """Every impl, causal and not: this rank's output and q/k/v gradient
    shards for the cotangent g."""
    from raydp_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sp": world})
    q, k, v, g = (torch.from_numpy(_shard(x, rank, world).copy())
                  for x in attention_inputs())
    out = {}
    for impl in IMPLS:
        for causal in (False, True):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = _attend(impl, *leaves, mesh, causal)
            o.backward(g)
            out[f"{impl} causal={causal}"] = [o.detach()] + [
                x.grad for x in leaves]
    return out


def bad_heads_task(rank, world, _):
    """Ulysses with 3 heads over the axis: the error's message."""
    from raydp_tpu_torch.parallel import bound_axes, make_mesh, ulysses_attention

    mesh = make_mesh({"sp": world})
    x = torch.zeros((1, 3, 4, 8))
    try:
        with bound_axes(mesh):
            ulysses_attention(x, x, x, "sp")
    except ValueError as exc:
        return str(exc)
    return None


def mesh2d_task(rank, world, _):
    """ring_flash, causal, over the "sp" axis of a {"data": 2, "sp": W/2}
    mesh: each data row its own ring on its own inputs (seed 40 + row)."""
    from raydp_tpu_torch.parallel import make_mesh, ring_attention_sharded

    mesh = make_mesh({"data": 2, "sp": world // 2})
    row, col = mesh.axis_index("data"), mesh.axis_index("sp")
    q, k, v, _ = (torch.from_numpy(_shard(x, col, world // 2).copy())
                  for x in attention_inputs(40 + row))
    o = ring_attention_sharded(q, k, v, mesh, "sp", True, True)
    return {"row": row, "col": col, "out": o}


def _lm_loss(logits, targets, total):
    """This rank's share of the global mean cross-entropy."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="sum") / total


def lm_task(rank, world, state_path):
    """The tiny LM from the flax weights in ``state_path`` under
    ``sequence_parallel_apply`` for ring and ulysses: the logits shard, then
    one Adam step's loss, gradients and parameters."""
    from raydp_tpu_torch.models import TransformerLM, sequence_parallel_apply
    from raydp_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sp": world})
    state = torch.load(state_path)
    tokens = torch.from_numpy(lm_tokens()).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    t_local = LM_T // world
    local_targets = targets[:, rank * t_local:(rank + 1) * t_local]
    out = {}
    for impl in ("ring", "ulysses"):
        model = TransformerLM(**LM, attn_impl=impl, dtype=torch.float32,
                              device="cpu")
        model.load_state_dict(state)
        with torch.no_grad():
            logits = sequence_parallel_apply(model, inputs, mesh)
        opt = torch.optim.Adam(model.parameters(), lr=LM_LR)
        loss = _lm_loss(sequence_parallel_apply(model, inputs, mesh),
                        local_targets, LM_BATCH * LM_T)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt.step()
        total = loss.detach().clone()
        dist.all_reduce(total)
        out[impl] = {"logits": logits, "loss": total, "grads": grads,
                     "params": {n: p.detach().clone()
                                for n, p in model.named_parameters()}}
    return out


def example_task(rank, world, _):
    """examples/long_context_lm.py's loop: a ring LM over a sequence of 128
    tokens a rank, 5 Adam(3e-4) steps; the global loss of each step."""
    from raydp_tpu_torch.models import TransformerLM, sequence_parallel_apply
    from raydp_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sp": world})
    seq = 128 * world
    model = TransformerLM(**EXAMPLE, num_heads=world, max_len=seq,
                          attn_impl="ring", dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, EXAMPLE["vocab_size"], size=(2, seq))).long()
    shifted = torch.roll(tokens, -1, dims=1)
    t_local = seq // world
    local = shifted[:, rank * t_local:(rank + 1) * t_local]
    opt = torch.optim.Adam(model.parameters(), lr=EXAMPLE_LR)
    losses = []
    for _ in range(EXAMPLE_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = _lm_loss(sequence_parallel_apply(model, tokens, mesh), local,
                        tokens.numel())
        loss.backward()
        opt.step()
        total = loss.detach().clone()
        dist.all_reduce(total)
        losses.append(float(total))
    return losses


TASKS = {"attention": attention_task, "bad_heads": bad_heads_task,
         "mesh2d": mesh2d_task, "lm": lm_task, "example": example_task}


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
