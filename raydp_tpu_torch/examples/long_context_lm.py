"""Long-context LM training with ring attention, on the port: the
counterpart of the repository's ``examples/long_context_lm.py``. The
sequence is sharded over the ranks of a mesh: each holds T / W tokens,
and the K/V blocks rotate around the ring of ranks.

One rank (the card, or ``--device cpu``), or ``torch.distributed.run``'s
ranks (gloo on the CPU)::

    python -m raydp_tpu_torch.examples.long_context_lm [--device cpu]
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m raydp_tpu_torch.examples.long_context_lm --device cpu

As the JAX script, the model takes ``attn_impl="ring"`` (the ring's
block products in PyTorch ops), so it launches no hand-written kernel.
"""

from __future__ import annotations

import numpy as np

from raydp_tpu_torch.examples._common import parser

VOCAB, D_MODEL, LAYERS = 256, 128, 2
TOKENS_PER_RANK, BATCH, STEPS, LR = 128, 2, 5, 3e-4


def make_model(world: int, device, seed: int = 0):
    """The ring LM for W ranks: vocab 256, d_model 128, W heads, 2 layers,
    f32, ``max_len`` the whole sequence (128 tokens a rank)."""
    import torch

    from raydp_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=VOCAB, d_model=D_MODEL, num_heads=world,
                         num_layers=LAYERS, max_len=TOKENS_PER_RANK * world,
                         attn_impl="ring", dtype=torch.float32, device=device,
                         seed=seed)


def example_tokens(seq: int) -> np.ndarray:
    """[2, seq] ids from ``default_rng(0)``: the JAX script's batch."""
    return np.random.default_rng(0).integers(0, VOCAB, size=(BATCH, seq))


def train(model, tokens, mesh, steps: int = STEPS, lr: float = LR) -> list:
    """Adam(lr) steps of next-token cross-entropy over the whole sequence
    (the targets are the tokens rolled by one, as in the JAX script), each
    rank on its shard through ``sequence_parallel_apply``; returns each
    step's global loss (the mean over every position)."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from raydp_tpu_torch.models import sequence_parallel_apply

    tokens = torch.as_tensor(tokens, device=model.device).long()
    n = mesh.shape["sp"]
    t_local = tokens.shape[1] // n
    r = mesh.axis_index("sp")
    targets = torch.roll(tokens, -1, dims=1)[:, r * t_local:(r + 1) * t_local]
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        logits = sequence_parallel_apply(model, tokens, mesh)
        # this rank's share of the global mean: its shard's sum over B * T
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1),
                               reduction="sum") / tokens.numel()
        loss.backward()
        opt.step()
        total = loss.detach().clone()
        dist.all_reduce(total, group=mesh.group("sp"))
        losses.append(float(total))
    return losses


def join_ranks(device):
    """(W, device, joined): ``torch.distributed.run``'s default group where
    it started this process, else a group of one of this process (the
    ring's parameters sum their gradients over the axis's group), gloo on
    the CPU, NCCL where each rank has a card of its own."""
    import os
    import socket

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size(), device, False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    own_cards = device.type == "cuda" and torch.cuda.device_count() >= world
    backend = "nccl" if own_cards else "gloo"
    if world > 1:
        dist.init_process_group(backend, init_method="env://")
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    return dist.get_world_size(), device, True


def main(argv=None) -> dict:
    """Run the example; returns each step's loss and the trained model."""
    from raydp_tpu_torch._device import resolve_device

    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    world, device, joined = join_ranks(device)

    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh

    try:
        mesh = make_mesh({"sp": world})
        seq = TOKENS_PER_RANK * world  # a sequence W times one rank's share
        model = make_model(world, device)
        losses = train(model, example_tokens(seq), mesh)
        if dist.get_rank() == 0:
            for i, loss in enumerate(losses):
                print(f"step {i}: loss {loss:.4f} (seq={seq} over {world} "
                      "devices)")
    finally:
        if joined:
            dist.destroy_process_group()
    return {"losses": losses, "model": model, "world": world}


if __name__ == "__main__":
    main()
