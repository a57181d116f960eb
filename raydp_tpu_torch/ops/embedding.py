"""Embedding lookup over vocab-sharded tables: the counterpart of
``raydp_tpu/ops/embedding.py``.

A table of V rows split over a mesh axis of N ranks holds rows
``[i * V/N, (i + 1) * V/N)`` on the rank at coordinate i. Every rank gets
the same (global) ids; each gathers the ids that fall in its block, zeros
the others, and an all-reduce over the axis's group assembles whole rows
on every rank. It is the JAX package's mask-gather-psum, not a kernel: the
JAX package too runs it as ``jnp.take`` and a ``psum``.

The backward scatters the cotangent of the in-range ids into the local
block only, as ``F.embedding``'s backward does (the same deterministic
accumulation, so a rank's rows get the bits a whole table's would). The
all-reduce's cotangent needs no collective: the rows are replicated along
the axis, so every rank already holds the whole cotangent, and the
transpose of the psum is the identity there (``tests/test_torch_sharding.py``
holds the gradients against ``jnp.take``'s).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raydp_tpu_torch.parallel.mesh import bound_axes, bound_mesh


class _VocabShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, start, group):
        local_ids = ids.long() - start
        in_range = (local_ids >= 0) & (local_ids < table.shape[0])
        safe = local_ids.clamp(0, table.shape[0] - 1)
        rows = F.embedding(safe, table)
        rows = torch.where(in_range.unsqueeze(-1), rows, rows.new_zeros(()))
        if group is not None:
            torch.distributed.all_reduce(rows, group=group)
        ctx.save_for_backward(safe, in_range)
        ctx.num_rows = table.shape[0]
        return rows

    @staticmethod
    def backward(ctx, g):
        safe, in_range = ctx.saved_tensors
        g = torch.where(in_range.unsqueeze(-1), g, g.new_zeros(()))
        grad = torch.ops.aten.embedding_dense_backward(
            g.contiguous(), safe, ctx.num_rows, -1, False)
        return grad, None, None, None


def embedding_lookup_vocab_sharded(table: torch.Tensor, ids: torch.Tensor,
                                   axis_name: str) -> torch.Tensor:
    """The per-rank body (call with the axis bound, ``bound_axes``):
    ``table`` is this rank's block [V/N, D] of the table, ``ids`` global
    ids (the same on every rank of the axis); returns whole rows [..., D],
    the same on every rank of the axis."""
    mesh = bound_mesh(axis_name)
    start = mesh.axis_index(axis_name) * table.shape[0]
    group = mesh.group(axis_name) if mesh.shape[axis_name] > 1 else None
    return _VocabShardedLookup.apply(table, ids, start, group)


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor, mesh,
                             axis: str = "model") -> torch.Tensor:
    """``table`` this rank's block of a table split over ``axis`` of
    ``mesh``, ``ids`` the global ids; returns the rows, whole on every
    rank."""
    with bound_axes(mesh):
        return embedding_lookup_vocab_sharded(table, ids, axis)
