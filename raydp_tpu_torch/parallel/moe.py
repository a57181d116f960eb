"""Expert parallelism over ``torch.distributed``: the counterpart of
``raydp_tpu/parallel/moe.py``, top-k mixture-of-experts with all-to-all
dispatch.

Each rank of the ``ep`` axis hosts ONE expert, and its own shard of the
tokens. A replicated router gives each token its top-k experts (the gates
renormalized for k > 1); capacity ``max(1, ceil(b·k·cf/n))`` slots an
expert are allocated first-choice-first (GShard priority: every first
choice before any second choice), and a (token, choice) pair past its
expert's capacity is dropped and contributes exactly 0. Each rank's
buffers [n, C, D] go to their experts' ranks with a tiled all-to-all
(``all_to_all_single``: chunk e to rank e, received in rank order, as
``lax.all_to_all(tiled=True)``), the expert runs on the [n·C, D] it
received, the inverse all-to-all brings the rows home, and the gate
weights combine them.

Where the JAX package builds one-hot [K, B, N, C] dispatch and combine
tensors and multiplies, this port moves rows by index: the slot of each
kept pair is ``expert · C + position``, the dispatch copies token rows into
their slots (``index_copy``), and the combine gathers each choice's rows,
weights them and sums the choices in order (the same values: each slot
holds one token, and each token's row is the sum of its kept choices). The
slot bookkeeping is integer (a bf16 cumsum would saturate at 256), and the
top-k is a stable descending sort, so that equal gates go to the lower
expert index first, as ``lax.top_k`` does.

Gradients follow shard_map's transposes, as ``parallel/pipeline.py``
states them: each all-to-all's backward is the same all-to-all of the
cotangent (it is a permutation of chunks); the router enters replicated
(``mesh.replicated``), so its gradient is summed over the axis; the aux
scalars are replicated outputs (``pmean`` over the axis) whose cotangent
every rank holds alike, so their backward divides by the axis size and
does not sum. A rank's loss is then its tokens' share of the token terms
plus the aux terms whole: for the JAX package's ``mean(out²) + 0.01·lb``
over B tokens, ``sum(out_r²) / (B·D) + 0.01·lb`` on rank r.

``return_aux`` adds the router's health: ``load_balance_loss`` (Switch
Transformer's ``N · Σ_n f_n · P_n``, f the routed fraction before capacity,
held constant, P the mean gate) and ``drop_fraction``, each averaged over
the axis.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from raydp_tpu_torch.parallel import mesh as _mesh


def _all_to_all(x: torch.Tensor, axis: _mesh.Axis) -> torch.Tensor:
    """Chunk i of ``x`` [n, ...] to rank i; the result's chunk s from rank
    s."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


class _Exchange(torch.autograd.Function):
    """The tiled all-to-all; its transpose is itself."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis), None


def _exchange(x, axis):
    if axis.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Exchange.apply(x, axis)
    return _all_to_all(x, axis)


def _mean_over(x, axis):
    import torch.distributed as dist

    out = x.detach().clone()
    dist.all_reduce(out, group=axis.group)
    return out / axis.size


class _PMean(torch.autograd.Function):
    """The mean over the axis of a scalar every rank computes; the result
    is replicated, so the backward gives each rank the cotangent over n,
    not summed."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.n = axis.size
        return _mean_over(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _pmean(x, axis):
    if axis.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _PMean.apply(x, axis)
    return _mean_over(x, axis)


def top_k_lowest_first(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates of each row, equal gates
    in index order (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, indices = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_apply(
    expert_fn: Callable,
    expert_params: Any,
    router_weights: torch.Tensor,  # [D, N] replicated
    x: torch.Tensor,  # [B_local, D] this rank's tokens
    axis_name: str = "ep",
    capacity_factor: float = 1.25,
    top_k: int = 1,
    return_aux: bool = False,
):
    """On the bound axis ``axis_name``: ``expert_params`` is THIS rank's
    expert, ``expert_fn(expert_params, tokens [R, D]) -> [R, D_out]``.

    Returns the combined output [B_local, D_out]; with ``return_aux=True``
    returns ``(out, {"load_balance_loss", "drop_fraction"})``, the aux
    scalars averaged over the axis (identical on every rank)."""
    axis = _mesh.Axis.of(axis_name)
    n = axis.size
    b, d = x.shape
    k = min(top_k, n)
    # ceil keeps the requested headroom even at small batches; scales with
    # k because every token occupies up to k slots
    capacity = max(1, math.ceil(b * k * capacity_factor / n))

    if n > 1 and torch.is_grad_enabled() and router_weights.requires_grad:
        router_weights = _mesh.replicated(router_weights, axis.group)
    dt = torch.promote_types(x.dtype, router_weights.dtype)
    gates = torch.softmax(x.to(dt) @ router_weights.to(dt), dim=-1)  # [B, N]
    top_vals, top_idx = top_k_lowest_first(gates, k)  # [B, K]
    if k > 1:
        # renormalize the chosen gates (GShard): combine weights sum to 1
        weights = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-30)
    else:
        weights = top_vals

    # choice-major pairs: every first choice before any second choice
    expert = top_idx.T.reshape(-1)  # [K*B]
    one_hot = F.one_hot(expert, n)  # [K*B, N] int64
    pos = (one_hot.cumsum(0) - 1).gather(1, expert[:, None])[:, 0]
    kept = pos < capacity
    slot = expert * capacity + pos
    token = torch.arange(b, device=x.device).repeat(k)

    buffers = x.new_zeros(n * capacity, d).index_copy(
        0, slot[kept], x[token[kept]])
    received = _exchange(buffers.view(n, capacity, d), axis)
    expert_out = expert_fn(expert_params, received.reshape(n * capacity, d))
    d_out = expert_out.shape[-1]
    returned = _exchange(expert_out.reshape(n, capacity, d_out), axis)
    returned = returned.reshape(n * capacity, d_out)

    w = weights.T.reshape(-1).to(x.dtype)  # choice-major, as ``expert``
    out = None
    for c in range(k):
        live = kept[c * b:(c + 1) * b]
        tok = token[:b][live]
        rows = returned[slot[c * b:(c + 1) * b][live]] * w[c * b:(c + 1) * b][live, None]
        part = rows.new_zeros(b, d_out).index_copy(0, tok, rows)
        out = part if out is None else out + part
    if not return_aux:
        return out

    # Switch-Transformer load balancing: f is the ROUTED fraction (before
    # capacity) and constant; the gradient flows through the mean gate
    f = one_hot.to(torch.float32).mean(0)  # [N]
    p = gates.mean(0)  # [N]
    dropped = 1.0 - kept.sum().to(torch.float32) / (b * k)
    aux = {
        "load_balance_loss": _pmean(n * torch.sum(f * p), axis),
        "drop_fraction": _pmean(dropped, axis),
    }
    return out, aux


def moe_sharded(
    expert_fn: Callable,
    expert_params: Any,
    router_weights: torch.Tensor,
    x: torch.Tensor,
    mesh,
    axis: str = "ep",
    capacity_factor: float = 1.25,
    top_k: int = 1,
    return_aux: bool = False,
):
    """``moe_apply`` with ``mesh``'s axes bound: each rank passes its own
    expert and its shard of the tokens (the rows ``r·B/n`` to
    ``(r+1)·B/n`` of a batch sharded over ``axis``) and gets its shard of
    the output, as ``ring_attention_sharded`` takes local blocks."""
    with _mesh.bound_axes(mesh):
        return moe_apply(expert_fn, expert_params, router_weights, x,
                         axis_name=axis, capacity_factor=capacity_factor,
                         top_k=top_k, return_aux=return_aux)
