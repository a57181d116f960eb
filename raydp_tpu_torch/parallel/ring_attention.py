"""Sequence-parallel attention over ``torch.distributed``: the counterpart
of ``raydp_tpu/parallel/ring_attention.py``.

The sequence is sharded over a mesh axis (``parallel/mesh.py``); each rank
holds a Q/K/V block of ``T_local`` rows. **Ring attention** rotates the
K/V blocks around the axis's group (``dist.batch_isend_irecv`` to rank
``(r + 1) % W`` and from ``(r - 1) % W``, the reference's ``ppermute``)
while every rank accumulates its Q block's attention with the online-softmax
merge of (o, m, l); after ``W`` blocks every row has attended to the whole
sequence. Causal masking uses the blocks' global offsets: a block from a
later rank is wholly masked (its step still runs, as in the reference).

The backward is a second ring pass (``_RingAttention.backward``): each
rank rebuilds its probabilities against every K/V block from the saved
GLOBAL logsumexp and ``dsum = rowsum(g * o)`` of the global o, and the
dk/dv accumulators rotate together with their K/V blocks, home after a
full cycle. Nothing of size [T, T] is kept.

``use_flash=True`` computes each block product with the port's flash
kernels: the forward with ``flash_attention_stats`` (K2's stats surface,
unnormalized o with m and l, at the blocks' global offsets), the backward
with ``flash_backward_blocks`` (K3a/K3b) from the global lse and dsum. On
CPU tensors both take their plain versions.

**Ulysses attention** swaps the sharded dimension from sequence to heads
with a tiled all-to-all (``dist.all_to_all_single`` on contiguous chunks),
attends on the whole sequence for ``H / W`` heads (plainly, or with
``flash_attention`` for ``use_flash``), and swaps back. The two swaps are
each other's transpose, which is their backward.

The group, this rank's index and the axis size are read where a layer is
called (from the axis bound by ``sequence_parallel_apply`` or
``ring_attention_sharded``) and kept for the backward.
"""

from __future__ import annotations

import torch

from raydp_tpu_torch.ops import _flops
from raydp_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_stats,
    flash_backward_blocks,
)
from raydp_tpu_torch.parallel import mesh as _mesh


def _block_attn(q, k, v, mask):
    """Scores for one (Q-block, K-block) pair and its masked online-softmax
    stats, in f32. q [B, H, Tq, D], k/v [B, H, Tk, D], mask [Tq, Tk] bool
    (True = keep). Returns (o unnormalized, m row max, l row denominator);
    a row with no live key gets m NEG_INF, l 0, o 0."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)  # noqa: E741 - flash-attention notation
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    m = torch.where(mask.any(dim=-1), m, torch.full_like(m, NEG_INF))
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Combine two online-softmax partials (the flash merge)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2  # noqa: E741
    return o, m, l


def _causal_mask(t, tk, q_off, k_off, causal, device):
    if not causal:
        return torch.ones((t, tk), dtype=torch.bool, device=device)
    gq = q_off + torch.arange(t, device=device)
    gk = k_off + torch.arange(tk, device=device)
    return gq[:, None] >= gk[None, :]


def _ring_forward_stats(q, k, v, axis: _mesh.Axis, causal, use_flash):
    """Ring forward returning (o unnormalized f32, m, l)."""
    n, me = axis.size, axis.index
    t, tk = q.shape[2], k.shape[2]

    def block_product(k_cur, v_cur, s):
        """(o, m, l) of q against the K/V block that started on rank
        (me - s) mod n."""
        src = (me - s) % n
        if use_flash:
            return flash_attention_stats(q, k_cur, v_cur, me * t, src * tk, causal)
        mask = _causal_mask(t, tk, me * t, src * tk, causal, q.device)
        return _block_attn(q, k_cur, v_cur, mask)

    o, m, l = block_product(k, v, 0)  # noqa: E741 - the local block, no communication
    k_cur, v_cur = k, v
    for s in range(1, n):
        # rotate FIRST, then attend: no dead rotation after the last use
        k_cur, v_cur = axis.rotate((k_cur, v_cur))
        o, m, l = _merge(o, m, l, *block_product(k_cur, v_cur, s))  # noqa: E741
    return o, m, l


def _block_grads(q, k, v, lse, dsum, g, q_off, k_off, causal, use_flash):
    """(dq, dk, dv) partials of the local Q block against ONE K/V block,
    from the GLOBAL logsumexp and dsum."""
    if use_flash:
        return flash_backward_blocks(q, k, v, lse, dsum, g, q_off, k_off, causal)
    scale = q.shape[-1] ** -0.5
    t, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(t, tk, q_off, k_off, True, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])  # masked pairs underflow to exactly 0
    gf = g.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    ds = p * (dp - dsum[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The reference's custom VJP (``_ring_fwd`` / ``_ring_bwd``): the
    forward saves (q, k, v, o, lse); the backward runs the second ring."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, use_flash):
        o, m, l = _ring_forward_stats(q, k, v, axis, causal, use_flash)  # noqa: E741
        l = torch.clamp(l, min=1e-30)  # noqa: E741
        out = (o / l[..., None]).to(q.dtype)
        lse = m + torch.log(l)  # [B, H, T] global logsumexp
        ctx.axis, ctx.causal, ctx.use_flash = axis, causal, use_flash
        # the backward runs on autograd's thread: it reports its launches'
        # FLOPs to the count (if any) that this forward ran under
        ctx.flops_tally = _flops.current_tally()
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        axis = ctx.axis
        n, me = axis.size, axis.index
        t, tk = q.shape[2], k.shape[2]
        g = g.to(q.dtype).contiguous()
        dsum = (g.float() * out.float()).sum(dim=-1)  # [B, H, T]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        with _flops.reporting_to(ctx.flops_tally):
            for s in range(n):
                src = (me - s) % n  # origin of the block held now
                dq_p, dk_p, dv_p = _block_grads(
                    q, k_cur, v_cur, lse, dsum, g, me * t, src * tk,
                    ctx.causal, ctx.use_flash)
                dq += dq_p.float()
                dk += dk_p.float()
                dv += dv_p.float()
                # the block and its gradient accumulators rotate together;
                # after the last step only the accumulators need to go home
                if s < n - 1:
                    k_cur, v_cur, dk, dv = axis.rotate((k_cur, v_cur, dk, dv))
                else:
                    dk, dv = axis.rotate((dk, dv))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   use_flash: bool = False) -> torch.Tensor:
    """Exact attention with the sequence sharded over the bound axis
    ``axis_name``. Shapes are per rank: q, k, v [B, H, T_local, D]; the
    global sequence is ``T_local * W`` in rank order. Returns [B, H,
    T_local, D] in q's type, differentiable in q, k and v (the second ring
    pass). ``use_flash`` takes the flash kernels for each block product."""
    axis = _mesh.Axis.of(axis_name)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, axis, bool(causal), bool(use_flash))
    o, m, l = _ring_forward_stats(q, k, v, axis, causal, use_flash)  # noqa: E741
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                           use_flash: bool = False) -> torch.Tensor:
    """``ring_attention`` on this rank's shards with ``mesh``'s axes bound:
    q, k, v are the local [B, H, T_local, D] blocks of sequences sharded
    over ``axis``; returns the local block of the output."""
    with _mesh.bound_axes(mesh):
        return ring_attention(q, k, v, axis, causal, use_flash)


def _seq_to_heads(x, axis: _mesh.Axis):
    """[B, H, T_local, D] -> [B, H/W, T_global, D]: head group j goes to
    rank j, and the sequence shards arrive in rank order."""
    import torch.distributed as dist

    b, h, t, d = x.shape
    n = axis.size
    send = x.reshape(b, n, h // n, t, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * t, d)


def _heads_to_seq(x, axis: _mesh.Axis):
    """[B, H/W, T_global, D] -> [B, H, T_local, D]: the inverse swap."""
    import torch.distributed as dist

    b, hn, tg, d = x.shape
    n = axis.size
    send = x.reshape(b, hn, n, tg // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return recv.transpose(0, 1).reshape(b, n * hn, tg // n, d)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all of the reference's ``lax.all_to_all``; each
    direction's backward is the other direction."""

    @staticmethod
    def forward(ctx, x, axis, to_heads):
        ctx.axis, ctx.to_heads = axis, to_heads
        return _seq_to_heads(x, axis) if to_heads else _heads_to_seq(x, axis)

    @staticmethod
    def backward(ctx, g):
        swap = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return swap(g.contiguous(), ctx.axis), None, None


def ulysses_attention(q, k, v, axis_name: str, causal: bool = False,
                      use_flash: bool = False) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism over the bound axis
    ``axis_name``: all-to-all from sequence to heads, attention on whole
    sequences for H/W heads, all-to-all back. Per-rank shapes [B, H,
    T_local, D]; H must divide by the axis size. ``use_flash`` attends
    with ``flash_attention`` (the flash forward and backward kernels)."""
    axis = _mesh.Axis.of(axis_name)
    h = q.shape[1]
    if h % axis.size:
        raise ValueError(f"heads {h} not divisible by sequence axis {axis.size}")
    qg, kg, vg = (_AllToAll.apply(x, axis, True) for x in (q, k, v))
    if use_flash:
        og = flash_attention(qg, kg, vg, causal)
    else:
        og = full_attention(qg, kg, vg, causal)
    return _AllToAll.apply(og, axis, False)


def full_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Reference attention (``attn_impl="full"`` and the tests' oracle):
    q [B, H, Tq, D], k/v [B, H, Tk, D] -> [B, H, Tq, D] in q's type. Scores
    and softmax are taken in f32 whatever the input type, as the flash
    kernels accumulate."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = scores.shape[-2:]
        dev = scores.device
        mask = torch.arange(tq, device=dev)[:, None] >= torch.arange(tk, device=dev)[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
