"""Flash attention: the counterpart of ``raydp_tpu/ops/flash_attention.py``.

Blockwise attention with an online softmax: a running row max ``m``, a
denominator ``l`` and an f32 accumulator ``o``, updated one k-tile at a
time, so the [T, T] score matrix never exists, in either direction. One
kernel family serves the surfaces of decode serving and training:

- ``flash_attention_call``: the ``_flash_call`` contract -- (o, m, l) with
  caller offsets for the causal mask, normalized or not, through the
  one-pass body or the two-term body (``onepass``);
  ``flash_attention_stats`` (unnormalized, the per-step block product a
  ring merge consumes) sits on top of it.
- ``flash_attention``: normalized, offsets 0, differentiable. Its backward
  is ``flash_backward_blocks`` from the saved output and row logsumexp
  (FlashAttention-2), so training memory is O(T) too.
- ``flash_backward_blocks``: (dq, dk, dv) of one block pair given the
  global logsumexp and ``dsum = rowsum(do * o)``, with offsets for the
  causal mask -- the per-step backward a ring schedule sums.
- ``flash_decode``: the newest ``Tq`` query rows of each sequence against a
  KV cache with per-sequence valid lengths, from an f32/bf16 cache or an
  int8 cache with per-row scales dequantized in the kernel.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/flash_attention.cu``, ``csrc/flash_backward.cu``) or raises; on a
CPU tensor it runs the plain PyTorch version beside it (``*_plain``), which
does the same blockwise update over the same tile partition. Masking uses
``NEG_INF = -1e30``, never -inf; the forward zeroes ``p`` where the score is
at or below ``NEG_INF / 2``, so a fully masked row gives o = 0,
m = NEG_INF, l = 0 and no NaN, and the backward's ``p`` is exactly 0 at
every masked pair.

``flash_attention_call``, ``flash_attention_stats`` and ``flash_decode``
have no backward, as in the JAX package: they raise when grad mode is on
and an input requires a gradient.

``LAUNCHES`` counts kernel launches per kernel name; the plain versions do
not count.
"""

from __future__ import annotations

import os

import torch

from raydp_tpu_torch.ops import _build

NEG_INF = -1e30

# The kernels' tiling (csrc/flash_attention.cu kBlockK / kFwdWarps): 32 keys
# per k-tile, one per lane of a warp; 16 query rows per prefill block. The
# decode == prefill bit contract rests on both kernels sharing the k-tile.
BLOCK_K = 32
BLOCK_Q = 16
KERNEL_HEAD_DIMS = (64, 128)

LAUNCHES = {
    "flash_fwd": 0, "flash_fwd_twoterm": 0, "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0, "flash_decode": 0, "flash_decode_int8": 0,
}

_DTYPE_CODES = {
    torch.float32: _build.DTYPE_F32,
    torch.bfloat16: _build.DTYPE_BF16,
    torch.int8: _build.DTYPE_I8,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_onepass_default() -> bool:
    """Whether ``flash_attention_call`` takes the one-pass body when its
    ``onepass`` is None: ``RAYDP_TPU_FLASH_ONEPASS=0`` (or false/off) pins
    the two-term body, as in the JAX package. The two are bit-identical by
    design."""
    return os.environ.get("RAYDP_TPU_FLASH_ONEPASS", "1").lower() not in (
        "0", "false", "off"
    )


def pick_blocks(t_q: int, t_k: int, head_dim: int | None = None) -> tuple:
    """(block_q, block_k) of the port's kernels for these lengths.

    The counterpart of the JAX package's ``pick_blocks``, whose sizes are
    set by the TPU's vector memory. On Hopper they are set by the warp: the
    k-tile is one key per lane (32), whatever the lengths (a ragged last
    tile is masked), and a prefill block holds 16 query rows, one warp each.
    ``head_dim`` does not change them on this card."""
    del t_k, head_dim
    return min(BLOCK_Q, t_q), BLOCK_K


# ---------------------------------------------------------------------------
# plain versions: the same blockwise update in PyTorch ops
# ---------------------------------------------------------------------------


def _online_update(s, v, o, m, l, onepass: bool = True):  # noqa: E741
    """One k-tile of the update: scores ``s`` [..., Tq, BK] (masked to
    NEG_INF), values ``v`` [..., BK, D] f32; running o [..., Tq, D], m and l
    [..., Tq, 1]. One-pass: (l, o) are rescaled only for rows whose max
    moved. Two-term (``onepass=False``): always, by alpha = exp(0) = 1 where
    the max did not move, which leaves the same bits."""
    block_max = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, block_max)
    p = torch.exp(s - m_new)
    p = torch.where(s > NEG_INF / 2, p, torch.zeros_like(p))
    p_sum = p.sum(dim=-1, keepdim=True)
    pv = p @ v
    alpha = torch.exp(m - m_new)
    if not onepass:
        return alpha * o + pv, m_new, alpha * l + p_sum
    moved = block_max > m
    l = torch.where(moved, alpha * l + p_sum, l + p_sum)  # noqa: E741
    o = torch.where(moved, alpha * o + pv, o + pv)
    return o, m_new, l


def flash_attention_call_plain(
    q, k, v, q_offset: int = 0, k_offset: int = 0, causal: bool = False,
    normalize: bool = True, onepass: bool = True,
):
    """Plain PyTorch version of ``flash_attention_call``; ``onepass=False``
    is the two-term body."""
    b, h, t, d = q.shape
    tk = k.shape[2]
    _, block_k = pick_blocks(t, tk, d)
    scale = d**-0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = q.device
    q_pos = q_offset + torch.arange(t, device=dev)[:, None]
    o = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=dev)  # noqa: E741
    k_end = tk
    if causal:  # keys past the last query position are dead for every row
        k_end = max(0, min(tk, q_offset + t - k_offset))
    for k0 in range(0, k_end, block_k):
        k1 = min(k0 + block_k, tk)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            k_pos = k_offset + torch.arange(k0, k1, device=dev)[None, :]
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
        o, m, l = _online_update(  # noqa: E741
            s, vf[:, :, k0:k1], o, m, l, onepass)
    if normalize:
        o = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    return o, m[..., 0], l[..., 0]


def flash_decode_plain(q, k, v, kv_len, k_scale=None, v_scale=None):
    """Plain PyTorch version of ``flash_decode``."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _, block_k = pick_blocks(tq, tk, d)
    scale = d**-0.5
    dev = q.device
    lens = torch.as_tensor(kv_len, device=dev).to(torch.int64).reshape(b)
    valid = torch.clamp(lens, max=tk)
    q_pos = lens[:, None] - tq + torch.arange(tq, device=dev)[None, :]
    qf = q.float()
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, tq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=dev)  # noqa: E741
    for k0 in range(0, int(valid.max()), block_k):
        k1 = min(k0 + block_k, tk)
        kt = k[:, :, k0:k1].float()
        vt = v[:, :, k0:k1].float()
        if k_scale is not None:
            kt = kt * k_scale[:, :, k0:k1, None].float()
            vt = vt * v_scale[:, :, k0:k1, None].float()
        k_pos = torch.arange(k0, k1, device=dev)
        row_ok = (k_pos[None, :] < valid[:, None])[:, None, :, None]  # [b,1,bk,1]
        # rows past kv_len hold stale values: zero them, as the kernel does
        kt = torch.where(row_ok, kt, torch.zeros_like(kt))
        vt = torch.where(row_ok, vt, torch.zeros_like(vt))
        s = (qf @ kt.transpose(-1, -2)) * scale  # [b, h, tq, bk]
        live = row_ok[:, :, :, 0][:, :, None, :] & (
            q_pos[:, None, :, None] >= k_pos[None, None, None, :]
        )
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        o, m, l = _online_update(s, vt, o, m, l)  # noqa: E741
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def _bwd_probs(s, lse, q_pos, k_pos, causal: bool):
    """p = exp(s - lse), exactly 0 where the pair is masked."""
    p = torch.exp(s - lse)
    if causal:
        p = torch.where(q_pos >= k_pos, p, torch.zeros_like(p))
    return p


def _bwd_inputs(q, k, v, lse, dsum, g, q_offset):
    dev = q.device
    q_pos = q_offset + torch.arange(q.shape[2], device=dev)[:, None]
    return (q.float(), k.float(), v.float(), g.float(),
            lse.float()[..., None], dsum.float()[..., None], q_pos,
            q.shape[-1] ** -0.5)


def flash_bwd_dq_plain(q, k, v, lse, dsum, g, q_offset: int = 0,
                       k_offset: int = 0, causal: bool = False):
    """Plain PyTorch version of ``flash_bwd_dq``: dq over the forward's
    k-tiles, in q's type."""
    qf, kf, vf, gf, lse_c, dsum_c, q_pos, scale = _bwd_inputs(
        q, k, v, lse, dsum, g, q_offset)
    tk = k.shape[2]
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    k_end = tk
    if causal:  # keys past the last query position are dead for every row
        k_end = max(0, min(tk, q_offset + q.shape[2] - k_offset))
    for k0 in range(0, k_end, BLOCK_K):
        k1 = min(k0 + BLOCK_K, tk)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = (qf @ kt.transpose(-1, -2)) * scale
        k_pos = k_offset + torch.arange(k0, k1, device=q.device)[None, :]
        p = _bwd_probs(s, lse_c, q_pos, k_pos, causal)
        ds = p * (gf @ vt.transpose(-1, -2) - dsum_c) * scale
        dq = dq + ds @ kt
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, lse, dsum, g, q_offset: int = 0,
                        k_offset: int = 0, causal: bool = False):
    """Plain PyTorch version of ``flash_bwd_dkv``: (dk, dv) over q-tiles of
    ``BLOCK_K`` queries, in k's and v's types."""
    qf, kf, vf, gf, lse_c, dsum_c, q_pos, scale = _bwd_inputs(
        q, k, v, lse, dsum, g, q_offset)
    t = q.shape[2]
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    k_pos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
    q_begin = 0
    if causal:  # q-tiles wholly before the first key see no key at all
        q_begin = min(t, max(0, k_offset - q_offset)) // BLOCK_K * BLOCK_K
    for q0 in range(q_begin, t, BLOCK_K):
        q1 = min(q0 + BLOCK_K, t)
        qt, gt = qf[:, :, q0:q1], gf[:, :, q0:q1]
        s = (qt @ kf.transpose(-1, -2)) * scale  # [..., BQ, Tk]
        p = _bwd_probs(s, lse_c[:, :, q0:q1], q_pos[q0:q1], k_pos, causal)
        dv = dv + p.transpose(-1, -2) @ gt
        ds = p * (gt @ vf.transpose(-1, -2) - dsum_c[:, :, q0:q1]) * scale
        dk = dk + ds.transpose(-1, -2) @ qt
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_blocks_plain(q, k, v, lse, dsum, g, q_offset: int = 0,
                                k_offset: int = 0, causal: bool = False):
    """Plain PyTorch version of ``flash_backward_blocks``."""
    dq = flash_bwd_dq_plain(q, k, v, lse, dsum, g, q_offset, k_offset, causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, lse, dsum, g, q_offset, k_offset,
                                 causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check_head_dim(d: int, what: str) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{what}: head_dim {d} has no CUDA kernel (built for "
            f"{KERNEL_HEAD_DIMS})"
        )


def _refuse_grad(what: str, *tensors) -> None:
    """Surfaces without a backward raise rather than return a tensor that
    silently cuts the graph."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{what} has no backward; use flash_attention for gradients, or "
            "call it under torch.no_grad()"
        )


def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise TypeError(f"q/k/v must share f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_call(
    q, k, v, q_offset: int = 0, k_offset: int = 0, causal: bool = False,
    normalize: bool = True, onepass: bool | None = None,
):
    """Blockwise attention returning (o, m, l).

    q [B, H, T, D], k/v [B, H, Tk, D], f32 or bf16 (one type for all three).
    ``q_offset``/``k_offset`` are the blocks' global positions for the
    causal mask (key kept where k_pos <= q_pos). o is [B, H, T, D] in q's
    type when ``normalize``, else unnormalized f32; m and l are [B, H, T]
    f32 -- the row max of the scaled scores and the softmax denominator.
    ``onepass`` picks the one-pass body (``flash_fwd``) or the two-term
    body (``flash_fwd_twoterm``); None reads ``use_onepass_default()``."""
    _check_qkv(q, k, v)
    _refuse_grad("flash_attention_call", q, k, v)
    if onepass is None:
        onepass = use_onepass_default()
    q_offset, k_offset = int(q_offset), int(k_offset)
    if _on_cpu(q, k, v):
        return flash_attention_call_plain(
            q, k, v, q_offset, k_offset, causal, normalize, onepass
        )
    b, h, t, d = q.shape
    tk = k.shape[2]
    name = "flash_fwd" if onepass else "flash_fwd_twoterm"
    _check_head_dim(d, name)
    lib = _build.load()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty(
        (b, h, t, d), dtype=q.dtype if normalize else torch.float32,
        device=q.device,
    )
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, t), dtype=torch.float32, device=q.device)  # noqa: E741
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), b * h, t, tk, d, _DTYPE_CODES[q.dtype],
            q_offset, k_offset, int(causal), int(normalize),
            int(not normalize), int(onepass), d**-0.5, stream,
        )
    _build.check(code, name)
    LAUNCHES[name] += 1
    return o, m, l


def _check_bwd(q, k, v, lse, dsum, g) -> None:
    _check_qkv(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or dsum.shape != q.shape[:3]:
        raise ValueError(f"lse {tuple(lse.shape)} and dsum "
                         f"{tuple(dsum.shape)} must be [B, H, T]")


def _bwd_launch(entry, name, q, k, v, lse, dsum, g, q_offset, k_offset,
                causal, outs):
    """Launch one backward kernel writing ``outs`` (fresh tensors)."""
    b, h, t, d = q.shape
    _check_head_dim(d, name)
    lib = _build.load()
    q, k, v, g = (x.contiguous() for x in (q, k, v, g))
    lse = lse.float().contiguous()
    dsum = dsum.float().contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), *(o.data_ptr() for o in outs),
            b * h, t, k.shape[2], d, _DTYPE_CODES[q.dtype], int(q_offset),
            int(k_offset), int(causal), d**-0.5, stream,
        )
    _build.check(code, name)
    LAUNCHES[name] += 1


def flash_bwd_dq(q, k, v, lse, dsum, g, q_offset: int = 0, k_offset: int = 0,
                 causal: bool = False):
    """dq of one block pair (see ``flash_backward_blocks``), in q's type."""
    _check_bwd(q, k, v, lse, dsum, g)
    if _on_cpu(q, k, v, lse, dsum, g):
        return flash_bwd_dq_plain(q, k, v, lse, dsum, g, int(q_offset),
                                  int(k_offset), causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("rtt_flash_bwd_dq", "flash_bwd_dq", q, k, v, lse, dsum, g,
                q_offset, k_offset, causal, (dq,))
    return dq


def flash_bwd_dkv(q, k, v, lse, dsum, g, q_offset: int = 0, k_offset: int = 0,
                  causal: bool = False):
    """(dk, dv) of one block pair (see ``flash_backward_blocks``), in k's and
    v's types."""
    _check_bwd(q, k, v, lse, dsum, g)
    if _on_cpu(q, k, v, lse, dsum, g):
        return flash_bwd_dkv_plain(q, k, v, lse, dsum, g, int(q_offset),
                                   int(k_offset), causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("rtt_flash_bwd_dkv", "flash_bwd_dkv", q, k, v, lse, dsum, g,
                q_offset, k_offset, causal, (dk, dv))
    return dk, dv


def flash_backward_blocks(q, k, v, lse, dsum, g, q_offset: int = 0,
                          k_offset: int = 0, causal: bool = False):
    """One blockwise-backward pass: (dq, dk, dv) of q [B, H, Tq, D] against
    k/v [B, H, Tk, D] in the inputs' types, given the GLOBAL per-row
    logsumexp ``lse`` and ``dsum = rowsum(g * o)`` [B, H, Tq] f32, the
    cotangent ``g`` of o (q's shape and type) and the blocks' global
    positions for the causal mask. Two kernels, ``flash_bwd_dq`` and
    ``flash_bwd_dkv``, each output owned by one warp: no atomics, the same
    bits on every run.

    A pair is masked where k_pos > q_pos, and its p is exactly 0. Where a row
    has no live key in the ``lse`` it was given (lse = NEG_INF), its
    gradients are 0 (the JAX kernel's exp(0) = 1 gives nonzero ones)."""
    dq = flash_bwd_dq(q, k, v, lse, dsum, g, q_offset, k_offset, causal)
    dk, dv = flash_bwd_dkv(q, k, v, lse, dsum, g, q_offset, k_offset, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX ``flash_attention``: the forward saves only
    (q, k, v, o, lse), O(T) memory; the backward is the blockwise
    ``flash_backward_blocks``. One Function for both devices: on CPU tensors
    both directions take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, m, l = flash_attention_call(q, k, v, 0, 0, causal, normalize=True)  # noqa: E741
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        dsum = (g.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_backward_blocks(q, k, v, lse, dsum, g, 0, 0,
                                           ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Fused attention: q, k, v [B, H, T, D] -> [B, H, T, D] in q's type,
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, bool(causal))


def flash_attention_stats(q, k, v, q_offset, k_offset, causal: bool = False):
    """One blockwise pass returning (o_unnormalized f32, m, l) with the
    caller's global offsets: merge passes with the flash merge and divide
    by l at the end. No backward (as in the JAX package)."""
    _refuse_grad("flash_attention_stats", q, k, v)
    return flash_attention_call(
        q, k, v, q_offset, k_offset, causal, normalize=False
    )


def flash_decode(q, k, v, kv_len, k_scale=None, v_scale=None):
    """Decode attention: the newest ``Tq`` query rows of each sequence
    against a KV cache with per-sequence valid lengths.

    q: [B, H, Tq, D] f32 or bf16 -- queries for the newest Tq positions.
    k, v: [B, H, Tk, D] cache at capacity Tk: f32 or bf16, or int8 with
        ``k_scale``/``v_scale`` [B, H, Tk] f32 per-row scales from
        ``ops.quantization.quantize_int8``.
    kv_len: [B] int -- valid lengths INCLUDING the Tq new positions.

    Returns [B, H, Tq, D] in q's type. Query row r sits at position
    kv_len - Tq + r and attends keys at positions <= its own and < kv_len;
    cache rows at or past kv_len are never read. No backward (as in the JAX
    package)."""
    _refuse_grad("flash_decode", q, k, v, k_scale, v_scale)
    int8_kv = k_scale is not None
    if int8_kv != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be provided together")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    if int8_kv:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError("k_scale/v_scale need int8 k and v")
        if k_scale.shape != (b, h, tk) or v_scale.shape != (b, h, tk):
            raise ValueError("scales must be [B, H, Tk]")
    elif k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"cache must be f32 or bf16 (or int8 with scales), "
                        f"got {k.dtype}, {v.dtype}")
    scales = (k_scale, v_scale) if int8_kv else ()
    kv_len = torch.as_tensor(kv_len, device=q.device)
    if kv_len.shape != (b,):
        raise ValueError(f"kv_len must be [B] = [{b}], got {tuple(kv_len.shape)}")
    if _on_cpu(q, k, v, kv_len, *scales):
        return flash_decode_plain(q, k, v, kv_len, k_scale, v_scale)
    _check_head_dim(d, "flash_decode")
    lib = _build.load()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    if int8_kv:
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    else:
        ks_ptr = vs_ptr = None
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rtt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ks_ptr, vs_ptr,
            lens.data_ptr(), o.data_ptr(), b, h, tq, tk, d,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], d**-0.5, stream,
        )
    name = "flash_decode_int8" if int8_kv else "flash_decode"
    _build.check(code, name)
    LAUNCHES[name] += 1
    return o
