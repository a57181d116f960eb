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
  int8 cache with per-row scales dequantized in the kernel. Both kernels
  are split over the cache. The f32/bf16 cache's (``csrc/flash_decode.cu``,
  two launches a call) keeps the sequential update's bits: each 32-key
  tile's scores and max, then its p and p.v against the row max so far,
  in parallel, then the tiles merged in order by the last block of each
  sequence and head. The int8 cache's (``csrc/flash_decode_int8.cu``:
  blocks of ``DECODE_CHUNK`` keys, their partial (m, l, o) merged in chunk
  order) sums in another order than the plain version's 32-key tiles:
  within 1e-5 in f32.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/flash_attention.cu``, ``csrc/flash_forward_sm90.cu``,
``csrc/flash_backward.cu``, ``csrc/flash_backward_sm90.cu``,
``csrc/flash_decode.cu``, ``csrc/flash_decode_int8.cu``) or raises; on
a CPU tensor it runs the plain PyTorch version beside it (``*_plain``),
which does the same blockwise update. The forward and the backward each
have two bodies: f32 q/k/v take the CUDA-core kernels over the plain
versions' 32-key tiles; bf16 q/k/v take the tensor-core kernels
(``wgmma``, tiles through TMA). The bf16 forward rounds p to bf16 before
p @ v, as the TPU's matrix unit does; the bf16 backward rounds p before
dv's product and ds before dk's and dq's (the reference feeds both in
f32). So bf16 agrees with the plain versions to bf16 rounding, not bit for
bit.

Head dims: every family takes any D from 1 up on the card. Kernels are
built for 8, 16, 32, 64, 128 and 256 (``KERNEL_HEAD_DIMS``); any other D
runs at the next built width (``kernel_head_dim``), q, k, v (and the
cotangent) zero-padded to it (``pad_head``), the scale that of the true D,
the output cut back to D. A zero column adds an exact 0 to each score's
sum and an output column of zeros, which is cut off. At D 256 (bench.py's
LM at d_model 2048 over 8 heads) each family keeps its design with tiles
cut to fit a block's shared memory and registers: see each source's notes.
Past 256 (bench.py's LM at d_model 4096: 8 heads of 512) every family --
the f32 and bf16 forward, the f32 and bf16 backward and both decodes --
runs D zero-padded to a multiple of ``HEAD_CHUNK`` through chunked bodies:
a grid axis over the output's (the gradient's) 256-column chunks, two a
block in the f32 forward and backward and one in the others, each block
summing its scores (and the backward's dp) over all of D (one chain
per score in f32, so f32 decode == prefill holds) and computing its own
columns of o, dq, or dk and dv.

Decode == prefill: for f32 q/k/v the decode kernel and the forward run the
same steps of the per-row update over the same 32-key tiles, merged in
tile order, so a decode row equals the prefill row at its position bit for
bit. For bf16 q/k/v the prefill row
comes from the tensor-core kernel and is within bf16 rounding of the
decode row, not bitwise. Masking uses
``NEG_INF = -1e30``, never -inf; the forward zeroes ``p`` where the score is
at or below ``NEG_INF / 2``, so a fully masked row gives o = 0,
m = NEG_INF, l = 0 and no NaN, and the backward's ``p`` is exactly 0 at
every masked pair.

``flash_attention_call``, ``flash_attention_stats`` and ``flash_decode``
have no backward, as in the JAX package: they raise when grad mode is on
and an input requires a gradient.

``LAUNCHES`` counts kernel launches per kernel name (``flash_fwd`` the
one-pass body on the tensor cores, ``flash_fwd_f32`` the one on the CUDA
cores; ``flash_decode`` counts calls: two launches each, scores then p.v
and the merge); the plain
versions do not count. Each launch also reports its FLOPs to
``ops._flops`` while a count is armed (``obs.costmodel.count_flops``).
"""

from __future__ import annotations

import os

import torch

from raydp_tpu_torch.ops import _build, _flops

NEG_INF = -1e30

# The plain versions' tiling, which is also the CUDA-core kernels'
# (csrc/flash_common.cuh kBlockK, csrc/flash_attention.cu kRows): 32
# keys per k-tile, the width of a warp; 64 query rows per f32 prefill
# block. The f32 decode == prefill bit contract rests on both kernels
# sharing the k-tile. The bf16
# forward's tile (128 queries x 128 keys, 64 keys at D 256) lives in
# csrc/flash_forward_sm90.cu (kM, kN).
BLOCK_K = 32
BLOCK_Q = 64
# The head dims every attention kernel family is built for (the `case`s of
# each C entry in csrc/): 8, 16 and 32 (the small LMs' heads), 64, 128 and
# 256 (bench.py's LM at d_model 2048, 8 heads; Gemma's heads). The bf16
# forward and backward run 8, 16 and 32 through their D 64 bodies, their
# tensor maps reading the true columns and zero-filling the rest. Any other
# head dim up to 256 runs at the next built width (``kernel_head_dim``), q,
# k and v zero-padded to it by the wrapper (``pad_head``) and the output cut
# back; past 256, the next multiple of HEAD_CHUNK.
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
# Past the widest built width every family (forward, backward, decodes)
# takes D in column chunks of this width (csrc/flash_common.cuh
# kHeadChunk), D zero-padded to a multiple of it: the chunked bodies are the
# D 256 bodies' layouts or tiles, and the blocks of a row block recompute
# the scores D / 256 times (one 256-column chunk a block; the f32 forward
# and backward take two, ceil(D / 512) times) where chunks of 128 would D / 128 times.
HEAD_CHUNK = 256
# keys per block of the int8-cache decode kernel (csrc/flash_decode_int8.cu
# kChunk; the C entry refuses any other value): its workspace holds one
# partial (m, l, o) per chunk
DECODE_CHUNK = 128

LAUNCHES = {
    "flash_fwd": 0, "flash_fwd_f32": 0, "flash_fwd_twoterm": 0,
    "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_decode": 0,
    "flash_decode_int8": 0,
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
    """(block_q, block_k) of the plain versions and the CUDA-core kernels
    for these lengths.

    The counterpart of the JAX package's ``pick_blocks``, whose sizes are
    set by the TPU's vector memory. On Hopper's CUDA cores they are set by
    the warp: the k-tile is 32 keys, whatever the lengths (a ragged last
    tile is masked), and an f32 prefill block holds 64 query rows, register
    tiles of 256 threads. ``head_dim`` does not change them on this card.
    The bf16 forward on tensor cores tiles 128 x 128 (128 x 64 at D 256)
    in its CUDA source."""
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
    normalize: bool = True, onepass: bool = True, scale: float | None = None,
):
    """Plain PyTorch version of ``flash_attention_call``; ``onepass=False``
    is the two-term body. ``scale`` multiplies the scores (default
    ``D**-0.5`` of q's head dim)."""
    b, h, t, d = q.shape
    tk = k.shape[2]
    _, block_k = pick_blocks(t, tk, d)
    scale = d**-0.5 if scale is None else scale
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


def flash_decode_plain(q, k, v, kv_len, k_scale=None, v_scale=None,
                       scale: float | None = None):
    """Plain PyTorch version of ``flash_decode`` (``scale`` as in
    ``flash_attention_call_plain``)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _, block_k = pick_blocks(tq, tk, d)
    scale = d**-0.5 if scale is None else scale
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


def _bwd_inputs(q, k, v, lse, dsum, g, q_offset, scale):
    dev = q.device
    q_pos = q_offset + torch.arange(q.shape[2], device=dev)[:, None]
    return (q.float(), k.float(), v.float(), g.float(),
            lse.float()[..., None], dsum.float()[..., None], q_pos,
            q.shape[-1] ** -0.5 if scale is None else scale)


def flash_bwd_dq_plain(q, k, v, lse, dsum, g, q_offset: int = 0,
                       k_offset: int = 0, causal: bool = False,
                       scale: float | None = None):
    """Plain PyTorch version of ``flash_bwd_dq``: dq over the forward's
    k-tiles, in q's type (``scale`` as in ``flash_attention_call_plain``)."""
    qf, kf, vf, gf, lse_c, dsum_c, q_pos, scale = _bwd_inputs(
        q, k, v, lse, dsum, g, q_offset, scale)
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
                        k_offset: int = 0, causal: bool = False,
                        scale: float | None = None):
    """Plain PyTorch version of ``flash_bwd_dkv``: (dk, dv) over q-tiles of
    ``BLOCK_K`` queries, in k's and v's types (``scale`` as in
    ``flash_attention_call_plain``)."""
    qf, kf, vf, gf, lse_c, dsum_c, q_pos, scale = _bwd_inputs(
        q, k, v, lse, dsum, g, q_offset, scale)
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
                                k_offset: int = 0, causal: bool = False,
                                scale: float | None = None):
    """Plain PyTorch version of ``flash_backward_blocks``."""
    dq = flash_bwd_dq_plain(q, k, v, lse, dsum, g, q_offset, k_offset, causal,
                            scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, lse, dsum, g, q_offset, k_offset,
                                 causal, scale)
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


def kernel_head_dim(d: int, what: str) -> int:
    """The width a head dim ``d`` runs at on the card, to which the wrapper
    zero-pads: ``d`` itself where a kernel is built for it
    (``KERNEL_HEAD_DIMS``), else the next built width up; past the widest,
    the next multiple of ``HEAD_CHUNK`` (every family's chunked bodies).
    Raises, naming the kernel ``what``, for a head dim below 1."""
    for width in KERNEL_HEAD_DIMS:
        if 1 <= d <= width:
            return width
    if d > KERNEL_HEAD_DIMS[-1]:
        return -(-d // HEAD_CHUNK) * HEAD_CHUNK
    raise ValueError(
        f"{what}: head_dim {d} has no CUDA kernel (built for "
        f"{KERNEL_HEAD_DIMS})"
    )


def pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` [..., D] with zero columns appended up to ``width``: ``x``
    itself where D is ``width``. A zero column adds an exact 0 to each
    q.k dot product and a zero output column, which the wrappers cut
    off."""
    d = x.shape[-1]
    if d == width:
        return x
    return torch.nn.functional.pad(x, (0, width - d))


def _cut_head(x: torch.Tensor, d: int) -> torch.Tensor:
    """The first ``d`` columns of a padded output, contiguous."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


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
    body (``flash_fwd_twoterm``); None reads ``use_onepass_default()``. On
    CUDA, f32 runs on the CUDA cores and bf16 on the tensor cores
    (``csrc/flash_forward_sm90.cu``); both give the same bits from either
    body."""
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
    width = kernel_head_dim(d, name)
    if onepass and q.dtype == torch.float32:
        name = "flash_fwd_f32"  # the CUDA-core body, a kernel of its own
    lib = _build.load()
    q, k, v = (pad_head(x, width).contiguous() for x in (q, k, v))
    if q.dtype == torch.float32:  # the CUDA-core body copies 16 bytes a move
        q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    o = torch.empty(
        (b, h, t, width), dtype=q.dtype if normalize else torch.float32,
        device=q.device,
    )
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, t), dtype=torch.float32, device=q.device)  # noqa: E741
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), b * h, t, tk, width,
            _DTYPE_CODES[q.dtype], q_offset, k_offset, int(causal),
            int(normalize), int(not normalize), int(onepass), d**-0.5, stream,
        )
    _build.check(code, name)
    LAUNCHES[name] += 1
    if _flops.armed():
        _flops.note_flops(_flops.attention_fwd_flops(
            b * h, t, tk, d, q_offset, k_offset, causal))
    return _cut_head(o, d), m, l


def _check_bwd(q, k, v, lse, dsum, g) -> None:
    _check_qkv(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or dsum.shape != q.shape[:3]:
        raise ValueError(f"lse {tuple(lse.shape)} and dsum "
                         f"{tuple(dsum.shape)} must be [B, H, T]")


def _bwd_launch(entry, name, q, k, v, lse, dsum, g, q_offset, k_offset,
                causal, n_out):
    """Launch one backward kernel; returns its ``n_out`` outputs (dq, or dk
    and dv) in the inputs' types, at the true head dim."""
    b, h, t, d = q.shape
    width = kernel_head_dim(d, name)
    lib = _build.load()
    q, k, v, g = (pad_head(x, width).contiguous() for x in (q, k, v, g))
    if q.dtype == torch.float32:  # the CUDA-core bodies copy 16 bytes a move
        q, k, v, g = (_aligned16(x) for x in (q, k, v, g))
    lse = lse.float().contiguous()
    dsum = dsum.float().contiguous()
    outs = [torch.empty((q if n_out == 1 else k).shape, dtype=q.dtype,
                        device=q.device) for _ in range(n_out)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), *(o.data_ptr() for o in outs),
            b * h, t, k.shape[2], width, _DTYPE_CODES[q.dtype], int(q_offset),
            int(k_offset), int(causal), d**-0.5, stream,
        )
    _build.check(code, name)
    LAUNCHES[name] += 1
    if _flops.armed():
        _flops.note_flops(_flops.attention_bwd_flops(
            name, b * h, t, k.shape[2], d, int(q_offset), int(k_offset),
            causal))
    return [_cut_head(o, d) for o in outs]


def flash_bwd_dq(q, k, v, lse, dsum, g, q_offset: int = 0, k_offset: int = 0,
                 causal: bool = False):
    """dq of one block pair (see ``flash_backward_blocks``), in q's type."""
    _check_bwd(q, k, v, lse, dsum, g)
    if _on_cpu(q, k, v, lse, dsum, g):
        return flash_bwd_dq_plain(q, k, v, lse, dsum, g, int(q_offset),
                                  int(k_offset), causal)
    (dq,) = _bwd_launch("rtt_flash_bwd_dq", "flash_bwd_dq", q, k, v, lse,
                        dsum, g, q_offset, k_offset, causal, 1)
    return dq


def flash_bwd_dkv(q, k, v, lse, dsum, g, q_offset: int = 0, k_offset: int = 0,
                  causal: bool = False):
    """(dk, dv) of one block pair (see ``flash_backward_blocks``), in k's and
    v's types."""
    _check_bwd(q, k, v, lse, dsum, g)
    if _on_cpu(q, k, v, lse, dsum, g):
        return flash_bwd_dkv_plain(q, k, v, lse, dsum, g, int(q_offset),
                                   int(k_offset), causal)
    dk, dv = _bwd_launch("rtt_flash_bwd_dkv", "flash_bwd_dkv", q, k, v, lse,
                         dsum, g, q_offset, k_offset, causal, 2)
    return dk, dv


def flash_backward_blocks(q, k, v, lse, dsum, g, q_offset: int = 0,
                          k_offset: int = 0, causal: bool = False):
    """One blockwise-backward pass: (dq, dk, dv) of q [B, H, Tq, D] against
    k/v [B, H, Tk, D] in the inputs' types, given the GLOBAL per-row
    logsumexp ``lse`` and ``dsum = rowsum(g * o)`` [B, H, Tq] f32, the
    cotangent ``g`` of o (q's shape and type) and the blocks' global
    positions for the causal mask. Two kernels, ``flash_bwd_dq`` and
    ``flash_bwd_dkv``, each output row owned by one warp (f32) or one
    warpgroup (bf16): no atomics, the same bits on every run.

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
        # the backward runs on autograd's thread: it reports its launches'
        # FLOPs to the count (if any) that this forward ran under
        ctx.flops_tally = _flops.current_tally()
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        dsum = (g.float() * o.float()).sum(dim=-1)
        with _flops.reporting_to(ctx.flops_tally):
            dq, dk, dv = flash_backward_blocks(q, k, v, lse, dsum, g, 0, 0,
                                               ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Fused attention: q, k, v [B, H, T, D] -> [B, H, T, D] in q's type,
    differentiable in q, k and v. Where no gradient can flow (grad mode
    off, as in serving, or no input requiring one) it is the forward alone,
    the same bits without the autograd node and the saved logsumexp."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention_call(q, k, v, 0, 0, causal, normalize=True)[0]
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
    width = kernel_head_dim(d, "flash_decode_int8" if int8_kv else "flash_decode")
    lib = _build.load()
    # a head dim between the built widths (or past 256, not a multiple of
    # HEAD_CHUNK): the gathered cache is copied, padded, on every call
    q, k, v = (pad_head(x, width).contiguous() for x in (q, k, v))
    lens = kv_len.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    if int8_kv:
        return _cut_head(
            _decode_int8(lib, q, k, v, lens, k_scale, v_scale, o, d), d)
    k, v = _aligned16(k), _aligned16(v)
    work = torch.empty(lib.rtt_flash_decode_work(b, h, tq, tk, width),
                       dtype=torch.float32, device=q.device)
    tickets = _build.tickets(q.device, b * h)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rtt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), work.data_ptr(), tickets.data_ptr(), work.numel(),
            b, h, tq, tk, width, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
            d**-0.5, stream,
        )
    _build.check(code, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    if _flops.armed():
        _flops.note_flops(_flops.decode_flops(h, tq, d, lens.tolist()))
    return _cut_head(o, d)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor whose base the kernel can read 16 bytes at a
    time: t itself, or a fresh copy where t's base is not so aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _decode_int8(lib, q, k, v, lens, k_scale, v_scale, o, d):
    """One launch of the split int8-cache decode kernel (K4b) into o, at
    q's (built) head dim with the score scale of the true one, ``d``."""
    b, h, tq, width = q.shape
    tk = k.shape[2]
    k, v = _aligned16(k), _aligned16(v)
    k_scale = k_scale.to(torch.float32).contiguous()
    v_scale = v_scale.to(torch.float32).contiguous()
    chunks = -(-tk // DECODE_CHUNK)
    part = torch.empty((b * h, chunks, tq, 2 + width), dtype=torch.float32,
                       device=q.device)
    tickets = _build.tickets(q.device, b * h)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.rtt_flash_decode_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lens.data_ptr(), o.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), b, h, tq, tk, width, _DTYPE_CODES[q.dtype],
            DECODE_CHUNK, d**-0.5, stream,
        )
    _build.check(code, "flash_decode_int8")
    LAUNCHES["flash_decode_int8"] += 1
    if _flops.armed():
        _flops.note_flops(_flops.decode_flops(h, tq, d, lens.tolist()))
    return o
