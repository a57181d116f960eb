"""Int8 quantization with per-row scales, stochastic rounding and the int8
product: the counterpart of ``raydp_tpu/ops/quantization.py``.

- ``quantize_int8``: [N, D] f32 or bf16 -> (int8 values, f32 scales [N,
  1]), the scale of a row absmax / 127 floored at 1e-12, computed in f32
  (bf16 is read exactly). Deterministic rounding (half to even, the JAX
  package's jnp code) launches ``quantize_rows_kernel`` on a CUDA tensor
  and runs ``quantize_int8_plain``, the same steps in torch ops, on a CPU
  tensor; the two agree bit for bit. Stochastic rounding, ``floor(x / s +
  u)`` with ``u`` uniform in [0, 1), launches ``quantize_stochastic_kernel``
  (the counterpart of the TPU kernel ``_quant_kernel``) on a CUDA tensor
  and runs ``quantize_int8_stochastic_plain`` on a CPU tensor. Both kernels
  are in ``csrc/quantization.cu``.
- ``philox4x32_10``: the counter-based generator both stochastic versions
  draw ``u`` from, Random123's Philox4x32-10 in int64 torch ops. Element
  ``e = row * D + col`` takes word ``e & 3`` of the block at counter
  ``(lo32(e >> 2), hi32(e >> 2), 0, 0)`` under the key ``(lo32(seed),
  hi32(seed))``, seed mod 2**64, and ``u = (bits >> 9) * 2**-23`` (the TPU
  kernel's mantissa trick: the top 23 bits, exactly in [0, 1)). One stream
  over the whole tensor, whatever the tiling: the port follows the JAX
  package's off-TPU branch, one key per call, and not the TPU kernel's
  ``seed + tile`` seeding, under which tile 1 of seed ``s`` repeats tile 0
  of seed ``s + 1``. So there is no ``block_rows``.
- ``int8_gemm``: ``out[n, m] = float(sum_k xq[n, k] * wq[m, k]) * xs[n] *
  ws[m]`` cast to f32 or bf16, both operands K-contiguous. On a CUDA tensor
  it launches ``int8_gemm_sm90_kernel`` (``csrc/quantization.cu``: wgmma
  s8 through TMA; the JAX package's int8 product is
  ``jax.lax.dot_general``, not a Pallas kernel) and on a CPU tensor runs
  ``int8_gemm_plain``: an exact integer product (an f64 product of int8
  values, exact while K * 127**2 < 2**53) and the two f32 multiplies in
  that order. The two agree bit for bit.
- ``int8_matmul``: ``x [..., K] @ w.T`` for a ``Linear`` weight w [M, K]
  (flax's kernel [K, M] transposed, so w's per-row scales are flax's
  per-column ones): both operands quantized with the deterministic
  rounding, the product through ``int8_gemm``, and a straight-through
  backward that differentiates the exact float product, as
  ``_int8_matmul_bwd``. On CUDA tensors that is two launches: one
  ``quantize_rows_kernel`` for x and w together, into rows padded to a
  multiple of 16 bytes, and one ``int8_gemm_sm90_kernel``.
- ``int8_linear``: flax ``nn.Dense(dtype=..., dot_general=int8_dot_general)``
  for a ``Linear``'s weight and bias.

On a CUDA tensor each kernel wrapper launches its kernel or raises; there is
no fallback. ``LAUNCHES`` counts kernel launches; the plain versions do not
count. ``int8_gemm``'s launches report their FLOPs (2 * K an output) to
``ops._flops``. Scales divide by a tensor 127 rather than the Python
number: on CUDA torch divides by a Python scalar as a multiply by its
reciprocal, which can be an ulp off the IEEE quotient that the JAX package
and the kernel take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raydp_tpu_torch.ops import _build, _flops
from raydp_tpu_torch.ops.flash_attention import _on_cpu

LAUNCHES = {"quantize_int8": 0, "quantize_int8_stochastic": 0, "int8_gemm": 0}

# the types quantize_int8 reads and int8_gemm writes
_DTYPE_CODES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}

# int8_gemm's swapped, split-K mode takes N up to this (csrc kSmallN); its
# partial tiles hold 64 x SMALL_N s32
SMALL_N = 16
_SPLIT_TILE = 64 * SMALL_N

_MASK32 = 0xFFFFFFFF
# Random123's Philox4x32 multipliers and Weyl key increments
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _row_scales(x: torch.Tensor) -> torch.Tensor:
    """absmax / 127 per row (IEEE division on both devices), floored at
    1e-12."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)


def quantize_int8(x: torch.Tensor, seed: int | None = None,
                  stochastic: bool = False):
    """[N, D] f32 -> (int8 values [N, D], f32 scales [N, 1]); row-wise
    scales absmax / 127, floored at 1e-12, values clipped to +-127.
    Deterministic rounding is half to even (``jnp.round``); it takes f32 or
    bf16 of any shape [..., D] (scales [..., 1]) and computes in f32, so
    bf16 input gives the bits of its f32 cast. Stochastic rounding needs
    ``seed`` (vary it per call, e.g. a step counter) and an f32 [N, D]
    tensor. Each launches its kernel on CUDA and runs its plain version on
    the CPU."""
    if not stochastic:
        del seed
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"quantize_int8 takes f32 or bf16, got {x.dtype}")
        if _on_cpu(x):
            return quantize_int8_plain(x)
        d = x.shape[-1]
        values, scales = _quantize_rows_kernel([x.reshape(-1, d)], d)
        return values.reshape(x.shape), scales.reshape(*x.shape[:-1], 1)
    if seed is None:
        raise ValueError("stochastic quantization requires a per-step seed")
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic quantize_int8 takes f32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    if _on_cpu(x):
        return quantize_int8_stochastic_plain(x, seed)
    return _quantize_stochastic_kernel(x, seed)


def quantize_int8_plain(x: torch.Tensor):
    """Deterministic rounding in torch ops, the JAX function's steps in f32
    (bf16 read as f32): ``clip(round(x / s), -127, 127)``, half to even."""
    x = x.float()
    scales = _row_scales(x)
    values = torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)
    return values, scales


def _quantize_rows_kernel(parts, ld: int):
    """One or two [rows, D] f32/bf16 CUDA tensors -> int8 values [rows,
    ld] (zeros past D) and f32 scales [rows, 1] of all their rows, the
    first tensor's first: one launch of ``quantize_rows_kernel``."""
    parts = [t.contiguous() for t in parts]
    d = parts[0].shape[1]
    rows = [t.shape[0] for t in parts]
    dev = parts[0].device
    values = torch.empty((sum(rows), ld), dtype=torch.int8, device=dev)
    scales = torch.empty((sum(rows), 1), dtype=torch.float32, device=dev)
    if values.shape[0] == 0:
        return values, scales
    second = parts[1] if len(parts) > 1 else None
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rtt_quantize_rows(
            parts[0].data_ptr(), rows[0], _DTYPE_CODES[parts[0].dtype],
            None if second is None else second.data_ptr(),
            0 if second is None else rows[1],
            _DTYPE_CODES[parts[0].dtype if second is None else second.dtype],
            values.data_ptr(), scales.data_ptr(), d, ld, stream)
    _build.check(code, "quantize_int8")
    LAUNCHES["quantize_int8"] += 1
    return values, scales


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return values.to(torch.float32) * scales


def _key(seed: int) -> tuple:
    seed = int(seed) % 2**64
    return seed & _MASK32, seed >> 32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counters (c0, c1, c2, c3) under key (k0, k1): int64
    tensors holding 32-bit words in, four such tensors out. A wrapping int64
    product of two 32-bit words keeps its low 64 bits, so its two halves
    are the 32x32 product's high and low words."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _MASK32, (k1 + PHILOX_W1) & _MASK32
        p0 = c0 * PHILOX_M0
        p1 = c2 * PHILOX_M1
        c0, c1, c2, c3 = (
            ((p1 >> 32) & _MASK32) ^ c1 ^ k0,
            p1 & _MASK32,
            ((p0 >> 32) & _MASK32) ^ c3 ^ k1,
            p0 & _MASK32,
        )
    return c0, c1, c2, c3


def philox_uniform(n: int, seed: int, device=None) -> torch.Tensor:
    """The stream's first ``n`` uniforms in [0, 1), f32: element e from word
    e & 3 of the Philox block at counter e >> 2."""
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zeros = torch.zeros_like(blocks)
    words = philox4x32_10(blocks & _MASK32, blocks >> 32, zeros, zeros,
                          *_key(seed))
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return (bits >> 9).to(torch.float32) * 2.0**-23


def quantize_int8_stochastic_plain(x: torch.Tensor, seed: int):
    """The kernel's function in torch ops, the f32 steps of the JAX
    package's off-TPU branch with the port's Philox stream for ``u``:
    ``clip(floor(x / s + u), -127, 127)``."""
    scales = _row_scales(x)
    u = philox_uniform(x.numel(), seed, x.device).reshape(x.shape)
    values = torch.clamp(torch.floor(x / scales + u), -127, 127).to(torch.int8)
    return values, scales


def _quantize_stochastic_kernel(x: torch.Tensor, seed: int):
    n, d = x.shape
    values = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return values, scales
    x = x.contiguous()
    lib = _build.load()
    k0, k1 = _key(seed)
    with _build.launch_context(x.device):
        code = lib.rtt_quantize_stochastic(
            x.data_ptr(), values.data_ptr(), scales.data_ptr(), n, d, k0, k1,
            _build.raw_stream(x.device))
    _build.check(code, "quantize_int8_stochastic")
    LAUNCHES["quantize_int8_stochastic"] += 1
    return values, scales


def int8_gemm_plain(xq, xs, wq, ws, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in torch ops: the exact int32 product (torch
    has no integer matmul on CUDA; an f64 product of int8 values is exact
    while K * 127**2 < 2**53), then ``(y.float() * xs) * ws.T``, cast."""
    y = (xq.to(torch.float64) @ wq.to(torch.float64).T).to(torch.int32)
    return ((y.to(torch.float32) * xs) * ws.T).to(out_dtype)


def int8_gemm(xq, xs, wq, ws, out_dtype=torch.float32) -> torch.Tensor:
    """xq [N, K] int8, xs [N, 1] f32, wq [M, K] int8, ws [M, 1] f32 ->
    [N, M] in ``out_dtype`` (f32 or bf16, rounded to nearest even): the
    kernel for CUDA tensors, the plain version for CPU tensors.

    On the card it is one launch of ``int8_gemm_sm90_kernel`` in one of two
    modes, chosen by N. N <= ``SMALL_N`` (16: decode's few rows): the
    operands swap, the weights in 64-row tiles on wgmma's M side and the
    rows of x on its n side, and K is split over a few hundred blocks whose
    int32 partials the last one sums. N > 16 (training, prefill): 128 x 256
    output tiles, K whole. Both give the plain version's bits. Operands
    whose K is not a multiple of 16, or which are not 16-byte aligned, are
    copied zero-padded to a 16-byte row pitch first (TMA's stride);
    zero columns leave the sums as they are."""
    n, k = xq.shape
    m, kw = wq.shape
    if k != kw or xs.shape != (n, 1) or ws.shape != (m, 1):
        raise ValueError(
            f"int8_gemm shapes: xq {tuple(xq.shape)}, xs {tuple(xs.shape)}, "
            f"wq {tuple(wq.shape)}, ws {tuple(ws.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 operands, got {xq.dtype}, {wq.dtype}")
    if xs.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError(f"int8_gemm takes f32 scales, got {xs.dtype}, {ws.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_gemm writes f32 or bf16, not {out_dtype}")
    if _on_cpu(xq, xs, wq, ws):
        return int8_gemm_plain(xq, xs, wq, ws, out_dtype)
    pitch = _pitch(k)
    return _int8_gemm_kernel(_pitched(xq, pitch), xs, _pitched(wq, pitch), ws,
                             out_dtype, k)


def _pitch(k: int) -> int:
    """The int8 product's row pitch in bytes: K rounded up to 16."""
    return (k + 15) // 16 * 16


def _pitched(q: torch.Tensor, pitch: int) -> torch.Tensor:
    """q [R, K] int8 as contiguous rows of ``pitch`` bytes from a 16-byte
    aligned base, zeros past K: q itself where it already is so."""
    if q.shape[1] == pitch and q.is_contiguous() and q.data_ptr() % 16 == 0:
        return q
    return F.pad(q, (0, pitch - q.shape[1])).contiguous()


def _int8_gemm_kernel(xq, xs, wq, ws, out_dtype, k: int) -> torch.Tensor:
    """One launch of ``int8_gemm_sm90_kernel`` on pitched operands (rows of
    ``xq``/``wq`` ``pitch`` bytes, zeros past K)."""
    n, pitch = xq.shape
    m = wq.shape[0]
    out = torch.empty((n, m), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    if k == 0:
        raise ValueError("int8_gemm: K must be positive on the card")
    xs, ws = xs.contiguous(), ws.contiguous()
    lib = _build.load()
    splits = lib.rtt_int8_gemm_splits(n, m, pitch)
    m_tiles = -(-m // 64)
    partial = (torch.empty(splits * m_tiles * _SPLIT_TILE, dtype=torch.int32,
                           device=xq.device) if splits > 1 else None)
    tickets = _build.tickets(xq.device, m_tiles)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        code = lib.rtt_int8_gemm(
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            tickets.data_ptr(), n, m, k, pitch, _DTYPE_CODES[out_dtype], stream)
    _build.check(code, "int8_gemm")
    LAUNCHES["int8_gemm"] += 1
    _flops.note_flops(_flops.int8_gemm_flops(n, m, k))
    return out


def _quantized_product(x, w, out_dtype, plain: bool):
    """``x [..., K] @ w.T`` through the int8 product: on CUDA tensors one
    quantize launch for x and w together (rows padded to a 16-byte pitch)
    and one GEMM launch; with ``plain`` or on the CPU the plain versions."""
    x2 = x.reshape(-1, x.shape[-1])
    if plain or _on_cpu(x2, w):
        xq, xs = quantize_int8_plain(x2)
        wq, ws = quantize_int8_plain(w)  # per-row = flax's per-column
        out = int8_gemm_plain(xq, xs, wq, ws, out_dtype)
    else:
        n, k = x2.shape
        x2 = x2 if x2.dtype in _DTYPE_CODES else x2.float()
        w2 = w if w.dtype in _DTYPE_CODES else w.float()
        values, scales = _quantize_rows_kernel([x2, w2], _pitch(k))
        out = _int8_gemm_kernel(values[:n], scales[:n], values[n:],
                                scales[n:], out_dtype, k)
    return out.reshape(*x.shape[:-1], w.shape[0])


class _Int8Matmul(torch.autograd.Function):
    """The custom VJP of ``int8_matmul``: the forward saves x and w; the
    backward is straight-through (``_int8_matmul_bwd``): the gradients of
    the exact float product, gx in x's dtype and gw summed in f32 and cast
    to w's dtype. Those two are plain large products, left to
    ``torch.matmul`` as the JAX package leaves them to XLA."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, plain):
        ctx.save_for_backward(x, w)
        return _quantized_product(x, w, out_dtype, plain)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g.to(x.dtype) @ w.to(x.dtype)
        gw = (g.reshape(-1, g.shape[-1]).to(torch.float32).T
              @ x.reshape(-1, x.shape[-1]).to(torch.float32)).to(w.dtype)
        return gx, gw, None, None


def int8_matmul(x, w, out_dtype=torch.float32) -> torch.Tensor:
    """``x [..., K] @ w.T`` for w [M, K] through the int8 product, in
    ``out_dtype`` (f32, as the JAX function returns, or bf16, which equals
    its f32 result cast); differentiable in x and w, straight through."""
    return _Int8Matmul.apply(x, w, out_dtype, False)


def int8_matmul_plain(x, w, out_dtype=torch.float32) -> torch.Tensor:
    """``int8_matmul`` through the plain versions (``quantize_int8_plain``,
    ``int8_gemm_plain``) on any device; the same backward."""
    return _Int8Matmul.apply(x, w, out_dtype, True)


def int8_linear(x, weight, bias, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype, dot_general=int8_dot_general)`` for a
    ``Linear``'s f32 weight [M, K] and bias: input and parameters cast to
    ``dtype``, the int8 product cast to ``dtype``, then the bias added in
    ``dtype``."""
    y = int8_matmul(x.to(dtype), weight.to(dtype), out_dtype=dtype)
    return y + bias.to(dtype)
