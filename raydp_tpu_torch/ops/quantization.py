"""Int8 quantization with per-row scales, stochastic rounding and the int8
product: the counterpart of ``raydp_tpu/ops/quantization.py``.

- ``quantize_int8``: [N, D] f32 -> (int8 values, f32 scales [N, 1]), the
  scale of a row absmax / 127 floored at 1e-12. Deterministic rounding
  (half to even) is plain tensor code on both devices, as in the JAX
  package. Stochastic rounding, ``floor(x / s + u)`` with ``u`` uniform in
  [0, 1), launches the hand-written kernel ``quantize_stochastic_kernel``
  (``csrc/quantization.cu``, the counterpart of the TPU kernel
  ``_quant_kernel``) on a CUDA tensor and runs
  ``quantize_int8_stochastic_plain`` on a CPU tensor.
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
  it launches ``int8_gemm_kernel`` (``csrc/quantization.cu``; the JAX
  package's int8 product is ``jax.lax.dot_general``, not a Pallas kernel)
  and on a CPU tensor runs ``int8_gemm_plain``: an exact integer product
  (an f64 product of int8 values, exact while K * 127**2 < 2**53) and the
  two f32 multiplies in that order. The two agree bit for bit.
- ``int8_matmul``: ``x [..., K] @ w.T`` for a ``Linear`` weight w [M, K]
  (flax's kernel [K, M] transposed, so w's per-row scales are flax's
  per-column ones): both operands quantized with the deterministic
  ``quantize_int8``, the product through ``int8_gemm``, and a
  straight-through backward that differentiates the exact float product,
  as ``_int8_matmul_bwd``.
- ``int8_linear``: flax ``nn.Dense(dtype=..., dot_general=int8_dot_general)``
  for a ``Linear``'s weight and bias.

On a CUDA tensor each kernel wrapper launches its kernel or raises; there is
no fallback. ``LAUNCHES`` counts kernel launches; the plain versions do not
count. Scales divide by a tensor 127 rather than the Python number: on CUDA
torch divides by a Python scalar as a multiply by its reciprocal, which can
be an ulp off the IEEE quotient that the JAX package and the kernel take.
"""

from __future__ import annotations

import torch

from raydp_tpu_torch.ops import _build
from raydp_tpu_torch.ops.flash_attention import _on_cpu

LAUNCHES = {"quantize_int8_stochastic": 0, "int8_gemm": 0}

_OUT_CODES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}

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
    Deterministic rounding is half to even (``jnp.round``). Stochastic
    rounding needs ``seed`` (vary it per call, e.g. a step counter) and an
    f32 [N, D] tensor: the kernel on CUDA, the plain version on the CPU."""
    if not stochastic:
        del seed
        scales = _row_scales(x)
        values = torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)
        return values, scales
    if seed is None:
        raise ValueError("stochastic quantization requires a per-step seed")
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic quantize_int8 takes f32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    if _on_cpu(x):
        return quantize_int8_stochastic_plain(x, seed)
    return _quantize_stochastic_kernel(x, seed)


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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.rtt_quantize_stochastic(
            x.data_ptr(), values.data_ptr(), scales.data_ptr(), n, d, k0, k1,
            stream)
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
    kernel for CUDA tensors, the plain version for CPU tensors."""
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
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"int8_gemm writes f32 or bf16, not {out_dtype}")
    if _on_cpu(xq, xs, wq, ws):
        return int8_gemm_plain(xq, xs, wq, ws, out_dtype)
    out = torch.empty((n, m), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    xq, xs, wq, ws = (t.contiguous() for t in (xq, xs, wq, ws))
    lib = _build.load()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        code = lib.rtt_int8_gemm(
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            out.data_ptr(), n, m, k, _OUT_CODES[out_dtype], stream)
    _build.check(code, "int8_gemm")
    LAUNCHES["int8_gemm"] += 1
    return out


def _quantized_product(x, w, out_dtype, gemm):
    xq, xs = quantize_int8(x.reshape(-1, x.shape[-1]).to(torch.float32))
    wq, ws = quantize_int8(w.to(torch.float32))  # per-row = flax's per-column
    out = gemm(xq, xs, wq, ws, out_dtype)
    return out.reshape(*x.shape[:-1], w.shape[0])


class _Int8Matmul(torch.autograd.Function):
    """The custom VJP of ``int8_matmul``: the forward saves x and w; the
    backward is straight-through (``_int8_matmul_bwd``): the gradients of
    the exact float product, gx in x's dtype and gw summed in f32 and cast
    to w's dtype. Those two are plain large products, left to
    ``torch.matmul`` as the JAX package leaves them to XLA."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, gemm):
        ctx.save_for_backward(x, w)
        return _quantized_product(x, w, out_dtype, gemm)

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
    return _Int8Matmul.apply(x, w, out_dtype, int8_gemm)


def int8_matmul_plain(x, w, out_dtype=torch.float32) -> torch.Tensor:
    """``int8_matmul`` with ``int8_gemm_plain`` for the product on any
    device; the same backward."""
    return _Int8Matmul.apply(x, w, out_dtype, int8_gemm_plain)


def int8_linear(x, weight, bias, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype, dot_general=int8_dot_general)`` for a
    ``Linear``'s f32 weight [M, K] and bias: input and parameters cast to
    ``dtype``, the int8 product cast to ``dtype``, then the bias added in
    ``dtype``."""
    y = int8_matmul(x.to(dtype), weight.to(dtype), out_dtype=dtype)
    return y + bias.to(dtype)
