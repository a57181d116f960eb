"""Int8 quantization with per-row scales: the counterpart of the
deterministic branch of ``raydp_tpu/ops/quantization.py``.

This is plain tensor code in the JAX package too, not a kernel. The
stochastic branch (a Pallas kernel with the TPU's own random bits) belongs
to a later slice.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, seed: int | None = None,
                  stochastic: bool = False):
    """[N, D] f32 -> (int8 values [N, D], f32 scales [N, 1]); row-wise
    scales absmax / 127, floored at 1e-12, values rounded half to even (as
    ``jnp.round``) and clipped to +-127."""
    if stochastic:
        raise NotImplementedError(
            "stochastic int8 quantization (the TPU kernel _quant_kernel) is "
            "ported in a later slice"
        )
    del seed
    scales = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    scales = torch.clamp(scales, min=1e-12)
    values = torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)
    return values, scales


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return values.to(torch.float32) * scales
