"""Analytic compute cost model: the port's copy of
``raydp_tpu/obs/costmodel.py`` -- FLOPs accounting, device peaks, MFU.

- **analytic FLOPs** of the model families the repo ships: matmul-only
  accounting, the backward as twice the forward, the convention every MFU
  number of the repo uses.
- **counted FLOPs** of one step (:func:`count_flops`), where the JAX
  package reads XLA's cost analysis of the compiled step
  (``step_flops_from_compiled/abstract/jitted``): the step runs under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the matmuls,
  convolutions and attention it dispatches. A kernel of the port launched
  through ``ctypes`` is not a dispatched op, so the mode cannot see it: its
  wrapper reports its own FLOPs to ``ops._flops`` (the kernel layer's
  tally, which this module arms and reads), and the count adds what was
  reported while it ran. K1 reports 2 * D FLOPs per pair it computes, the
  strict lower triangle (its backward is torch ops, which the mode
  counts); the flash kernels 4 * D a live pair forward, 6 * D for dq and
  8 * D for dk/dv (each backward kernel recomputes the scores and dp, so a
  step counts 18 * D a pair where ``lm_train_flops_per_step`` takes 12 *
  D); decode 4 * D a live pair; the int8 product 2 * K an output. On a CPU
  tensor each wrapper runs its plain version, whose torch ops the mode
  counts as they are (K1's einsum over the whole F x F Gram matrix, the
  plain attention's whole score tiles), so a step's count on the CPU
  differs from the card's.
- **peak FLOP/s** per device (:func:`device_peak_flops`): NVIDIA's data
  sheet peaks for the Hopper cards, read from
  ``torch.cuda.get_device_name``, and a nominal CPU figure, labelled
  ``nominal-cpu``, so the MFU gauge exists on a CPU too.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from raydp_tpu_torch.ops import _flops

# NVIDIA's data sheets, dense rates (no sparsity), per op type: bf16 and
# int8 on the tensor cores, f32 on the CUDA cores; matched by substring of
# the device name, first match wins. The H200 has the H100 SXM's compute.
H100_SXM_PEAKS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
HOPPER_PEAK_FLOPS: Tuple[Tuple[str, Dict[str, float]], ...] = (
    ("H100 PCIe", {"bf16": 756e12, "f32": 51e12, "int8": 1513e12}),
    ("H100 NVL", {"bf16": 835e12, "f32": 60e12, "int8": 1670e12}),
    ("H100", H100_SXM_PEAKS),
    ("H200", H100_SXM_PEAKS),
)

# nominal per-core CPU f32 peak: 3 GHz x (8-wide FMA = 16 flops/cycle), the
# JAX package's figure -- trend lines on a CPU, not a roofline claim
_CPU_NOMINAL_PER_CORE = 3.0e9 * 16


def device_peak_flops(device: Any = None, op_type: str = "bf16") -> dict:
    """``{kind, peak, peak_source, op_type}`` for ``device`` (a torch
    device; default the current CUDA device). ``peak`` is the rate for
    ``op_type`` ("bf16", "f32" or "int8"), None when the device is not in
    the table; ``peak_source`` is one of ``hopper-table`` /
    ``nominal-cpu`` / ``unknown``."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = device.type
    out = {"kind": kind, "op_type": op_type}
    for sub, peaks in HOPPER_PEAK_FLOPS:
        if sub in kind:
            return out | {"peak": peaks[op_type], "peak_source": "hopper-table"}
    if device.type == "cpu":
        cores = os.cpu_count() or 1
        return out | {"peak": cores * _CPU_NOMINAL_PER_CORE,
                      "peak_source": "nominal-cpu"}
    return out | {"peak": None, "peak_source": "unknown"}


# ---------------------------------------------------------------------------
# analytic FLOPs (matmul-only; train = 3x forward)
# ---------------------------------------------------------------------------


def lm_train_flops_per_step(batch: int, seq: int, d_model: int,
                            num_layers: int, vocab: int) -> int:
    """Matmul FLOPs of one TransformerLM training step (fwd+bwd, no remat):
    per token per layer 24*d^2 (qkv 6d^2, proj 2d^2, mlp 16d^2) plus causal
    attention 2*d*(T+1) (QK^T + AV at average context (T+1)/2), plus the d*V
    lm_head; the backward costs twice the forward."""
    per_token = num_layers * (24 * d_model**2 + 2 * d_model * (seq + 1))
    per_token += 2 * d_model * vocab
    return 3 * batch * seq * per_token


def lm_nonattn_flops_per_step(batch: int, seq: int, d_model: int,
                              num_layers: int, vocab: int) -> int:
    """The step's FLOPs with attention as identity (``attn_impl="skip"``):
    attention's FLOPs are the total less this."""
    return 3 * batch * seq * (
        num_layers * 24 * d_model**2 + 2 * d_model * vocab
    )


def lm_decode_flops_per_token(d_model: int, num_layers: int, vocab: int,
                              context: int) -> int:
    """Matmul FLOPs to decode ONE token with ``context`` tokens of KV behind
    it (forward only): per layer 24*d^2 dense matmuls plus 4*d*context
    attention (QK^T and AV each read the whole cache), plus the d*V
    lm_head."""
    per_token = num_layers * (24 * d_model**2 + 4 * d_model * int(context))
    per_token += 2 * d_model * vocab
    return int(per_token)


def lm_prefill_flops(prompt: int, d_model: int, num_layers: int,
                     vocab: int) -> int:
    """Forward-only matmul FLOPs of one prefill over ``prompt`` tokens: the
    train accounting's forward third (causal attention at average context
    (prompt+1)/2)."""
    per_token = num_layers * (
        24 * d_model**2 + 2 * d_model * (int(prompt) + 1)
    )
    per_token += 2 * d_model * vocab
    return int(prompt) * per_token


def mlp_train_flops_per_step(batch: int, layer_dims: Sequence[int]) -> int:
    """Matmul FLOPs of one dense-MLP training step: forward 2*B*d_in*d_out
    per layer, backward twice the forward (gradients of inputs and
    weights); bias adds, activations and the optimizer are excluded."""
    dims = list(layer_dims)
    fwd = sum(2 * batch * a * b for a, b in zip(dims[:-1], dims[1:]))
    return 3 * fwd


# ---------------------------------------------------------------------------
# counted FLOPs of one step
# ---------------------------------------------------------------------------

def count_flops(fn: Callable[[], Any]) -> Tuple[Any, int]:
    """Run ``fn`` once under ``FlopCounterMode``; returns ``(fn's result,
    FLOPs)``: the mode's total plus the FLOPs the port's own kernels
    reported meanwhile (``ops._flops``). The mode changes no arithmetic,
    so the step it counts is a real one."""
    from torch.utils.flop_counter import FlopCounterMode

    with _flops.counting() as kernels:
        with FlopCounterMode(display=False) as mode:
            result = fn()
    return result, int(mode.get_total_flops()) + kernels.total


def mfu(model_flops_per_sec: Optional[float],
        peak_flops: Optional[float]) -> Optional[float]:
    """Model FLOPs utilization; None when either side is unknown."""
    if not model_flops_per_sec or not peak_flops:
        return None
    return model_flops_per_sec / peak_flops
