"""Analytic FLOPs of a training step: the port's own copy of the functions
of ``raydp_tpu/obs/costmodel.py`` that its MFU figures need
(``TransformerLM`` and dense MLPs). Matmul-only accounting, the backward as
twice the forward, the convention every MFU number of the repo uses.
"""

from __future__ import annotations

from typing import Sequence


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


def mlp_train_flops_per_step(batch: int, layer_dims: Sequence[int]) -> int:
    """Matmul FLOPs of one dense-MLP training step: forward 2*B*d_in*d_out
    per layer, backward twice the forward (gradients of inputs and
    weights); bias adds, activations and the optimizer are excluded."""
    dims = list(layer_dims)
    fwd = sum(2 * batch * a * b for a, b in zip(dims[:-1], dims[1:]))
    return 3 * fwd
