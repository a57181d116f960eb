"""Analytic FLOPs of a ``TransformerLM`` training step: the port's own copy
of the two functions of ``raydp_tpu/obs/costmodel.py`` that an MFU figure
needs. Matmul-only accounting, the backward as twice the forward, the
convention every MFU number of the repo uses.
"""

from __future__ import annotations


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
