"""Exact single-device attention: the counterpart of ``full_attention`` in
``raydp_tpu/parallel/ring_attention.py``. Ring and Ulysses attention over
NCCL belong to a later slice.
"""

from __future__ import annotations

import torch

from raydp_tpu_torch.ops.flash_attention import NEG_INF


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
