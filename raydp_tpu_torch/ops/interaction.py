"""DLRM dot interaction: the counterpart of ``raydp_tpu/ops/interaction.py``.

For stacked per-feature embeddings T [B, F, D], all pairwise dot products,
returned as the strict lower triangle packed row by row, [B, F(F-1)/2]:
``out[b, i(i-1)/2 + j] = T[b, i] . T[b, j]`` for i > j.

- ``dot_interaction``: einsum and gather in torch ops, the counterpart of the
  JAX package's XLA path; autograd differentiates it.
- ``dot_interaction_kernel``: the counterpart of ``dot_interaction_pallas``,
  a ``torch.autograd.Function``. Its forward is ``interaction_fwd``, which
  launches the hand-written kernel (``csrc/interaction.cu``) on a CUDA
  tensor and runs ``dot_interaction_plain`` on a CPU tensor. Its backward is
  the JAX package's custom-VJP backward in torch ops, the same on both
  devices (the JAX package too computes it in XLA, outside any kernel).
- ``dot_interaction_fused``: the name the model calls. On one device it is
  ``dot_interaction_kernel``.

``LAUNCHES`` counts kernel launches; the plain version does not count. A
launch also reports its FLOPs (2 * D a pair) to ``ops._flops``, since a
step's FLOPs count cannot see a ctypes call.
"""

from __future__ import annotations

import numpy as np
import torch

from raydp_tpu_torch.ops import _build, _flops
from raydp_tpu_torch.ops.flash_attention import _on_cpu

LAUNCHES = {"interaction_fwd": 0}

_DTYPE_CODES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pair_table(f: int) -> np.ndarray:
    """The kernel's (i, j) of each packed output p, in ``np.tril_indices(f,
    -1)`` order: uint32 ``i << 16 | j`` (the kernel takes F < 2**16)."""
    rows, cols = np.tril_indices(f, k=-1)
    return (rows.astype(np.uint32) << 16) | cols.astype(np.uint32)


_PAIR_TABLES = {}


def _pair_table(f: int, device: torch.device) -> torch.Tensor:
    """``pair_table(f)`` on ``device``, built once per (F, device)."""
    key = (f, device)
    table = _PAIR_TABLES.get(key)
    if table is None:
        table = torch.from_numpy(pair_table(f).view(np.int32)).to(device)
        _PAIR_TABLES[key] = table
    return table


def _tril_indices(f: int, device):
    rows, cols = np.tril_indices(f, k=-1)
    return (torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device))


def dot_interaction(stacked: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F(F-1)/2] pairwise dots (einsum path)."""
    gram = torch.einsum("bfd,bgd->bfg", stacked, stacked)
    rows, cols = _tril_indices(stacked.shape[1], stacked.device)
    return gram[:, rows, cols]


def dot_interaction_plain(stacked: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops: the Gram matrix in f32, its strict
    lower triangle packed row by row, cast to the input dtype. Used for CPU
    tensors and by the checks."""
    return dot_interaction(stacked.float()).to(stacked.dtype)


def interaction_fwd(stacked: torch.Tensor) -> torch.Tensor:
    """The forward: the kernel for a CUDA tensor (f32 or bf16), the plain
    version for a CPU tensor."""
    if stacked.dim() != 3:
        raise ValueError(f"stacked must be [B, F, D], got {tuple(stacked.shape)}")
    if _on_cpu(stacked):
        return dot_interaction_plain(stacked)
    b, f, d = stacked.shape
    if stacked.dtype not in _DTYPE_CODES:
        raise TypeError(f"interaction_fwd takes f32 or bf16, got {stacked.dtype}")
    out = torch.empty((b, f * (f - 1) // 2), dtype=stacked.dtype,
                      device=stacked.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    t = stacked.contiguous()
    table = _pair_table(f, t.device)
    with _build.launch_context(t.device):
        code = lib.rtt_interaction_fwd(t.data_ptr(), table.data_ptr(),
                                       out.data_ptr(), b, f, d,
                                       _DTYPE_CODES[t.dtype],
                                       _build.raw_stream(t.device))
    _build.check(code, "interaction_fwd")
    LAUNCHES["interaction_fwd"] += 1
    _flops.note_flops(2 * out.numel() * d)
    return out


def _interaction_bwd(stacked: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Scatter the packed cotangent into [B, F, F] at the triangle,
    symmetrise (d(T T^T) is symmetric), multiply by T."""
    b, f, _ = stacked.shape
    rows, cols = _tril_indices(f, stacked.device)
    gram_grad = g.new_zeros((b, f, f))
    gram_grad[:, rows, cols] = g
    sym = gram_grad + gram_grad.transpose(1, 2)
    return torch.bmm(sym.to(stacked.dtype), stacked)


class _DotInteraction(torch.autograd.Function):
    """The custom VJP of ``dot_interaction_pallas``: the forward saves T."""

    @staticmethod
    def forward(ctx, stacked):
        ctx.save_for_backward(stacked)
        return interaction_fwd(stacked)

    @staticmethod
    def backward(ctx, g):
        (stacked,) = ctx.saved_tensors
        return _interaction_bwd(stacked, g)


def dot_interaction_kernel(stacked: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F(F-1)/2] in T's dtype, through the kernel on CUDA,
    differentiable in T."""
    return _DotInteraction.apply(stacked)


def dot_interaction_fused(stacked: torch.Tensor) -> torch.Tensor:
    """The interaction the model calls. On one device it is
    ``dot_interaction_kernel``. Under a process group of more than one rank
    (the JAX package runs the kernel per shard under a mesh) it raises."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "dot_interaction_fused over more than one device (the kernel per "
            "batch shard) is ported in the multi-GPU slice"
        )
    return dot_interaction_kernel(stacked)
