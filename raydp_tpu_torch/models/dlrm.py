"""DLRM, the Criteo workload: the counterpart of ``raydp_tpu/models/dlrm.py``.

A bottom MLP over the dense features, one embedding table per categorical
feature, the pairwise dot interaction of the stacked [B, 1 + S, D]
embeddings, and a top MLP over ``[h, interaction]``.

Inputs take the JAX package's two forms: ``(dense, ids)`` with dense float
[B, num_dense] and integer ids [B, S], exact at any vocab size; or one float
matrix, ``x[:, :num_dense]`` dense and ``x[:, num_dense:]`` ids cast to
int32, guarded because floats hold integers exactly only up to 2^mantissa.
Ids are clipped to ``[0, vocab - 1]``.

Every parameter is f32 and is cast to ``dtype`` at use, as in flax. The
tables are gathered with ``F.embedding`` and get dense gradients, so Adam
moves every row each step, as optax does. The dense layers sit in one
``ModuleList`` named ``dense``, bottom then top, numbered as flax numbers
``Dense_i`` across both; ``bottom_proj``, ``embedding_i`` and ``head`` keep
flax's names (``models.convert.dlrm_params_from_flax``).
``dlrm_sharding_rules`` belongs to ROADMAP Queue 1 item 3b.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch._device import resolve_device
from raydp_tpu_torch.models.mlp import init_dense, linear
from raydp_tpu_torch.ops.interaction import dot_interaction, dot_interaction_fused
from raydp_tpu_torch.optim import adafactor, adam, multi_transform


class DLRM(nn.Module):
    """``use_pallas_interaction``: None or True runs
    ``dot_interaction_fused`` (the hand-written kernel on CUDA, its plain
    version on the CPU); False runs the einsum path ``dot_interaction``.
    Built on ``device`` (CUDA unless ``"cpu"`` is asked for) from a
    ``torch.Generator`` seeded by ``seed`` (flax's initializers in kind)."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        num_dense: int,
        embed_dim: int = 16,
        bottom_mlp: Sequence[int] = (64, 32),
        top_mlp: Sequence[int] = (64, 32),
        use_pallas_interaction: Optional[bool] = None,
        dtype: torch.dtype = torch.float32,
        *,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.vocab_sizes = [int(v) for v in vocab_sizes]
        self.num_dense = num_dense
        self.embed_dim = embed_dim
        self.n_bottom = len(bottom_mlp)
        self.use_pallas_interaction = use_pallas_interaction
        self.dtype = dtype

        bottom = [num_dense, *bottom_mlp]
        features = 1 + len(self.vocab_sizes)
        top = [embed_dim + features * (features - 1) // 2, *top_mlp]
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(bottom[:-1], bottom[1:])]
            + [nn.Linear(a, b) for a, b in zip(top[:-1], top[1:])]
        )
        self.bottom_proj = nn.Linear(bottom[-1], embed_dim)
        self.head = nn.Linear(top[-1], 1)
        gen = torch.Generator().manual_seed(int(seed))
        init_dense(self, gen)
        for i, vocab in enumerate(self.vocab_sizes):
            table = torch.randn((vocab, embed_dim), generator=gen) / embed_dim**0.5
            self.register_parameter(f"embedding_{i}", nn.Parameter(table))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def _check_float_ids(self, dtype: torch.dtype) -> None:
        """Floats represent integers exactly only up to 2^mantissa: beyond
        that, distinct ids silently collapse onto the same embedding row."""
        if not dtype.is_floating_point:
            return
        mantissa = round(-math.log2(torch.finfo(dtype).eps)) + 1
        max_vocab = max(self.vocab_sizes)
        # ints up to 2^mantissa INCLUSIVE are exact; max id is vocab-1
        if max_vocab - 1 > 2**mantissa:
            name = str(dtype).removeprefix("torch.")
            raise ValueError(
                f"vocab size {max_vocab} exceeds exact-integer range of "
                f"{name} ids (2^{mantissa}); pass ids as a separate integer "
                "array (JaxEstimator categorical_columns / x=(dense, ids))"
            )

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            dense, ids = (torch.as_tensor(a, device=self.device) for a in x)
            dense = dense.to(self.dtype)
            self._check_float_ids(ids.dtype)
            ids = ids.to(torch.int32)
        else:
            x = torch.as_tensor(x, device=self.device)
            dense = x[:, :self.num_dense].to(self.dtype)
            self._check_float_ids(x.dtype)
            ids = x[:, self.num_dense:].to(torch.int32)

        h = dense
        for layer in self.dense[:self.n_bottom]:
            h = F.relu(linear(layer, h, self.dtype))
        h = linear(self.bottom_proj, h, self.dtype)

        stacked = [h]
        for i, vocab in enumerate(self.vocab_sizes):
            table = getattr(self, f"embedding_{i}").to(self.dtype)
            stacked.append(F.embedding(ids[:, i].clamp(0, vocab - 1).long(), table))
        t = torch.stack(stacked, dim=1)  # [B, 1+S, D]

        if self.use_pallas_interaction is False:
            interact = dot_interaction(t)
        else:
            interact = dot_interaction_fused(t)
        z = torch.cat([h, interact.to(self.dtype)], dim=1)
        for layer in self.dense[self.n_bottom:]:
            z = F.relu(linear(layer, z, self.dtype))
        return linear(self.head, z, self.dtype)


def dlrm_optimizer(embedding_lr: float = 1e-2, dense_lr: float = 1e-3):
    """The Criteo-scale optimizer: Adafactor for the embedding tables, Adam
    for everything else, keyed on parameter names (``optax.multi_transform``
    in the JAX package). Dense Adam keeps two full-table moment copies;
    Adafactor with the factoring threshold lowered to cover embedding shapes
    keeps O(rows + cols) second-moment state. Pass the result as
    ``Estimator(optimizer=dlrm_optimizer())``."""

    def label(name: str) -> str:
        return "embed" if "embedding_" in name else "dense"

    return multi_transform(
        {
            # optax factors the second moment only when the smaller dim is
            # >= 128 by default; tables are [vocab, 16..64]
            "embed": adafactor(embedding_lr, min_dim_size_to_factor=0),
            "dense": adam(dense_lr),
        },
        label,
    )
