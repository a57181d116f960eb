"""MLP models: the counterpart of ``raydp_tpu/models/mlp.py`` (the NYCTaxi
workload family).

A stack of dense layers with ReLU between them. As in flax, every parameter
is f32 and each layer casts its weights to the model dtype at use, so an
optimizer updates f32 weights. Flax infers the input width at ``init``;
an ``nn.Linear`` needs it at construction, so the port's models take
``in_features`` first. The dense layers sit in one ``ModuleList`` named
``dense``, numbered as flax numbers ``Dense_i``
(``models.convert.mlp_params_from_flax``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch._device import resolve_device


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: f32 params cast at use."""
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


@torch.no_grad()
def init_dense(module: nn.Module, gen: torch.Generator) -> None:
    """flax's initializers in kind: kernels normal with std fan_in^-0.5
    (lecun normal), zero biases."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                             * mod.in_features**-0.5)
            mod.bias.zero_()


class _DenseStack(nn.Module):
    """Dense -> ReLU -> ... -> Dense over ``widths`` [in, hidden..., out],
    built on ``device`` (CUDA unless ``"cpu"`` is asked for) from a
    ``torch.Generator`` seeded by ``seed``."""

    def __init__(self, widths: Sequence[int], dtype: torch.dtype, device,
                 seed: int):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        init_dense(self, torch.Generator().manual_seed(int(seed)))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.dense[0].weight.device

    def forward(self, x):
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        for layer in self.dense[:-1]:
            x = F.relu(linear(layer, x, self.dtype))
        return linear(self.dense[-1], x, self.dtype)


class MLPRegressor(_DenseStack):
    """Dense -> relu stack -> scalar head. hidden=(256, 128, 64, 16) matches
    the reference NYCTaxi model's widths."""

    def __init__(self, in_features: int,
                 hidden: Sequence[int] = (256, 128, 64, 16),
                 dtype: torch.dtype = torch.float32, *, device=None,
                 seed: int = 0):
        super().__init__([in_features, *hidden, 1], dtype, device, seed)


class MLPClassifier(_DenseStack):
    """Dense -> relu stack -> ``num_classes`` logits."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (256, 128, 64),
                 num_classes: int = 2, dtype: torch.dtype = torch.float32, *,
                 device=None, seed: int = 0):
        super().__init__([in_features, *hidden, num_classes], dtype, device,
                         seed)
