"""Metric registry for the port's estimator: the counterpart of
``raydp_tpu/estimator/metrics.py``.

Each metric keeps a (sum-like, count-like) state of two f32 tensors on the
device, so per-batch updates compose across steps without a host sync; the
host reads the state once, in ``compute``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# metric: (update(pred, target) -> (value_sum, weight)); result = value_sum/weight
_REGISTRY: Dict[str, Callable] = {}


def register_metric(name: str):
    def wrap(fn):
        _REGISTRY[name] = fn
        return fn

    return wrap


@register_metric("mse")
def _mse(pred, target):
    pred = pred.reshape(target.shape)
    return torch.sum((pred - target) ** 2), target.numel()


@register_metric("mae")
def _mae(pred, target):
    pred = pred.reshape(target.shape)
    return torch.sum(torch.abs(pred - target)), target.numel()


@register_metric("rmse")
def _rmse(pred, target):  # finalized with sqrt in Metrics.compute
    pred = pred.reshape(target.shape)
    return torch.sum((pred - target) ** 2), target.numel()


@register_metric("accuracy")
def _accuracy(pred, target):
    if pred.dim() > target.dim():
        predicted = torch.argmax(pred, dim=-1)
    else:
        predicted = (pred.reshape(target.shape) > 0.5).to(target.dtype)
    return torch.sum(predicted == target), target.numel()


class Metrics:
    """A named bundle of streaming metrics with device-side state."""

    def __init__(self, names):
        self.names = list(names or [])
        for name in self.names:
            if name not in _REGISTRY:
                raise ValueError(
                    f"unknown metric {name!r}; available: {sorted(_REGISTRY)}"
                )

    def init_state(self, device) -> Dict[str, Tuple]:
        return {
            n: (torch.zeros((), device=device), torch.zeros((), device=device))
            for n in self.names
        }

    def update(self, state, pred, target):
        out = {}
        for n in self.names:
            add_v, add_w = _REGISTRY[n](pred, target)
            v, w = state[n]
            out[n] = (v + add_v.to(torch.float32), w + float(add_w))
        return out

    def compute(self, state) -> Dict[str, float]:
        if not self.names:
            return {}
        flat = torch.stack([x for n in self.names for x in state[n]]).tolist()
        results = {}
        for i, n in enumerate(self.names):
            v, w = flat[2 * i], flat[2 * i + 1]
            value = v / max(w, 1.0)
            if n == "rmse":
                value = value**0.5
            results[n] = value
        return results
