"""Optimizers with optax's semantics and defaults, for the port's estimator.

An optimizer is given to the estimator as a *factory*: a callable that takes
the model's named parameters (a list of ``(name, Parameter)``) and returns
an object with ``step()`` and ``zero_grad()``. This is the counterpart of an
optax ``GradientTransformation``, which is built without the parameters and
initialised on them later. The estimator resolves the names of
``OPTIMIZERS`` with its learning rate, as the JAX package resolves
``getattr(optax, name)``.

- ``adam``: ``torch.optim.Adam`` computes what ``optax.adam`` computes with
  the same defaults (b1 0.9, b2 0.999, eps 1e-8).
- ``sgd``: plain gradient descent, no momentum (``optax.sgd``'s default).
- ``adamw``: ``torch.optim.AdamW`` with optax's weight decay, 1e-4 (torch's
  default is 1e-2).
- ``adafactor``: ``Adafactor``, written to match ``optax.adafactor``;
  ``torch.optim.Adafactor`` is a different algorithm.
- ``multi_transform``: one factory per label over the parameters a
  labelling function gives that label (``optax.multi_transform``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

# optax's defaults, which no caller changes
ADAMW_WEIGHT_DECAY = 1e-4
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


def _params(named_params):
    return [p for _, p in named_params]


def adam(learning_rate: float):
    return lambda named: torch.optim.Adam(_params(named), lr=learning_rate)


def sgd(learning_rate: float):
    return lambda named: torch.optim.SGD(_params(named), lr=learning_rate)


def adamw(learning_rate: float):
    return lambda named: torch.optim.AdamW(_params(named), lr=learning_rate,
                                           weight_decay=ADAMW_WEIGHT_DECAY)


def adafactor(learning_rate: float | None = None,
              min_dim_size_to_factor: int = 128):
    return lambda named: Adafactor(_params(named), learning_rate,
                                   min_dim_size_to_factor)


OPTIMIZERS = {"adam": adam, "adamw": adamw, "sgd": sgd, "adafactor": adafactor}


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's rule: the two largest axes (d1 the smaller, d0 the larger),
    or None when the array has fewer than two axes or its second-largest
    axis is below ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` with its defaults (no momentum, no weight decay):

    1. ``scale_by_factored_rms``: decay ``1 - (t + 1)^-0.8`` at step t
       (from 0), ``g^2 + eps`` (eps 1e-30) averaged into row and column
       statistics for a factored parameter, or a full second moment;
    2. ``clip_by_block_rms(1.0)``: each update divided by
       ``max(1, rms(update))``;
    3. scaled by the learning rate (when given);
    4. ``scale_by_param_block_rms``: scaled by ``max(rms(param), 1e-3)``;
    5. subtracted from the parameter.

    The row/column statistics are optax's for either orientation of a
    matrix (a flax kernel is the transpose of an ``nn.Linear`` weight), as
    the factored update is symmetric in the two axes."""

    def __init__(self, params, lr: float | None = None,
                 min_dim_size_to_factor: int = 128):
        defaults = dict(lr=lr, min_dim_size_to_factor=min_dim_size_to_factor)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, self.state[p], group)

    @staticmethod
    def _update(p, g, state, group) -> None:
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"] = p.new_zeros(tuple(np.delete(p.shape, d0)))
                state["v_col"] = p.new_zeros(tuple(np.delete(p.shape, d1)))
        t = torch.tensor(state["step"] + 1, dtype=torch.float32)
        decay = float(1.0 - t ** (-ADAFACTOR_DECAY_RATE))
        grad_sqr = g * g + ADAFACTOR_EPS
        if dims is None:
            v = state["v"].mul_(decay).add_((1.0 - decay) * grad_sqr)
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(decay).add_(
                (1.0 - decay) * grad_sqr.mean(dim=d0))
            v_col = state["v_col"].mul_(decay).add_(
                (1.0 - decay) * grad_sqr.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean).pow(-0.5)
            col_factor = v_col.pow(-0.5)
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        state["step"] += 1
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / ADAFACTOR_CLIPPING_THRESHOLD, min=1.0)
        if group["lr"] is not None:
            u = u * group["lr"]
        p_rms = torch.sqrt(torch.mean(p * p))
        u = u * torch.where(p_rms <= ADAFACTOR_MIN_SCALE, ADAFACTOR_MIN_SCALE,
                            p_rms)
        p.add_(-u)


class MultiTransform:
    """One optimizer per label, each over the parameters labelled so (the
    counterpart of ``optax.multi_transform``)."""

    def __init__(self, named_params, transforms: Mapping[str, Callable],
                 label_fn: Callable[[str], str]):
        groups: Dict[str, list] = {}
        for name, p in named_params:
            groups.setdefault(label_fn(name), []).append((name, p))
        unknown = sorted(set(groups) - set(transforms))
        if unknown:
            raise ValueError(f"labels {unknown} have no transform; known: "
                             f"{sorted(transforms)}")
        self.optimizers = {label: transforms[label](group)
                           for label, group in groups.items()}

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()

    def state_dict(self) -> dict:
        """Each label's optimizer state, for checkpoints."""
        return {label: opt.state_dict() for label, opt in self.optimizers.items()}

    def load_state_dict(self, state: Mapping[str, dict]) -> None:
        if set(state) != set(self.optimizers):
            raise ValueError(f"state has labels {sorted(state)}, the "
                             f"optimizer {sorted(self.optimizers)}")
        for label, opt in self.optimizers.items():
            opt.load_state_dict(state[label])


def multi_transform(transforms: Mapping[str, Callable],
                    label_fn: Callable[[str], str]):
    """A factory of ``MultiTransform``: ``transforms`` maps a label to an
    optimizer factory, ``label_fn`` a parameter name to its label."""
    return lambda named: MultiTransform(named, transforms, label_fn)
