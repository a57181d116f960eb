"""``Estimator``: the one-card counterpart of
``raydp_tpu.estimator.JaxEstimator``.

It trains a torch module on a dataset that stages to numpy (``to_numpy`` /
``to_numpy_grouped``; ``exchange.dataset.ArrayDataset`` until the port has
its store), as the JAX estimator's single-device scan runner does: the
training set is staged once, put on the card once, and each epoch gathers
its batches there by index, in the JAX package's order (the rows of
``np.random.default_rng(seed + epoch).shuffle``, the last partial batch
dropped). The loss accumulates on the device; the host reads it once per
epoch. History records are ``{"epoch", "train_loss", "epoch_seconds"}``,
plus ``"eval_loss"`` and ``"eval_<metric>"`` when an evaluation set is
given; ``evaluate`` weights each batch's loss by its rows and includes the
tail batch.

Model, optimizer and loss are given by instance, creator or name:

- model: a torch module (it keeps the weights it carries) or a callable
  taking ``device`` and ``seed`` keywords (a model class of the port, or a
  ``functools.partial`` of one), built on the estimator's device from a
  ``torch.Generator`` seeded by ``seed``;
- optimizer: a name of ``optim.OPTIMIZERS`` (built with
  ``learning_rate``), a factory taking the model's named parameters (as
  ``models.dlrm.dlrm_optimizer()`` returns), or an optimizer instance;
- loss: a name of ``LOSSES`` or a callable ``(pred, target) -> scalar``.

Streaming, checkpoints and resume, retries, a mesh or sharding rules,
profiler capture, wire quantization, ``fit_on_etl`` and the obs spans are
later slices: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch._device import resolve_device
from raydp_tpu_torch.estimator.metrics import Metrics
from raydp_tpu_torch.exchange.features import f0, fmap
from raydp_tpu_torch.optim import OPTIMIZERS


def _loss_mse(pred, target):
    return torch.mean((pred.reshape(target.shape) - target) ** 2)


def _loss_mae(pred, target):
    return torch.mean(torch.abs(pred.reshape(target.shape) - target))


def _loss_bce(pred, target):
    # the mean of optax.sigmoid_binary_cross_entropy
    return F.binary_cross_entropy_with_logits(
        pred.reshape(target.shape).to(target.dtype), target)


def _loss_softmax_ce(pred, target):
    return F.cross_entropy(pred, target.long())


LOSSES = {
    "mse": _loss_mse,
    "mae": _loss_mae,
    "bce": _loss_bce,
    "binary_cross_entropy": _loss_bce,
    "softmax_cross_entropy": _loss_softmax_ce,
    "cross_entropy": _loss_softmax_ce,
}

_STREAMING = "the estimator's streaming sub-slice"
_CHECKPOINTS = "the estimator's checkpoint and resume sub-slice"
_MULTI_GPU = "the multi-GPU slice"
_LATER = {
    "streaming": _STREAMING,
    "stream_wire_quant": _STREAMING,
    "checkpoint_dir": _CHECKPOINTS,
    "resume_from_epoch": _CHECKPOINTS,
    "max_retries": _CHECKPOINTS,
    "mesh": _MULTI_GPU,
    "param_sharding_rules": _MULTI_GPU,
    "profile_dir": "the obs slice (profiler capture)",
}


def _refuse_later(**options) -> None:
    """Raise for an option of a later slice set to anything but its
    default (None, False, or 0 for ``max_retries``)."""
    for name, value in options.items():
        unset = value is None or value is False or (
            name == "max_retries" and value == 0)
        if not unset:
            raise NotImplementedError(
                f"{name}={value!r} is ported in {_LATER[name]}"
            )


class _HostArrays:
    """Staged (features, labels) host arrays; epochs reshuffle indices only.
    ``features`` is one array or a tuple of arrays (mixed-dtype path)."""

    def __init__(self, features, labels: Optional[np.ndarray]):
        self.features = features
        self.labels = labels

    def __len__(self) -> int:
        return len(f0(self.features))

    def order(self, batch_size: int, seed: Optional[int]) -> np.ndarray:
        """One epoch's rows, whole batches only: ``arange(n)`` shuffled by
        ``np.random.default_rng(seed)`` (in order when ``seed`` is None),
        the last partial batch dropped."""
        n = len(self)
        order = np.arange(n)
        if seed is not None:
            np.random.default_rng(seed).shuffle(order)
        return order[: (n // batch_size) * batch_size]


class Estimator:
    def __init__(
        self,
        model: Any = None,
        optimizer: Any = "adam",
        loss: Union[str, Callable] = "mse",
        metrics: Optional[Sequence[str]] = None,
        feature_columns: Optional[Sequence[str]] = None,
        categorical_columns: Optional[Sequence[str]] = None,
        label_column: Optional[str] = None,
        batch_size: int = 64,
        num_epochs: int = 10,
        learning_rate: float = 1e-3,
        mesh: Any = None,
        shuffle: bool = True,
        seed: int = 0,
        checkpoint_dir: Optional[str] = None,
        feature_dtype=np.float32,
        categorical_dtype=np.int32,
        label_dtype=np.float32,
        param_sharding_rules: Optional[Callable] = None,
        profile_dir: Optional[str] = None,
        resume_from_epoch: Optional[int] = None,
        streaming: Union[bool, str] = False,
        stream_wire_quant: Union[bool, str] = False,
        *,
        device=None,
    ):
        _refuse_later(
            streaming=streaming, stream_wire_quant=stream_wire_quant,
            checkpoint_dir=checkpoint_dir, resume_from_epoch=resume_from_epoch,
            mesh=mesh, param_sharding_rules=param_sharding_rules,
            profile_dir=profile_dir,
        )
        self.device = resolve_device(device)
        self._model_arg = model
        self._optimizer_arg = optimizer
        self._loss_arg = loss
        self._metrics = Metrics(metrics)
        self.feature_columns = list(feature_columns or [])
        # mixed-dtype staging (DLRM/Criteo): the named subset of
        # feature_columns is staged as a SECOND array in categorical_dtype and
        # the model receives (dense, ids); integer ids stay exact at any
        # vocab size
        self.categorical_columns = list(categorical_columns or [])
        unknown = [
            c for c in self.categorical_columns if c not in (feature_columns or [])
        ]
        if unknown:
            raise ValueError(
                f"categorical_columns {unknown} not in feature_columns"
            )
        if self.categorical_columns and not np.issubdtype(
            np.dtype(categorical_dtype), np.integer
        ):
            # a float categorical_dtype would reintroduce the id collisions
            # this path exists to prevent
            raise ValueError(
                f"categorical_dtype must be an integer dtype, got "
                f"{np.dtype(categorical_dtype)}"
            )
        self.categorical_dtype = categorical_dtype
        self.label_column = label_column
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.learning_rate = learning_rate
        self.shuffle = shuffle
        self.seed = seed
        self.feature_dtype = feature_dtype
        self.label_dtype = label_dtype
        self._model: Optional[nn.Module] = None
        self._history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    # component resolution
    # ------------------------------------------------------------------

    def _resolve_model(self) -> nn.Module:
        model = self._model_arg
        if model is None:
            raise ValueError(
                "Estimator needs a model (a torch module, or a callable "
                "taking device and seed)"
            )
        if not isinstance(model, nn.Module):
            model = model(device=self.device, seed=self.seed)
        return model.to(self.device)

    def _resolve_optimizer(self, model: nn.Module):
        opt = self._optimizer_arg
        if isinstance(opt, str):
            factory = OPTIMIZERS.get(opt)
            if factory is None:
                raise ValueError(
                    f"unknown optimizer {opt!r}; available: {sorted(OPTIMIZERS)}"
                )
            opt = factory(self.learning_rate)
        if callable(opt):
            return opt(list(model.named_parameters()))
        return opt

    def _resolve_loss(self):
        if callable(self._loss_arg):
            return self._loss_arg
        if self._loss_arg in LOSSES:
            return LOSSES[self._loss_arg]
        raise ValueError(
            f"unknown loss {self._loss_arg!r}; available: {sorted(LOSSES)}"
        )

    def _feature_groups(self):
        """None, or the ``[(dense_cols, feature_dtype), (cat_cols,
        categorical_dtype)]`` staging spec when categorical columns are
        configured -- features then flow as a (dense, ids) tuple end to end.
        An all-categorical model drops the empty dense group (features are
        then a 1-tuple of the id matrix)."""
        if not self.categorical_columns:
            return None
        cat_set = set(self.categorical_columns)
        dense = [c for c in self.feature_columns if c not in cat_set]
        groups = []
        if dense:
            groups.append((dense, self.feature_dtype))
        groups.append((list(self.categorical_columns), self.categorical_dtype))
        return groups

    def _stage_host(self, ds) -> _HostArrays:
        groups = self._feature_groups()
        if groups is not None:
            features, labels = ds.to_numpy_grouped(
                groups, self.label_column, label_dtype=self.label_dtype
            )
        else:
            features, labels = ds.to_numpy(
                self.feature_columns,
                self.label_column,
                feature_dtype=self.feature_dtype,
                label_dtype=self.label_dtype,
            )
        return _HostArrays(features, labels)

    def _to_device(self, x):
        return fmap(lambda a: torch.as_tensor(a).to(self.device), x)

    # ------------------------------------------------------------------
    # fit / evaluate
    # ------------------------------------------------------------------

    def fit(self, train_ds, evaluate_ds=None,
            max_retries: int = 0) -> List[Dict[str, float]]:
        _refuse_later(max_retries=max_retries)
        model = self._resolve_model()
        opt = self._resolve_optimizer(model)
        loss_fn = self._resolve_loss()
        train = self._stage_host(train_ds)
        if train.labels is None:
            raise ValueError("fit needs a label_column")
        batch = self.batch_size
        steps = len(train) // batch
        if steps == 0:
            raise ValueError(
                f"{len(train)} training rows make no full batch of {batch}"
            )
        eval_source = (
            self._stage_host(evaluate_ds) if evaluate_ds is not None else None
        )
        # the training set goes to the card once; batches gather there
        xs, ys = self._to_device(train.features), self._to_device(train.labels)

        self._history = []
        for epoch in range(self.num_epochs):
            t0 = time.perf_counter()
            model.train()
            seed = self.seed + epoch if self.shuffle else None
            perm = torch.from_numpy(train.order(batch, seed)).to(self.device)
            loss_sum = torch.zeros((), device=self.device)
            for step in range(steps):
                idx = perm[step * batch:(step + 1) * batch]
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model(fmap(lambda a: a[idx], xs)), ys[idx])
                loss.backward()
                opt.step()
                loss_sum += loss.detach()
            # the epoch's one host sync
            record: Dict[str, Any] = {
                "epoch": epoch, "train_loss": loss_sum.item() / steps,
                "epoch_seconds": time.perf_counter() - t0,
            }
            if eval_source is not None:
                record.update(self._evaluate(model, loss_fn, eval_source))
            self._history.append(record)
        self._model = model
        return self._history

    @torch.no_grad()
    def _evaluate(self, model, loss_fn, source: _HostArrays) -> Dict[str, float]:
        """Row-weighted loss and metrics over every row, the tail batch
        included, in order."""
        if source.labels is None:
            raise ValueError("evaluation needs a label_column")
        model.eval()
        xs, ys = self._to_device(source.features), self._to_device(source.labels)
        mstate = self._metrics.init_state(self.device)
        loss_sum = torch.zeros((), device=self.device)
        n, batch = len(source), self.batch_size
        for start in range(0, n, batch):
            x = fmap(lambda a: a[start:start + batch], xs)
            y = ys[start:start + batch]
            pred = model(x)
            mstate = self._metrics.update(mstate, pred, y)
            loss_sum = loss_sum + loss_fn(pred, y) * len(y)
        out = {"eval_loss": loss_sum.item() / max(n, 1)}
        out.update({f"eval_{k}": v for k, v in self._metrics.compute(mstate).items()})
        return out

    def evaluate(self, ds) -> Dict[str, float]:
        """Evaluation with the trained model."""
        if self._model is None:
            raise RuntimeError("call fit() first")
        return self._evaluate(self._model, self._resolve_loss(),
                              self._stage_host(ds))

    def predict(self, batch) -> np.ndarray:
        """The trained model on a host feature batch (a numpy array, or a
        tuple of arrays on the mixed-dtype path); returns f32 numpy."""
        if self._model is None:
            raise RuntimeError("call fit() first")
        self._model.eval()
        with torch.no_grad():
            out = self._model(self._to_device(batch))
        return out.float().cpu().numpy()

    def get_model(self) -> nn.Module:
        """The trained module, callable on tensors or numpy arrays."""
        if self._model is None:
            raise RuntimeError("call fit() first")
        return self._model

    @property
    def history(self) -> List[Dict[str, float]]:
        return self._history

    def fit_on_etl(self, *args, **kwargs):
        raise NotImplementedError(
            "fit_on_etl is ported with the port's store and ETL engine (the "
            "cluster slice); stage through exchange.dataset.ArrayDataset"
        )

    def explain_last_fit(self, *args, **kwargs):
        raise NotImplementedError(
            "the fit's obs spans (explain_last_fit) are ported in the obs slice"
        )
