"""The port's estimators: the counterpart of the JAX package's
``estimator`` package, under its names.

``Estimator`` stands where ``JaxEstimator`` does (the flagship, a torch
module on the card); ``TorchEstimator`` (DDP ranks on the card),
``XGBoostEstimator`` and ``TFEstimator`` (both on the hosts' CPUs) are the
parity estimators. ``JaxModel``, the JAX package's flax-module wrapper,
has no counterpart: ``Estimator`` takes a torch module or its creator.

The names resolve at first access, so that a rank which imports one
module of the package (``gbdt_native``, ``tf_estimator``) imports neither
torch nor the other estimators; importing the package never imports
tensorflow or xgboost.
"""

# name -> module of the package that defines it
_LAZY = {
    "EstimatorInterface": "base",
    "EtlEstimatorInterface": "base",
    "Estimator": "estimator",
    "Metrics": "metrics",
    "register_metric": "metrics",
    "TFEstimator": "tf_estimator",
    "TorchEstimator": "torch_estimator",
    "XGBoostEstimator": "xgboost_estimator",
    "latest_checkpoint": "checkpoint",
    "latest_checkpoint_epoch": "checkpoint",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
