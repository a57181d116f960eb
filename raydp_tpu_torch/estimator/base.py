"""Estimator interfaces: the port's copy of ``raydp_tpu/estimator/base.py``.

``EstimatorInterface`` is the sklearn-style contract (fit on datasets,
export a model). ``EtlEstimatorInterface`` adds ``fit_on_etl``, which
converts ETL DataFrames through the exchange layer; the port has no ETL
engine or store yet, so it raises until the ETL slice (ROADMAP Queue 1).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Optional


class EstimatorInterface(ABC):
    """sklearn-style estimator: fit on datasets, export a model."""

    @abstractmethod
    def fit(self, train_ds, evaluate_ds=None, max_retries: int = 0) -> Any:
        ...

    @abstractmethod
    def get_model(self) -> Any:
        ...


class EtlEstimatorInterface(ABC):
    """Adds ``fit_on_etl``: ETL DataFrames in, converted through the
    exchange layer (the JAX package's parquet and object-store paths)."""

    def fit_on_etl(
        self,
        train_df,
        evaluate_df=None,
        fs_directory: Optional[str] = None,
        stop_etl_after_conversion: bool = False,
        max_retries: int = 0,
    ) -> Any:
        raise NotImplementedError(
            "fit_on_etl is ported with the port's store and ETL engine (the "
            "ETL slice); stage through exchange.dataset.ArrayDataset"
        )
