"""Estimator interfaces: the port's copy of ``raydp_tpu/estimator/base.py``.

``EstimatorInterface`` is the sklearn-style contract (fit on datasets,
export a model). ``EtlEstimatorInterface`` adds ``fit_on_etl``, which
converts ETL DataFrames (or pandas frames, through the running session)
into the object store's ``Dataset`` and fits on it.
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
    exchange layer."""

    def _check_and_convert(self, df):
        """Adopt the input as an ETL DataFrame. A plain pandas DataFrame is
        distributed through the running session (``etl.session.adopt_frame``
        holds the pandas check, so the estimator imports neither pandas nor
        pyarrow)."""
        from raydp_tpu_torch.etl.session import adopt_frame

        return adopt_frame(df)

    def fit_on_etl(
        self,
        train_df,
        evaluate_df=None,
        fs_directory: Optional[str] = None,
        stop_etl_after_conversion: bool = False,
        max_retries: int = 0,
    ) -> Any:
        """Convert ETL DataFrames and fit. ``fs_directory`` stages through
        parquet on a shared filesystem; otherwise blocks go through the
        object store, with ``stop_etl_after_conversion`` transferring
        ownership so the data outlives the ETL engine."""
        import os

        from raydp_tpu_torch.exchange.dataset import (
            dataframe_to_dataset,
            dataset_from_parquet,
        )

        train_df = self._check_and_convert(train_df)
        if evaluate_df is not None:
            evaluate_df = self._check_and_convert(evaluate_df)

        if fs_directory is not None:
            train_dir = os.path.join(fs_directory, "train")
            train_df.write_parquet(train_dir)
            train_ds = dataset_from_parquet(train_dir)
            evaluate_ds = None
            if evaluate_df is not None:
                eval_dir = os.path.join(fs_directory, "eval")
                evaluate_df.write_parquet(eval_dir)
                evaluate_ds = dataset_from_parquet(eval_dir)
        else:
            train_ds = dataframe_to_dataset(
                train_df, _use_owner=stop_etl_after_conversion
            )
            evaluate_ds = None
            if evaluate_df is not None:
                evaluate_ds = dataframe_to_dataset(
                    evaluate_df, _use_owner=stop_etl_after_conversion
                )
        if stop_etl_after_conversion:
            from raydp_tpu_torch.etl.session import stop_etl

            stop_etl(cleanup_data=False, del_obj_holder=False)
        return self.fit(train_ds, evaluate_ds, max_retries=max_retries)

    # the name users of the Spark-based API know
    def fit_on_spark(self, *args, **kwargs):
        return self.fit_on_etl(*args, **kwargs)
