"""NYCTaxi with ``XGBoostEstimator`` on the port: the counterpart of the
repository's ``examples/nyctaxi_xgboost.py``. A distributed GBDT over SPMD
rank actors on the hosts: xgboost's collective where xgboost is
installed, else the built-in histogram GBDT
(``estimator/gbdt_native.py``)::

    python -m raydp_tpu_torch.examples.nyctaxi_xgboost

``EXAMPLE_ROWS`` (100,000) and ``EXAMPLE_ROUNDS`` (10) size the run.
"""

from __future__ import annotations

import numpy as np

from raydp_tpu_torch.examples._common import knob, owned_runtime, parser
from raydp_tpu_torch.examples.nyctaxi import synthetic_taxi


def gbdt_features(df, F):
    """Hour, day of week and passengers as f32 features, the fare as the
    label."""
    return (
        df.with_column("hour", F.hour("pickup_ts").cast("float32"))
        .with_column("dow", F.dayofweek("pickup_ts").cast("float32"))
        .with_column("pc", F.col("passenger_count").cast("float32"))
        .with_column("label", F.col("fare_amount").cast("float32"))
        .select("hour", "dow", "pc", "label")
    )


def main(argv=None) -> dict:
    """Run the example; returns the fitted estimator and its prediction
    for noon on a Wednesday with 2 passengers."""
    parser(__doc__, device=False).parse_args(argv)

    import raydp_tpu_torch
    from raydp_tpu_torch.estimator import XGBoostEstimator
    from raydp_tpu_torch.etl import functions as F

    with owned_runtime():
        session = raydp_tpu_torch.init_etl(
            "nyctaxi-xgb", num_executors=2, executor_cores=1,
            executor_memory="500M"
        )
        rows = knob("EXAMPLE_ROWS", 100_000)
        df = gbdt_features(
            session.from_pandas(synthetic_taxi(rows), num_partitions=4), F)
        est = XGBoostEstimator(
            params={"objective": "reg:squarederror", "eta": 0.3, "max_depth": 5},
            num_boost_round=knob("EXAMPLE_ROUNDS", 10),
            feature_columns=["hour", "dow", "pc"],
            label_column="label",
            num_workers=2,
        )
        est.fit_on_etl(df)
    model = est.get_model()
    print("backend:", est.backend)
    sample = np.array([[12.0, 3.0, 2.0]])
    prediction = float(np.asarray(model.predict(sample)).reshape(-1)[0])
    print("prediction for noon/wed/2pax:", prediction)
    return {"estimator": est, "prediction": prediction}


if __name__ == "__main__":
    main()
