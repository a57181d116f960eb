"""NYCTaxi fare regression, end to end, on the port: the counterpart of
the repository's ``examples/nyctaxi_jax.py``. ETL feature engineering on
the distributed DataFrame engine, exchange into the object store, and
``Estimator``'s ``MLPRegressor`` trained on the card.

Synthetic taxi-shaped data by default; pass a parquet directory of real
NYCTaxi data to run on it::

    python -m raydp_tpu_torch.examples.nyctaxi [PARQUET_DIR] [--device cpu]

``EXAMPLE_ROWS`` (100,000) and ``EXAMPLE_EPOCHS`` (5) size the run.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from raydp_tpu_torch.examples._common import knob, owned_runtime, parser

FEATURES = ["hour", "dow", "dist", "pc"]


def synthetic_taxi(n_rows: int) -> pd.DataFrame:
    """Taxi-shaped rows from ``default_rng(7)``: the JAX script's frame."""
    rng = np.random.default_rng(7)
    base = pd.Timestamp("2020-01-01").value // 10**9
    duration = rng.integers(120, 3600, n_rows)
    return pd.DataFrame(
        {
            "pickup_ts": pd.to_datetime(
                base + rng.integers(0, 30 * 24 * 3600, n_rows), unit="s"
            ),
            "passenger_count": rng.integers(1, 6, n_rows).astype(np.int64),
            "pickup_longitude": -74.0 + rng.random(n_rows) * 0.1,
            "pickup_latitude": 40.7 + rng.random(n_rows) * 0.1,
            "dropoff_longitude": -74.0 + rng.random(n_rows) * 0.1,
            "dropoff_latitude": 40.7 + rng.random(n_rows) * 0.1,
            "fare_amount": 2.5 + duration / 240.0 + rng.random(n_rows),
        }
    )


def taxi_features(df, F):
    """The feature query: hour, day of week, distance and passengers as
    f32 features, the fare as the label."""
    return (
        df.with_column("hour", F.hour("pickup_ts").cast("float32"))
        .with_column("dow", F.dayofweek("pickup_ts").cast("float32"))
        .with_column("dx", F.col("dropoff_longitude") - F.col("pickup_longitude"))
        .with_column("dy", F.col("dropoff_latitude") - F.col("pickup_latitude"))
        .with_column(
            "dist",
            F.sqrt(F.col("dx") * F.col("dx") + F.col("dy") * F.col("dy")).cast("float32"),
        )
        .with_column("pc", F.col("passenger_count").cast("float32"))
        .with_column("label", F.col("fare_amount").cast("float32"))
        .select("hour", "dow", "dist", "pc", "label")
        .dropna()
    )


def fit(model, train_df, test_df, num_epochs: int, device):
    """The estimator's fit of ``model`` (an ``MLPRegressor`` or its state
    from elsewhere): (history, estimator). The ETL session stops once the
    rows are converted."""
    from raydp_tpu_torch.estimator import Estimator

    est = Estimator(
        model=model,
        optimizer="adam",
        loss="mse",
        metrics=["mse", "mae"],
        feature_columns=FEATURES,
        label_column="label",
        batch_size=256,
        num_epochs=num_epochs,
        learning_rate=1e-3,
        device=device,
        # for datasets larger than host memory, pass streaming=True
        # (O(block) memory) or streaming="hybrid" (epoch 1 streams, later
        # epochs scan segments kept on the card)
    )
    history = est.fit_on_etl(train_df, test_df, stop_etl_after_conversion=True)
    return history, est


def main(argv=None) -> dict:
    """Run the example; returns its history and fitted estimator."""
    args_parser = parser(__doc__)
    args_parser.add_argument("parquet", nargs="?", default=None,
                             help="a parquet directory of NYCTaxi rows")
    args = args_parser.parse_args(argv)
    from raydp_tpu_torch._device import resolve_device

    device = resolve_device(args.device)

    import raydp_tpu_torch
    from raydp_tpu_torch.etl import functions as F
    from raydp_tpu_torch.models import MLPRegressor

    with owned_runtime():
        session = raydp_tpu_torch.init_etl(
            "nyctaxi", num_executors=2, executor_cores=2, executor_memory="1G"
        )
        if args.parquet:
            df = session.read_parquet(args.parquet)
        else:
            rows = knob("EXAMPLE_ROWS", 100_000)
            df = session.from_pandas(synthetic_taxi(rows), num_partitions=8)
        train_df, test_df = taxi_features(df, F).random_split([0.9, 0.1], seed=0)
        model = MLPRegressor(len(FEATURES), device=device, seed=0)
        history, est = fit(model, train_df, test_df,
                           knob("EXAMPLE_EPOCHS", 5), device)
    for record in history:
        print(record)
    return {"history": history, "estimator": est}


if __name__ == "__main__":
    main()
