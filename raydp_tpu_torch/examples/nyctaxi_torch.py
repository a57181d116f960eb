"""NYCTaxi with ``TorchEstimator`` on the port: the counterpart of the
repository's ``examples/nyctaxi_torch.py``. The same ETL pipeline, then a
torch MLP trained by DDP ranks of the SPMD launcher on the card::

    python -m raydp_tpu_torch.examples.nyctaxi_torch [--device cpu]

``EXAMPLE_ROWS`` (100,000) and ``EXAMPLE_EPOCHS`` (5) size the run.
"""

from __future__ import annotations

from raydp_tpu_torch.examples._common import knob, owned_runtime, parser
from raydp_tpu_torch.examples.nyctaxi import synthetic_taxi

FEATURES = ["hour", "dow", "dist", "pc"]


def make_model():
    """The ranks' model: 4 -> 64 -> 32 -> 1 with ReLUs."""
    import torch

    return torch.nn.Sequential(
        torch.nn.Linear(4, 64),
        torch.nn.ReLU(),
        torch.nn.Linear(64, 32),
        torch.nn.ReLU(),
        torch.nn.Linear(32, 1),
    )


def ddp_features(df, F):
    """The feature query of the DDP, Keras and plain-MLP scripts (no
    ``dropna``)."""
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
    )


def main(argv=None) -> dict:
    """Run the example; returns its history and fitted estimator."""
    from raydp_tpu_torch._device import resolve_device

    args = parser(__doc__).parse_args(argv)
    resolve_device(args.device)

    import torch

    import raydp_tpu_torch
    from raydp_tpu_torch.estimator import TorchEstimator
    from raydp_tpu_torch.etl import functions as F
    # the ranks import the creator by name: run as a script this module is
    # __main__, so take it from the package
    from raydp_tpu_torch.examples.nyctaxi_torch import make_model as creator

    with owned_runtime():
        session = raydp_tpu_torch.init_etl(
            "nyctaxi-torch", num_executors=2, executor_cores=1,
            executor_memory="500M"
        )
        rows = knob("EXAMPLE_ROWS", 100_000)
        df = ddp_features(
            session.from_pandas(synthetic_taxi(rows), num_partitions=4), F)
        est = TorchEstimator(
            model=creator,
            optimizer="Adam",
            loss=torch.nn.MSELoss,
            feature_columns=FEATURES,
            label_column="label",
            batch_size=64,
            num_epochs=knob("EXAMPLE_EPOCHS", 5),
            num_workers=2,
            learning_rate=1e-2,
            seed=0,
            device=args.device,
        )
        history = est.fit_on_etl(df)
    for record in history:
        print(record)
    print("final train_loss", history[-1]["train_loss"])
    return {"history": history, "estimator": est}


if __name__ == "__main__":
    main()
