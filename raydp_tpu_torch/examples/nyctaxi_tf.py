"""NYCTaxi with ``TFEstimator`` on the port: the counterpart of the
repository's ``examples/nyctaxi_tf.py``. A Keras MLP trained with
``MultiWorkerMirroredStrategy`` ranks of the SPMD launcher on the hosts::

    python -m raydp_tpu_torch.examples.nyctaxi_tf

``EXAMPLE_ROWS`` (100,000) and ``EXAMPLE_EPOCHS`` (5) size the run. Needs
tensorflow.
"""

from __future__ import annotations

from raydp_tpu_torch.examples._common import knob, owned_runtime, parser
from raydp_tpu_torch.examples.nyctaxi import synthetic_taxi
from raydp_tpu_torch.examples.nyctaxi_torch import FEATURES, ddp_features


def make_model():
    """The ranks' model: a Keras 4 -> 64 -> 32 -> 1 MLP with ReLUs."""
    import tensorflow as tf

    return tf.keras.Sequential(
        [
            tf.keras.layers.Input(shape=(4,)),
            tf.keras.layers.Dense(64, activation="relu"),
            tf.keras.layers.Dense(32, activation="relu"),
            tf.keras.layers.Dense(1),
        ]
    )


def main(argv=None) -> dict:
    """Run the example; returns its history and fitted estimator."""
    parser(__doc__, device=False).parse_args(argv)

    import tensorflow as tf

    import raydp_tpu_torch
    from raydp_tpu_torch.estimator import TFEstimator
    from raydp_tpu_torch.etl import functions as F
    # the ranks import the creator by name: run as a script this module is
    # __main__, so take it from the package
    from raydp_tpu_torch.examples.nyctaxi_tf import make_model as creator

    with owned_runtime():
        session = raydp_tpu_torch.init_etl(
            "nyctaxi-tf", num_executors=2, executor_cores=1,
            executor_memory="500M"
        )
        rows = knob("EXAMPLE_ROWS", 100_000)
        df = ddp_features(
            session.from_pandas(synthetic_taxi(rows), num_partitions=4), F)
        est = TFEstimator(
            model=creator,
            optimizer=tf.keras.optimizers.Adam(0.01),
            loss="mse",
            metrics=["mae"],
            feature_columns=FEATURES,
            label_column="label",
            batch_size=64,
            num_epochs=knob("EXAMPLE_EPOCHS", 5),
            num_workers=2,
            seed=0,
        )
        history = est.fit_on_etl(df)
    print("losses:", [round(v, 4) for v in history["loss"]])
    return {"history": history, "estimator": est}


if __name__ == "__main__":
    main()
