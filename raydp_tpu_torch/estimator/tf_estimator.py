"""``TFEstimator``: the port's counterpart of the JAX package's
``TFEstimator`` (``raydp_tpu/estimator/tf_estimator.py``), the Keras
parity estimator.

The reference's TFEstimator serializes the keras model, optimizer and loss,
ships them to Ray Train's TensorflowTrainer workers, and trains under
``MultiWorkerMirroredStrategy``. Here the workers are ranks of the port's
SPMD launcher: each rank writes its own ``TF_CONFIG`` (cluster = every
rank's ``host:port`` from ``job.worker_addresses()``, task = its rank)
before it imports tensorflow, as MWMS expects, and reads its equal share of
the store's ``Dataset``.

It runs on the CPU in the port as in the JAX package: tensorflow trains on
the hosts, never on the card (the card's machine has no tensorflow). The
ranks are fresh interpreters of the cluster runtime, not forks of its
zygote, so tensorflow starts in a process of its own, without torch. Tensorflow is
imported only inside the rank, ``_serialize`` and ``get_model``, so that
importing the estimator package never pulls it in.

Serialization matches the reference: keras model -> JSON config + initial
weights; optimizer/loss -> keras serialize dicts (instances) or plain names
(strings), rebuilt inside the strategy scope on every worker.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from raydp_tpu_torch.estimator.base import EstimatorInterface, EtlEstimatorInterface


class _TFWorkerFn:
    """Picklable per-rank training closure."""

    def __init__(self, config: Dict[str, Any], shards, eval_shards, addrs: List[str]):
        self.config = config
        self.shards = shards
        self.eval_shards = eval_shards
        self.addrs = addrs

    def __call__(self, ctx):
        import json
        import os

        # cluster spec = every rank's OWN host:port (job.worker_addresses),
        # so MWMS collectives rendezvous across hosts — the reference gets
        # this from Ray Train's TF_CONFIG assembly (tf/estimator.py:160)
        os.environ["TF_CONFIG"] = json.dumps(
            {
                "cluster": {"worker": list(self.addrs)},
                "task": {"type": "worker", "index": ctx.rank},
            }
        )
        os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
        import tensorflow as tf

        cfg = self.config
        if ctx.world_size > 1:
            strategy = tf.distribute.MultiWorkerMirroredStrategy()
        else:
            strategy = tf.distribute.get_strategy()  # no-op strategy

        with strategy.scope():
            model = tf.keras.models.model_from_json(cfg["model_json"])
            if cfg["weights"] is not None:
                model.set_weights([np.asarray(w) for w in cfg["weights"]])
            optimizer = tf.keras.optimizers.deserialize(dict(cfg["optimizer"]))
            loss_obj = (
                tf.keras.losses.deserialize(dict(cfg["loss"]))
                if isinstance(cfg["loss"], dict)
                else tf.keras.losses.get(cfg["loss"])
            )
            # build optimizer slots up front (Keras 3 requires explicit build)
            optimizer.build(model.trainable_variables)

        shard = self.shards[ctx.rank]
        features, labels = shard.to_numpy(
            cfg["feature_columns"], cfg["label_column"]
        )
        batch = cfg["batch_size"]
        dataset = tf.data.Dataset.from_tensor_slices((features, labels))
        if cfg["shuffle"]:
            dataset = dataset.shuffle(len(features), seed=cfg["seed"])
        dataset = dataset.batch(batch, drop_remainder=True).repeat()
        # ranks already hold disjoint equal shards: MWMS must not re-shard
        options = tf.data.Options()
        options.experimental_distribute.auto_shard_policy = (
            tf.data.experimental.AutoShardPolicy.OFF
        )
        dataset = dataset.with_options(options)
        steps_per_epoch = max(1, len(features) // batch)
        dist_iter = iter(strategy.experimental_distribute_dataset(dataset))

        # Custom strategy.run loop: Keras 3's model.fit no longer supports
        # MultiWorkerMirroredStrategy (the reference's TF2 path did); the
        # gradient all-reduce rides strategy's collectives in apply_gradients.
        @tf.function
        def train_step(x, y):
            def replica_step(x, y):
                with tf.GradientTape() as tape:
                    pred = tf.reshape(model(x, training=True), tf.shape(y))
                    per_example = loss_obj(y, pred)
                    loss = tf.reduce_mean(per_example)
                grads = tape.gradient(loss, model.trainable_variables)
                optimizer.apply_gradients(zip(grads, model.trainable_variables))
                return loss

            per_replica = strategy.run(replica_step, args=(x, y))
            return strategy.reduce(
                tf.distribute.ReduceOp.MEAN, per_replica, axis=None
            )

        eval_arrays = None
        if self.eval_shards is not None:
            eval_arrays = self.eval_shards[ctx.rank].to_numpy(
                cfg["feature_columns"], cfg["label_column"]
            )

        history: Dict[str, List[float]] = {"loss": []}
        for _ in range(cfg["num_epochs"]):
            total = 0.0
            for _ in range(steps_per_epoch):
                x, y = next(dist_iter)
                total += float(train_step(x, y))
            history["loss"].append(total / steps_per_epoch)
            if eval_arrays is not None:
                ef, el = eval_arrays
                pred = model(tf.convert_to_tensor(ef), training=False)
                eval_loss = float(
                    tf.reduce_mean(loss_obj(el, tf.reshape(pred, el.shape)))
                )
                history.setdefault("val_loss", []).append(eval_loss)

        weights = (
            [np.asarray(w) for w in model.get_weights()] if ctx.rank == 0 else None
        )
        return {"history": history, "weights": weights}


class TFEstimator(EstimatorInterface, EtlEstimatorInterface):
    def __init__(
        self,
        model: Any = None,  # keras model instance or zero-arg creator fn
        optimizer: Any = "adam",
        loss: Any = "mse",
        metrics: Optional[Sequence[str]] = None,
        feature_columns: Optional[Sequence[str]] = None,
        label_column: Optional[str] = None,
        batch_size: int = 64,
        num_epochs: int = 10,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self._model_arg = model
        self._optimizer_arg = optimizer
        self._loss_arg = loss
        self.metrics = list(metrics or [])
        self.feature_columns = list(feature_columns or [])
        self.label_column = label_column
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed
        self._weights: Optional[List[np.ndarray]] = None
        self._model_json: Optional[str] = None
        self._history: Dict[str, List[float]] = {}

    def _serialize(self) -> Dict[str, Any]:
        """Keras model/optimizer/loss → shippable dicts (reference :98-136)."""
        import tensorflow as tf

        model = self._model_arg
        if callable(model) and not isinstance(model, tf.keras.Model):
            model = model()
        self._model_json = model.to_json()
        weights = [np.asarray(w) for w in model.get_weights()]

        optimizer = self._optimizer_arg
        if isinstance(optimizer, str):
            optimizer = tf.keras.optimizers.get(optimizer)
        optimizer_cfg = tf.keras.optimizers.serialize(optimizer)

        loss = self._loss_arg
        if not isinstance(loss, str):
            loss = tf.keras.losses.serialize(
                loss if not isinstance(loss, type) else loss()
            )
        return {
            "model_json": self._model_json,
            "weights": weights,
            "optimizer": optimizer_cfg,
            "loss": loss,
            "metrics": self.metrics,
            "feature_columns": self.feature_columns,
            "label_column": self.label_column,
            "batch_size": self.batch_size,
            "num_epochs": self.num_epochs,
            "shuffle": self.shuffle,
            "seed": self.seed,
        }

    def fit(self, train_ds, evaluate_ds=None, max_retries: int = 0):
        from raydp_tpu_torch.spmd import create_spmd_job

        attempts = 0
        while True:
            try:
                cfg = self._serialize()
                shards = train_ds.split(self.num_workers, equal=True)
                eval_shards = (
                    evaluate_ds.split(self.num_workers, equal=True)
                    if evaluate_ds is not None
                    else None
                )
                job = create_spmd_job(
                    world_size=self.num_workers, placement_strategy="SPREAD"
                ).start()
                try:
                    # resolve AFTER start: each rank's address must point at
                    # the host it actually landed on, not the driver's
                    worker_fn = _TFWorkerFn(
                        cfg, shards, eval_shards, job.worker_addresses()
                    )
                    results = job.run(worker_fn, timeout=900.0)
                finally:
                    job.stop()
                self._history = results[0]["history"]
                self._weights = results[0]["weights"]
                return self._history
            except Exception:
                attempts += 1
                if attempts > max_retries:
                    raise

    # fit_on_etl (incl. the fs_directory parquet staging path) is inherited
    # from EtlEstimatorInterface — shared by every estimator

    def get_model(self):
        """Rebuild the trained keras model (reference :270-274)."""
        import tensorflow as tf

        if self._weights is None:
            raise RuntimeError("call fit() first")
        model = tf.keras.models.model_from_json(self._model_json)
        model.set_weights(self._weights)
        return model

    @property
    def history(self) -> Dict[str, List[float]]:
        return self._history
