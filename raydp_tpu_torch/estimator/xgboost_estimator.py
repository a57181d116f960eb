"""``XGBoostEstimator``: the port's counterpart of the JAX package's
``XGBoostEstimator`` (``raydp_tpu/estimator/xgboost_estimator.py``),
distributed GBDT.

The reference's XGBoostEstimator delegates to ``xgboost_ray``'s
Rabit-allreduce actors. GBDT is host-side math, so this estimator runs on
the hosts' CPUs in the port too, never on the card: xgboost's own
collective training across the port's SPMD rank actors when ``xgboost`` is
installed, rendezvousing at a tracker on the driver (its address from
``cluster.api.head_tcp_addr``), and otherwise the native histogram GBDT
(``estimator/gbdt_native.py``). The card's machine has no ``xgboost``, so
``backend="auto"`` takes the native one there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from raydp_tpu_torch.estimator.base import EstimatorInterface, EtlEstimatorInterface


def _have_xgboost() -> bool:
    try:
        import xgboost  # noqa: F401

        return True
    except ImportError:
        return False


class _XGBWorkerFn:
    """Per-rank training: xgboost collective (Rabit successor) over TCP,
    rendezvousing at the driver-hosted tracker."""

    def __init__(self, config: Dict[str, Any], shards, eval_shards,
                 worker_args: Dict[str, Any]):
        self.config = config
        self.shards = shards
        self.eval_shards = eval_shards
        self.worker_args = worker_args  # tracker coordinates from the driver

    def __call__(self, ctx):
        import xgboost as xgb

        cfg = self.config
        features, labels = self.shards[ctx.rank].to_numpy(
            cfg["feature_columns"], cfg["label_column"]
        )
        dtrain = xgb.DMatrix(features, label=labels)
        evals = []
        if self.eval_shards is not None:
            ef, el = self.eval_shards[ctx.rank].to_numpy(
                cfg["feature_columns"], cfg["label_column"]
            )
            evals = [(xgb.DMatrix(ef, label=el), "eval")]

        if ctx.world_size > 1:
            args = dict(self.worker_args)
            args["dmlc_task_id"] = str(ctx.rank)
            with xgb.collective.CommunicatorContext(**args):
                booster = xgb.train(
                    cfg["params"], dtrain, num_boost_round=cfg["num_boost_round"],
                    evals=evals,
                )
        else:
            booster = xgb.train(
                cfg["params"], dtrain, num_boost_round=cfg["num_boost_round"],
                evals=evals,
            )
        return booster.save_raw().decode("latin1") if ctx.rank == 0 else None


def _driver_ip() -> str:
    """The driver's address as seen from the cluster — workers on other
    hosts must be able to reach the tracker (loopback only works when every
    rank shares the driver's machine)."""
    import socket

    try:
        from raydp_tpu_torch.cluster.api import head_tcp_addr

        host, port = head_tcp_addr()[len("tcp://"):].rsplit(":", 1)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((host, int(port)))  # no traffic: routing lookup only
            return s.getsockname()[0]
        finally:
            s.close()
    except Exception:
        return "127.0.0.1"


def _start_tracker(n_workers: int):
    """Driver-side rendezvous tracker (the role xgboost_ray's tracker plays in
    the reference). Returns (tracker_or_None, worker_args)."""
    if n_workers <= 1:
        return None, {}
    from xgboost.tracker import RabitTracker

    tracker = RabitTracker(host_ip=_driver_ip(), n_workers=n_workers)
    tracker.start()
    args = tracker.worker_args()
    return tracker, dict(args)


class XGBoostEstimator(EstimatorInterface, EtlEstimatorInterface):
    """Distributed GBDT (reference xgboost/estimator.py:31-116). Two
    backends behind one API:

    - ``xgboost``: xgboost's own collective training across the port's
      SPMD rank actors, rendezvousing at a driver-hosted RabitTracker;
    - ``native``: the in-repo distributed histogram GBDT
      (estimator/gbdt_native.py) — same sharded-data/reduced-histograms
      shape, no external dependency.

    ``backend="auto"`` (default) picks xgboost when installed, else native.
    """

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        num_boost_round: int = 10,
        feature_columns: Optional[Sequence[str]] = None,
        label_column: Optional[str] = None,
        num_workers: int = 1,
        backend: str = "auto",
    ):
        if backend not in ("auto", "xgboost", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            backend = "xgboost" if _have_xgboost() else "native"
        if backend == "xgboost" and not _have_xgboost():
            raise ImportError(
                "XGBoostEstimator(backend='xgboost') requires the 'xgboost' "
                "package, which is not installed. Use backend='native' (or "
                "'auto') for the built-in distributed histogram GBDT."
            )
        self.backend = backend
        self.params = dict(params or {"objective": "reg:squarederror"})
        self.num_boost_round = num_boost_round
        self.feature_columns = list(feature_columns or [])
        self.label_column = label_column
        self.num_workers = num_workers
        self._raw_model: Optional[str] = None
        self._native_model = None
        self._history: List[Dict[str, float]] = []

    def fit(self, train_ds, evaluate_ds=None, max_retries: int = 0):
        from raydp_tpu_torch.spmd import create_spmd_job

        attempts = 0
        while True:
            try:
                shards = train_ds.split(self.num_workers, equal=True)
                eval_shards = (
                    evaluate_ds.split(self.num_workers, equal=True)
                    if evaluate_ds is not None
                    else None
                )
                if self.backend == "native":
                    from raydp_tpu_torch.estimator import gbdt_native

                    job = create_spmd_job(world_size=self.num_workers).start()
                    try:
                        booster, history = gbdt_native.train_distributed(
                            job, shards, self.params, self.num_boost_round,
                            self.feature_columns, self.label_column,
                        )
                    finally:
                        job.stop()
                    self._native_model = booster
                    self._history = history
                    return booster
                cfg = {
                    "params": self.params,
                    "num_boost_round": self.num_boost_round,
                    "feature_columns": self.feature_columns,
                    "label_column": self.label_column,
                }
                tracker, worker_args = _start_tracker(self.num_workers)
                job = create_spmd_job(world_size=self.num_workers).start()
                try:
                    results = job.run(
                        _XGBWorkerFn(cfg, shards, eval_shards, worker_args),
                        timeout=600.0,
                    )
                finally:
                    job.stop()
                    if tracker is not None:
                        try:
                            tracker.wait_for()
                        except Exception:  # raydp-lint: disable=swallowed-exceptions (tracker join after workers finished is best-effort)
                            pass
                self._raw_model = results[0]
                return self._raw_model
            except Exception:
                attempts += 1
                if attempts > max_retries:
                    raise

    # fit_on_etl (incl. the fs_directory parquet staging path) is inherited
    # from EtlEstimatorInterface — shared by every estimator

    def get_model(self):
        if self.backend == "native":
            if self._native_model is None:
                raise RuntimeError("call fit() first")
            return self._native_model
        import xgboost as xgb

        if self._raw_model is None:
            raise RuntimeError("call fit() first")
        booster = xgb.Booster()
        booster.load_model(bytearray(self._raw_model.encode("latin1")))
        return booster

    @property
    def history(self) -> List[Dict[str, float]]:
        """Per-round train loss (native backend)."""
        return self._history
