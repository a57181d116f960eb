"""``TorchEstimator``: the port's counterpart of the JAX package's
``TorchEstimator`` (``raydp_tpu/estimator/torch_estimator.py``), the
parity estimator for torch users.

The reference's TorchEstimator delegates to Ray Train's TorchTrainer, whose
DDP workers all-reduce their gradients. Here the workers are ranks of the
port's SPMD launcher (``spmd.create_spmd_job``): one actor a rank, a
``torch.distributed`` group across them, ``DistributedDataParallel``
around the model, and each rank reads its equal share of the store's
``Dataset`` (``split(num_workers, equal=True)``).

Kept from the JAX package: model, optimizer and loss as instances, classes,
names or creator functions (``_build_optimizer``); the per-epoch shuffle by
``np.random.default_rng(seed + epoch)``; ``batch_size`` rows a rank a step,
the remainder dropped; ``eval_loss`` as the mean over every rank's shard;
rank 0's ``state_dict`` back to the driver as numpy and ``get_model``;
``max_retries``, which restarts the whole job; ``fit_on_etl`` and
``fit_on_spark`` from ``EtlEstimatorInterface``.

What the port does its own way:

- the ranks run on the card unless ``device="cpu"`` is asked for (rank r
  takes ``cuda:(r % device_count)``; with no card and no CPU request the
  estimator raises). On the CPU a rank takes one intra-op thread, so the
  ranks of one host in DDP's lockstep do not oversubscribe its cores;
- the group: NCCL where every rank has a card of its own, gloo where the
  ranks share one or run on the CPU (``spmd.bootstrap.default_backend``),
  a group of one at world 1 (DDP needs a group);
- the rank's shard and its evaluation shard are put on the device once,
  and each batch is gathered there by index in the reference's order;
- the epoch's ``train_loss`` is summed on the device in f64, in step
  order, and read once an epoch: the reference adds each step's f32 loss
  to a Python float, which is the same f64 sum, so the history equals the
  reference's bit for bit on the same shards and device. ``eval_loss``
  keeps the reference's f32 sums (each batch's ``loss * rows`` rounded to
  f32, then added in f32), on the device, and is equal too;
- history records add ``epoch_seconds`` (the epoch's training steps);
- ``comm_hook=(state, hook)`` is passed to DDP's ``register_comm_hook``
  on every rank (a compression hook, or a timing hook);
- ``rank_stats_`` holds one record a rank after ``fit``: its pid, device,
  backend, ``setup_s`` (before the first step: the device, the group, the
  model, DDP with the optimizer, the staging; split in ``setup``; DDP's
  first construction imports torch's compiler stack), peak card memory, the kernel layer's launches during the fit
  (``LAUNCHES`` of the ``ops`` modules, by kernel), a SHA-256 of its
  parameters, so that ranks which drifted apart show, and its own history
  (each rank's loss is of its own shard, as in the reference, whose
  ``history`` is rank 0's).

A creator (a function, a class, a ``functools.partial`` of a model of the
port) is called on the ranks and, in ``get_model``, on the driver, never
before the ranks start.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from raydp_tpu_torch import sanitize
from raydp_tpu_torch.estimator.base import EstimatorInterface, EtlEstimatorInterface

RUN_TIMEOUT_S = 600.0  # the job's run, as the reference waits


def _check_device(device) -> str:
    """The ranks' device type: "cuda" unless the caller asks for the CPU;
    raises when CUDA is asked for (or implied) and there is none."""
    from raydp_tpu_torch._device import resolve_device

    return resolve_device("cuda" if device is None else device).type


def rank_device(device_type: str, rank: int):
    """Rank ``rank``'s device: ``cuda:(rank % device_count)``, made
    current, or the CPU with one intra-op thread."""
    import torch

    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        return device
    torch.set_num_threads(1)
    return torch.device("cpu")


def launch_counts() -> Dict[str, int]:
    """The kernel layer's launch counts in this process, by kernel (only
    the ``ops`` modules already imported are read)."""
    from raydp_tpu_torch.obs.profiler import KERNEL_MODULES

    counts: Dict[str, int] = {}
    for name in KERNEL_MODULES:
        counts.update(getattr(sys.modules.get(name), "LAUNCHES", None) or {})
    return counts


def params_digest(module) -> str:
    """SHA-256 of the module's ``state_dict`` values, in order, as bytes."""
    digest = hashlib.sha256()
    for name, tensor in module.state_dict().items():
        digest.update(name.encode())
        digest.update(tensor.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


class _TorchWorkerFn:
    """The per-rank program, shipped to every rank by the SPMD job.

    ``start`` joins the group and builds the DDP model, the optimizer and
    the loss; ``stage`` puts a shard on the device; ``order`` is an epoch's
    row order; ``step`` is one training step. ``__call__`` runs the fit
    from them."""

    def __init__(self, estimator: "TorchEstimator", shards, eval_shards, addr: str):
        self.est_config = {
            "model": estimator._model_arg,
            "optimizer": estimator._optimizer_arg,
            "loss": estimator._loss_arg,
            "feature_columns": estimator.feature_columns,
            "label_column": estimator.label_column,
            "batch_size": estimator.batch_size,
            "num_epochs": estimator.num_epochs,
            "learning_rate": estimator.learning_rate,
            "shuffle": estimator.shuffle,
            "seed": estimator.seed,
            "device": estimator.device_type,
            "comm_hook": estimator.comm_hook,
        }
        self.shards = shards
        self.eval_shards = eval_shards
        self.addr = addr

    def start(self, ctx):
        """Join the group (``tcp://addr``) and build: (device, the DDP
        model, optimizer, loss)."""
        import torch
        import torch.distributed as dist

        from raydp_tpu_torch.spmd.bootstrap import default_backend

        t0 = time.perf_counter()
        cfg = self.est_config
        self.setup = {}
        device = rank_device(cfg["device"], ctx.rank)
        if device.type == "cuda":
            torch.empty(0, device=device)  # the context, timed on its own
        self.setup["device_s"] = time.perf_counter() - t0
        backend = ("gloo" if device.type == "cpu"
                   else default_backend(ctx.world_size))
        dist.init_process_group(backend, init_method=f"tcp://{self.addr}",
                                rank=ctx.rank, world_size=ctx.world_size)
        self.setup["group_s"] = time.perf_counter() - t0 - sum(self.setup.values())
        torch.manual_seed(cfg["seed"])
        model = cfg["model"]
        if callable(model) and not isinstance(model, torch.nn.Module):
            model = model()
        model = model.to(device)
        self.setup["model_s"] = time.perf_counter() - t0 - sum(self.setup.values())
        model = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None)
        if cfg["comm_hook"] is not None:
            model.register_comm_hook(*cfg["comm_hook"])
        optimizer = _build_optimizer(cfg["optimizer"], model, cfg["learning_rate"])
        loss_fn = cfg["loss"]
        if isinstance(loss_fn, type):  # a class (torch.nn.MSELoss)
            loss_fn = loss_fn()
        # else an nn.Module instance or a plain callable(pred, target)
        self.setup["ddp_s"] = time.perf_counter() - t0 - sum(self.setup.values())
        return device, model, optimizer, loss_fn

    def stage(self, shard, device):
        """A shard's features and labels, as f32 tensors on ``device``."""
        import torch

        cfg = self.est_config
        features, labels = shard.to_numpy(cfg["feature_columns"],
                                          cfg["label_column"])
        # on the CPU the tensors share the shard's arrays
        sanitize.note_external_host_buffer(features, "TorchEstimator shard")
        sanitize.note_external_host_buffer(labels, "TorchEstimator shard")
        return (torch.from_numpy(features).to(device),
                torch.from_numpy(labels).to(device))

    def order(self, n: int, epoch: int) -> np.ndarray:
        order = np.arange(n)
        if self.est_config["shuffle"]:
            np.random.default_rng(self.est_config["seed"] + epoch).shuffle(order)
        return order

    @staticmethod
    def step(model, optimizer, loss_fn, xb, yb):
        optimizer.zero_grad()
        pred = model(xb)
        loss = loss_fn(pred.reshape(yb.shape), yb)
        loss.backward()  # DDP all-reduces the gradients here
        sanitize.checked_step(optimizer, "TorchEstimator.step")
        return loss

    def __call__(self, ctx):
        import torch.distributed as dist

        t0, self.started_at = time.perf_counter(), time.time()
        device, model, optimizer, loss_fn = self.start(ctx)
        try:
            return self._fit(ctx, device, model, optimizer, loss_fn, t0)
        finally:
            dist.destroy_process_group()

    def _fit(self, ctx, device, model, optimizer, loss_fn, t0):
        import torch

        cfg = self.est_config
        x, y = self.stage(self.shards[ctx.rank], device)
        evaluation = (self.stage(self.eval_shards[ctx.rank], device)
                      if self.eval_shards is not None else None)
        setup_s = time.perf_counter() - t0
        self.setup["stage_s"] = setup_s - sum(self.setup.values())
        before = launch_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        history = []
        n, batch = len(x), cfg["batch_size"]
        steps = n // batch
        for epoch in range(cfg["num_epochs"]):
            t_epoch = time.perf_counter()
            model.train()
            order = torch.from_numpy(self.order(n, epoch)).to(device)
            total = torch.zeros((), dtype=torch.float64, device=device)
            for s in range(steps):
                idx = order[s * batch:(s + 1) * batch]
                loss = self.step(model, optimizer, loss_fn,
                                 x.index_select(0, idx), y.index_select(0, idx))
                total += loss.detach()
            record = {"epoch": epoch, "train_loss": float(total) / max(steps, 1),
                      "epoch_seconds": time.perf_counter() - t_epoch}
            if evaluation is not None:
                record.update(self._evaluate(model, loss_fn, *evaluation))
            history.append(record)

        after = launch_counts()
        stats = {
            "rank": ctx.rank, "pid": os.getpid(), "device": str(device),
            "setup_s": setup_s, "setup": dict(self.setup),
            "backend": torch.distributed.get_backend(),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "launches": {k: v - before.get(k, 0) for k, v in after.items()},
            "params_sha256": params_digest(model.module),
            "history": history,
            # wall clock, so that the caller can place the fit's other costs
            # (the job's start, the results back) around the rank's program
            "started_at": self.started_at, "ended_at": time.time(),
        }
        state = None
        if ctx.rank == 0:
            state = {k: v.detach().cpu().numpy()
                     for k, v in model.module.state_dict().items()}
        return {"history": history, "state": state, "stats": stats}

    def _evaluate(self, model, loss_fn, features, labels) -> Dict[str, float]:
        """The mean loss over every rank's evaluation shard: each batch's
        loss times its rows, summed in f32 on the device as the reference
        sums them on the host, then all-reduced."""
        import torch
        import torch.distributed as dist

        model.eval()
        batch = self.est_config["batch_size"]
        total = torch.zeros(1, device=features.device)
        count = torch.zeros(1, device=features.device)
        with torch.no_grad():
            for s in range(0, len(features), batch):
                xb, yb = features[s:s + batch], labels[s:s + batch]
                loss = loss_fn(model(xb).reshape(yb.shape), yb)
                total += (loss.double() * len(xb)).float()
                count += len(xb)
        dist.all_reduce(total)
        dist.all_reduce(count)
        return {"eval_loss": float(total) / max(float(count), 1.0)}


def _build_optimizer(opt, model, lr: float):
    import torch

    if opt is None:
        return torch.optim.Adam(model.parameters(), lr=lr)
    if isinstance(opt, str):
        return getattr(torch.optim, opt)(model.parameters(), lr=lr)
    if isinstance(opt, type):
        return opt(model.parameters(), lr=lr)
    if isinstance(opt, torch.optim.Optimizer):
        # an instance: rebuilt on the DDP model's parameters with the same
        # hyperparameters
        return type(opt)(model.parameters(), **dict(opt.defaults))
    if callable(opt):
        return opt(model)
    raise TypeError(f"cannot build optimizer from {type(opt)}")


class TorchEstimator(EstimatorInterface, EtlEstimatorInterface):
    def __init__(
        self,
        model: Any = None,
        optimizer: Any = None,
        loss: Any = None,
        feature_columns: Optional[Sequence[str]] = None,
        label_column: Optional[str] = None,
        batch_size: int = 64,
        num_epochs: int = 10,
        num_workers: int = 1,
        learning_rate: float = 1e-3,
        shuffle: bool = True,
        seed: int = 0,
        device=None,
        comm_hook: Optional[Tuple[Any, Callable]] = None,
    ):
        import torch

        self._model_arg = model
        self._optimizer_arg = optimizer
        self._loss_arg = loss if loss is not None else torch.nn.MSELoss
        self.feature_columns = list(feature_columns or [])
        self.label_column = label_column
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.num_workers = num_workers
        self.learning_rate = learning_rate
        self.shuffle = shuffle
        self.seed = seed
        self.device_type = _check_device(device)
        self.comm_hook = comm_hook
        self._state: Optional[Dict[str, np.ndarray]] = None
        self._history: List[Dict[str, float]] = []
        self.rank_stats_: List[Dict[str, Any]] = []

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
                job = create_spmd_job(
                    world_size=self.num_workers, placement_strategy="SPREAD"
                ).start()
                try:
                    # resolved after start: the group's store listens where
                    # rank 0 landed, not on the driver's host
                    worker_fn = _TorchWorkerFn(
                        self, shards, eval_shards, job.rendezvous_address()
                    )
                    results = job.run(worker_fn, timeout=RUN_TIMEOUT_S)
                finally:
                    job.stop()
                self._history = results[0]["history"]
                self._state = results[0]["state"]
                self.rank_stats_ = [r["stats"] for r in results]
                return self._history
            except Exception:
                attempts += 1
                if attempts > max_retries:
                    raise

    def get_model(self):
        """Rank 0's trained module on the estimator's device (the card
        unless the estimator runs on the CPU)."""
        import torch

        if self._state is None:
            raise RuntimeError("call fit() first")
        model = self._model_arg
        if callable(model) and not isinstance(model, torch.nn.Module):
            model = model()
        model.load_state_dict(
            {k: torch.from_numpy(np.asarray(v)) for k, v in self._state.items()}
        )
        return model.to(self.device_type)

    @property
    def history(self) -> List[Dict[str, float]]:
        return self._history
