"""``Estimator``: the one-card counterpart of
the JAX package's ``JaxEstimator`` (``raydp_tpu/estimator``).

It trains a torch module on a dataset that stages to numpy: the object
store's ``exchange.dataset.Dataset`` (``fit_on_etl`` converts ETL
DataFrames to one) or ``exchange.dataset.ArrayDataset`` (numpy columns in
blocks), in one of two ways:

- **staged** (the default): the training set is staged once, put on the
  card once, and each epoch gathers its batches there by index, in the JAX
  package's order (the rows of ``np.random.default_rng(seed + epoch)
  .shuffle``, the last partial batch dropped), as the JAX estimator's
  single-device scan runner does. With ``save_every_steps`` the epoch runs
  in chunks of that many steps from its start (or its resumed step), a
  step checkpoint after each chunk but the last.
- **streamed** (``streaming=True`` or ``"hybrid"``): epochs read the dataset
  block by block in the streaming order, through the pipeline of
  ``estimator/stream.py`` (``stream_scan_steps`` batches a segment,
  ``stream_prefetch_segments`` in flight, ``stream_wire_quant="int8"`` for
  float features on the wire, ``stream_cache_memory_limit`` for the hybrid
  cache: 1 GiB by default, capped at half the card's memory).
  ``stream_scan_steps=0`` feeds one batch at a time instead. With
  ``stream_executor_decode`` (the default) a ``Dataset`` whose ETL session
  is alive decodes its blocks to numpy on the session's executors
  (``StreamingBatchIterator``); ``stream_stats_["executor_decode"]`` says
  whether any span of the fit was decoded there.

History records are ``{"epoch", "train_loss", "epoch_seconds"}``, plus
``"eval_loss"`` and ``"eval_<metric>"`` when an evaluation set is given;
evaluation weights each batch's loss by its rows (a staged set includes its
tail batch, a streamed one drops it, as the JAX package's do).

Checkpoints and resume (``estimator/checkpoint.py``): with
``checkpoint_dir`` every epoch ends in ``epoch_N`` (model and optimizer
state), ``save_every_steps`` adds ``epoch_N_step_K`` mid-epoch, both
superseded step checkpoints and, with ``keep_checkpoints``, all but the
newest N epoch checkpoints are removed. ``resume_from_epoch`` takes an
epoch (continue after it) or ``(epoch, step)`` (replay the rest of that
epoch), restoring the optimizer's moments. ``fit(..., max_retries=N)``
re-runs a failed fit, resuming from the newest checkpoint this run wrote
(never one left by an earlier fit, and never past the last epoch).

Observability (``raydp_tpu_torch.obs``): the fit runs in the spans
``estimator.fit`` (with ``estimator.compile`` for the model's build and
the first step, ``estimator.epoch`` and ``estimator.eval``), and the step
recorder splits the epochs into ``ingest``/``h2d``/``compute``/``sync``.
``explain_last_fit()`` attributes the fit's wall time from those records,
``fit_stats_`` and ``stream_stats_`` summarize it, and the
``estimator.mfu`` and ``estimator.model_flops_per_sec`` gauges carry the
FLOPs of one step (counted at the first step, ``obs.costmodel.count_flops``)
over the device time (compute and sync). ``profile_dir`` writes a
``torch.profiler`` trace of the fit there (``trace.json``).

Model, optimizer and loss are given by instance, creator or name:

- model: a torch module (it keeps the weights it carries) or a callable
  taking ``device`` and ``seed`` keywords (a model class of the port, or a
  ``functools.partial`` of one), built on the estimator's device from a
  ``torch.Generator`` seeded by ``seed``;
- optimizer: a name of ``optim.OPTIMIZERS`` (built with
  ``learning_rate``), a factory taking the model's named parameters (as
  ``models.dlrm.dlrm_optimizer()`` returns), or an optimizer instance; it
  must have ``state_dict``/``load_state_dict`` for checkpoints;
- loss: a name of ``LOSSES`` or a callable ``(pred, target) -> scalar``.

Options of ``JaxEstimator`` that are not ported, because they name XLA or
cluster machinery the port does not have: ``donate_state`` (XLA buffer
donation; torch updates parameters in place), ``scan_epochs`` and
``scan_memory_limit`` (an epoch as one ``lax.scan``; the port dispatches
its steps from Python, and its hybrid cache's default budget is
``scan_memory_limit``'s 1 GiB), ``shard_direct`` (the estimator feeds
each process's own rows, the partitioner's default), ``sync_every_steps``
(a bound on XLA's dispatch queue on tunneled transports; CUDA bounds its
own launch queue).

Meshes (``mesh=``, a ``parallel.Mesh`` of ranks; by default a 1-D
``"data"`` mesh over every rank of the default process group) and
``param_sharding_rules=`` (``fn(mesh, model) -> {name: Placement}``, as
``models.dlrm_sharding_rules()`` returns):

- each rank runs the fit on its own device, in step with the others; the
  rules split the parameters they name (``parallel.sharding.shard_module``)
  and the optimizer is built on this rank's blocks;
- with D ranks on the data axis, ``batch_size`` (rounded up to a multiple
  of D, ``_effective_batch``) is the rows of each data coordinate's step,
  as it is each process's in the JAX package (the global batch is D
  times it): the ranks at coordinate d stage the d-th equal share of the
  dataset (``ceil(n / D)`` rows, wrapping around), or stream its blocks
  (``streaming_shard_plan``), and shuffle it by the epoch's seed;
- every batch goes through the mesh's ``DataParallelPartitioner``
  (``exchange.torch_io.partitioner_for``), which averages the gradients
  and the loss over the data axis, so every rank reports the global loss;
  evaluation sums its rows, losses and metric states over the data axis;
- checkpoints hold whole tensors: the split parameters and their
  optimizer state are gathered, rank 0 writes, and a resume cuts them to
  the mesh it runs on, of any axis size.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch import obs, sanitize
from raydp_tpu_torch._device import resolve_device
from raydp_tpu_torch.estimator import checkpoint as ckpt
from raydp_tpu_torch.estimator.base import EstimatorInterface, EtlEstimatorInterface
from raydp_tpu_torch.estimator.metrics import Metrics
from raydp_tpu_torch.estimator.stream import StreamRunner, wire_dtype_of
from raydp_tpu_torch.exchange.features import f0, fmap
from raydp_tpu_torch.exchange.torch_io import PrefetchingDeviceIterator, partitioner_for
from raydp_tpu_torch.obs import costmodel
from raydp_tpu_torch.obs import profiler
from raydp_tpu_torch.optim import OPTIMIZERS


def _loss_mse(pred, target):
    return torch.mean((pred.reshape(target.shape) - target) ** 2)


def _loss_mae(pred, target):
    return torch.mean(torch.abs(pred.reshape(target.shape) - target))


def _loss_bce(pred, target):
    # the mean of optax.sigmoid_binary_cross_entropy
    return F.binary_cross_entropy_with_logits(
        pred.reshape(target.shape).to(target.dtype), target)


def _loss_softmax_ce(pred, target):
    return F.cross_entropy(pred, target.long())


LOSSES = {
    "mse": _loss_mse,
    "mae": _loss_mae,
    "bce": _loss_bce,
    "binary_cross_entropy": _loss_bce,
    "softmax_cross_entropy": _loss_softmax_ce,
    "cross_entropy": _loss_softmax_ce,
}

# the hybrid cache's default budget (JaxEstimator's scan_memory_limit)
STREAM_CACHE_DEFAULT_BYTES = 1 << 30
# the wait before a retry, as in the JAX package
RETRY_DELAY_S = 1.0


def _world() -> tuple:
    """(rank, size) of the default process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _HostArrays:
    """Staged (features, labels) host arrays; epochs reshuffle indices only.
    ``features`` is one array or a tuple of arrays (mixed-dtype path)."""

    def __init__(self, features, labels: Optional[np.ndarray]):
        self.features = features
        self.labels = labels

    def __len__(self) -> int:
        return len(f0(self.features))

    def order(self, batch_size: int, seed: Optional[int]) -> np.ndarray:
        """One epoch's rows, whole batches only: ``arange(n)`` shuffled by
        ``np.random.default_rng(seed)`` (in order when ``seed`` is None),
        the last partial batch dropped."""
        n = len(self)
        order = np.arange(n)
        if seed is not None:
            np.random.default_rng(seed).shuffle(order)
        return order[: (n // batch_size) * batch_size]


class Estimator(EstimatorInterface, EtlEstimatorInterface):
    def __init__(
        self,
        model: Any = None,
        optimizer: Any = "adam",
        loss: Union[str, Callable] = "mse",
        metrics: Optional[Sequence[str]] = None,
        feature_columns: Optional[Sequence[str]] = None,
        categorical_columns: Optional[Sequence[str]] = None,
        label_column: Optional[str] = None,
        batch_size: int = 64,
        num_epochs: int = 10,
        learning_rate: float = 1e-3,
        mesh: Any = None,
        shuffle: bool = True,
        seed: int = 0,
        checkpoint_dir: Optional[str] = None,
        feature_dtype=np.float32,
        categorical_dtype=np.int32,
        label_dtype=np.float32,
        param_sharding_rules: Optional[Callable] = None,
        profile_dir: Optional[str] = None,
        resume_from_epoch: Union[int, tuple, None] = None,
        streaming: Union[bool, str] = False,
        stream_cache_memory_limit: Optional[int] = None,
        save_every_steps: Optional[int] = None,
        stream_scan_steps: int = 32,
        stream_prefetch_segments: int = 3,
        keep_checkpoints: Optional[int] = None,
        stream_wire_quant: Union[bool, str] = False,
        stream_executor_decode: bool = True,
        *,
        device=None,
    ):
        from raydp_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a raydp_tpu_torch.parallel.Mesh, "
                            f"got {type(mesh).__name__}")
        if streaming not in (False, True, "hybrid"):
            raise ValueError(f"streaming={streaming!r}: use False, True or "
                             "'hybrid'")
        wire_dtype_of(stream_wire_quant)  # refuse an unknown wire early
        self.device = resolve_device(device)
        self._mesh_arg = mesh
        self.param_sharding_rules = param_sharding_rules
        self._model_arg = model
        self._optimizer_arg = optimizer
        self._loss_arg = loss
        self._metrics = Metrics(metrics)
        self.feature_columns = list(feature_columns or [])
        # mixed-dtype staging (DLRM/Criteo): the named subset of
        # feature_columns is staged as a SECOND array in categorical_dtype and
        # the model receives (dense, ids); integer ids stay exact at any
        # vocab size
        self.categorical_columns = list(categorical_columns or [])
        unknown = [
            c for c in self.categorical_columns if c not in (feature_columns or [])
        ]
        if unknown:
            raise ValueError(
                f"categorical_columns {unknown} not in feature_columns"
            )
        if self.categorical_columns and not np.issubdtype(
            np.dtype(categorical_dtype), np.integer
        ):
            # a float categorical_dtype would reintroduce the id collisions
            # this path exists to prevent
            raise ValueError(
                f"categorical_dtype must be an integer dtype, got "
                f"{np.dtype(categorical_dtype)}"
            )
        self.categorical_dtype = categorical_dtype
        self.label_column = label_column
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.learning_rate = learning_rate
        self.shuffle = shuffle
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.feature_dtype = feature_dtype
        self.label_dtype = label_dtype
        self.profile_dir = profile_dir
        self.resume_from_epoch = resume_from_epoch
        self.streaming = streaming
        self.stream_cache_memory_limit = stream_cache_memory_limit
        self.save_every_steps = save_every_steps
        self.stream_scan_steps = stream_scan_steps
        self.stream_prefetch_segments = max(1, int(stream_prefetch_segments))
        self.keep_checkpoints = keep_checkpoints
        self.stream_wire_quant = stream_wire_quant
        self.stream_executor_decode = bool(stream_executor_decode)
        self._model: Optional[nn.Module] = None
        self._history: List[Dict[str, float]] = []
        self.compile_seconds_: float = 0.0
        self.fit_stats_: Dict[str, Any] = {}
        self.stream_stats_: Dict[str, Any] = {}
        # per fit: the checkpoints written (count, bytes, seconds), and the
        # errors a retry absorbed
        self.checkpoint_stats_: Dict[str, Any] = {}
        self.retried_errors_: List[str] = []

    # ------------------------------------------------------------------
    # component resolution
    # ------------------------------------------------------------------

    def _resolve_model(self) -> nn.Module:
        model = self._model_arg
        if model is None:
            raise ValueError(
                "Estimator needs a model (a torch module, or a callable "
                "taking device and seed)"
            )
        if not isinstance(model, nn.Module):
            model = model(device=self.device, seed=self.seed)
        elif self.param_sharding_rules is not None:
            # the rules cut the parameters in place: the caller's module
            # keeps its whole tensors
            model = copy.deepcopy(model)
        return model.to(self.device)

    def _shard_model(self, model: nn.Module, state=None) -> nn.Module:
        """Load ``state`` (whole tensors) into the model, then keep only
        this rank's blocks of what ``param_sharding_rules`` splits."""
        if state is not None:
            model.load_state_dict(state)
        if self.param_sharding_rules is not None:
            from raydp_tpu_torch.parallel.sharding import Placement, shard_module

            placements = self.param_sharding_rules(self._mesh, model)
            if not isinstance(placements, dict) or not all(
                    isinstance(v, Placement) for v in placements.values()):
                raise TypeError("param_sharding_rules must map parameter "
                                "names to Placements, got "
                                f"{type(placements).__name__}")
            shard_module(model, placements)
        return model

    def _resolve_mesh(self):
        """The mesh given, or a 1-D ``"data"`` mesh over every rank."""
        if self._mesh_arg is not None:
            return self._mesh_arg
        from raydp_tpu_torch.parallel.mesh import make_mesh

        return make_mesh({"data": -1})

    def _effective_batch(self, mesh) -> int:
        """Round the batch up to a multiple of the data axis."""
        data_size = int(mesh.shape.get("data", 1))
        batch = self.batch_size
        if batch % max(1, data_size):
            batch = ((batch // data_size) + 1) * data_size
        return batch

    def _data_coordinate(self) -> tuple:
        """(D, d): the data axis's size and this rank's coordinate on it."""
        size = int(self._mesh.shape.get("data", 1))
        return size, (self._mesh.axis_index("data") if size > 1 else 0)

    def _set_mesh(self) -> None:
        self._mesh = self._resolve_mesh()
        self._batch = self._effective_batch(self._mesh)
        self._partitioner = partitioner_for(self._mesh, "data", True,
                                            self.device)

    def _resolve_optimizer(self, model: nn.Module):
        opt = self._optimizer_arg
        if isinstance(opt, str):
            factory = OPTIMIZERS.get(opt)
            if factory is None:
                raise ValueError(
                    f"unknown optimizer {opt!r}; available: {sorted(OPTIMIZERS)}"
                )
            opt = factory(self.learning_rate)
        if callable(opt):
            return opt(list(model.named_parameters()))
        return opt

    def _resolve_loss(self):
        if callable(self._loss_arg):
            return self._loss_arg
        if self._loss_arg in LOSSES:
            return LOSSES[self._loss_arg]
        raise ValueError(
            f"unknown loss {self._loss_arg!r}; available: {sorted(LOSSES)}"
        )

    def _feature_groups(self):
        """None, or the ``[(dense_cols, feature_dtype), (cat_cols,
        categorical_dtype)]`` staging spec when categorical columns are
        configured -- features then flow as a (dense, ids) tuple end to end.
        An all-categorical model drops the empty dense group (features are
        then a 1-tuple of the id matrix)."""
        if not self.categorical_columns:
            return None
        cat_set = set(self.categorical_columns)
        dense = [c for c in self.feature_columns if c not in cat_set]
        groups = []
        if dense:
            groups.append((dense, self.feature_dtype))
        groups.append((list(self.categorical_columns), self.categorical_dtype))
        return groups

    def _stage_host(self, ds) -> _HostArrays:
        """The dataset as host arrays; with D ranks on the data axis, the
        share of this rank's coordinate d: ``ceil(n / D)`` rows from row
        ``d * ceil(n / D)``, wrapping around, so every coordinate runs the
        same number of steps (the JAX package's per-process staging)."""
        groups = self._feature_groups()
        if groups is not None:
            features, labels = ds.to_numpy_grouped(
                groups, self.label_column, label_dtype=self.label_dtype
            )
        else:
            features, labels = ds.to_numpy(
                self.feature_columns,
                self.label_column,
                feature_dtype=self.feature_dtype,
                label_dtype=self.label_dtype,
            )
        size, coord = self._data_coordinate()
        if size > 1:
            n = len(f0(features))
            per = -(-n // size)
            idx = (np.arange(per) + coord * per) % n
            features = fmap(lambda a: a[idx], features)
            labels = labels[idx] if labels is not None else None
        return _HostArrays(features, labels)

    def _block_batches(self, ds, batch_size: int, seed: Optional[int],
                       shuffle: Optional[bool] = None,
                       segment_rows: Optional[int] = None):
        """One epoch of host batches streamed from ``ds``'s blocks. With
        ``segment_rows`` the items are segment-sized slices and the tail is
        kept (the consumer trims it to whole batches); else batches, the
        last partial one dropped. With D ranks on the data axis, the blocks
        of this rank's coordinate's share (``streaming_shard_plan``)."""
        from raydp_tpu_torch.exchange.dataset import streaming_shard_plan

        size, coord = self._data_coordinate()
        plan = (streaming_shard_plan(ds.counts, size, coord) if size > 1
                else None)
        return ds.iter_batches(
            segment_rows or batch_size, self.feature_columns,
            self.label_column,
            shuffle=self.shuffle if shuffle is None else shuffle, seed=seed,
            drop_last=not segment_rows, feature_dtype=self.feature_dtype,
            label_dtype=self.label_dtype,
            feature_groups=self._feature_groups(), streaming=True,
            executor_decode=self.stream_executor_decode, block_plan=plan,
        )

    def _to_device(self, x):
        def stage(a):
            # on the CPU the tensor shares the caller's array
            sanitize.note_external_host_buffer(a, "Estimator input")
            return torch.as_tensor(a).to(self.device)

        return fmap(stage, x)

    def _stream_cache_budget(self) -> int:
        """The hybrid cache's byte budget: ``stream_cache_memory_limit`` (1
        GiB when unset), at most half the card's memory, which the model
        and its activations need the rest of."""
        budget = self.stream_cache_memory_limit or STREAM_CACHE_DEFAULT_BYTES
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            budget = min(budget, total // 2)
        return budget

    def _epoch_seed(self, epoch: int) -> Optional[int]:
        return self.seed + epoch if self.shuffle else None

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------

    def fit(self, train_ds, evaluate_ds=None,
            max_retries: int = 0) -> List[Dict[str, float]]:
        attempts = 0
        self.retried_errors_ = []
        # retries resume only from checkpoints THIS run wrote: the newest one
        # already on disk (a stale fit's, in a reused dir) is the baseline.
        # Not with more than one rank: only rank 0 writes, and ranks must
        # agree on the resume point (spmd.elastic_fit restarts the gang)
        retry_resume = (max_retries > 0 and bool(self.checkpoint_dir)
                        and _world()[1] == 1)
        baseline = (ckpt.latest_checkpoint(self.checkpoint_dir)
                    if retry_resume else None)
        saved_resume = self.resume_from_epoch
        # a model or optimizer given as an instance carries its state into
        # every attempt: each attempt starts from the state this fit began
        # with (the JAX package re-initializes stateless modules)
        self._start_states = (self._instance_states()
                              if max_retries > 0 else None)
        try:
            while True:
                try:
                    # the collector makes real spans on this thread: the
                    # epoch and compile times and explain_last_fit() read
                    # these records
                    with obs.collect() as fit_records:
                        try:
                            with obs.span("estimator.fit",
                                          epochs=self.num_epochs,
                                          streaming=str(self.streaming),
                                          attempt=attempts):
                                return self._fit_once(train_ds, evaluate_ds)
                        finally:
                            self.last_fit_records_ = fit_records
                except Exception as exc:
                    attempts += 1
                    if attempts > max_retries:
                        raise
                    self.retried_errors_.append(f"{type(exc).__name__}: {exc}")
                    obs.log.warning("fit failed; retrying", attempt=attempts,
                                    error=repr(exc))
                    if retry_resume:
                        self._resume_after_failure(baseline)
                    time.sleep(RETRY_DELAY_S)
        finally:
            # retries must not leak resume state into a later fit() call
            self.resume_from_epoch = saved_resume

    def _instance_states(self):
        """Copies of the state of a model and an optimizer given as
        instances (None for what a name or a factory builds afresh)."""
        model, opt = self._model_arg, self._optimizer_arg
        model_state = ({k: v.detach().to("cpu", copy=True)
                        for k, v in model.state_dict().items()}
                       if isinstance(model, nn.Module) else None)
        opt_state = (copy.deepcopy(opt.state_dict())
                     if hasattr(opt, "state_dict") else None)
        return model_state, opt_state

    def _resume_after_failure(self, baseline) -> None:
        latest = ckpt.latest_checkpoint(self.checkpoint_dir)
        if latest is None or (baseline is not None
                              and ckpt.sort_key(latest) <= ckpt.sort_key(baseline)):
            return
        epoch, step = latest
        if step is not None:
            self.resume_from_epoch = (epoch, step)  # replay the tail
        else:
            # never resume past the end: a crash after the last epoch's
            # checkpoint would return an empty history; re-run the last
            # epoch instead
            resume = min(epoch, self.num_epochs - 2)
            if resume >= 0:
                self.resume_from_epoch = resume

    def _fit_once(self, train_ds, evaluate_ds) -> List[Dict[str, float]]:
        self._set_mesh()
        batch = self._batch
        loss_fn = self._resolve_loss()
        # the step recorder and an armed capture window, once per fit
        recorder = self._step_recorder = profiler.step_recorder()
        self._fit_capture = profiler.armed_capture()
        self._flops_per_step = None
        self._first_step_done = False
        self._fit_step_wall = 0.0
        self.checkpoint_stats_ = {"saves": 0, "bytes": 0, "seconds": 0.0}
        with obs.span("estimator.compile", what="init") as init_span:
            model_state, opt_state = self._start_states or (None, None)
            model = self._shard_model(self._resolve_model(), model_state)
            opt = self._resolve_optimizer(model)
            if opt_state is not None:
                opt.load_state_dict(opt_state)
        self._train = (model, opt, loss_fn)
        self._placements = getattr(model, "placements", {})
        self._partitioned_grads = self._partitioner.partition_step(
            self._grads, params=list(model.parameters()))
        param_dtype = getattr(model, "dtype", None) or next(
            model.parameters()).dtype
        self._peak_info = costmodel.device_peak_flops(
            self.device, "f32" if param_dtype == torch.float32 else "bf16")

        if self.streaming:
            if train_ds.count() == 0:
                raise ValueError("streaming fit on an empty dataset")
            train_source, eval_source = train_ds, evaluate_ds
        else:
            train_source = self._stage_host(train_ds)
            if train_source.labels is None:
                raise ValueError("fit needs a label_column")
            if len(train_source) < batch:
                raise ValueError(f"{len(train_source)} training rows make no "
                                 f"full batch of {batch}")
            eval_source = (self._stage_host(evaluate_ds)
                           if evaluate_ds is not None else None)

        start_epoch = start_step = 0
        if self.resume_from_epoch is not None:
            if not self.checkpoint_dir:
                raise ValueError("resume_from_epoch requires checkpoint_dir")
            resume = self.resume_from_epoch
            epoch, step = resume if isinstance(resume, tuple) else (resume, None)
            # CPU first: the optimizer's load moves its moments to the
            # parameters' device, and keeps its step counts where they were
            state = ckpt.load_state(self.checkpoint_dir, epoch, step,
                                    map_location="cpu")
            self._load_state(model, opt, state)
            start_epoch, start_step = ((epoch + 1, 0) if step is None
                                       else (epoch, step))

        self._history = []
        self.compile_seconds_ = init_span.duration
        with contextlib.ExitStack() as stack:
            if self.profile_dir:
                prof = profiler.start_trace()
                stack.callback(profiler.stop_trace, prof, self.profile_dir)
            run_epoch = self._epoch_runner(train_source, start_epoch,
                                           start_step, stack)
            for epoch in range(start_epoch, self.num_epochs):
                record = self._run_epoch(run_epoch, model, opt, epoch,
                                         start_step if epoch == start_epoch
                                         else 0)
                if record is None:
                    continue
                if eval_source is not None:
                    with obs.span("estimator.eval", epoch=epoch):
                        record.update(self._evaluate(model, loss_fn,
                                                     eval_source))
                self._history.append(record)
                if self.checkpoint_dir:
                    self._save_checkpoint(model, opt, epoch)
                    self._gc_checkpoints(epoch)
        self._model = model
        self._finish_fit_stats()
        return self._history

    def _epoch_runner(self, source, start_epoch: int, start_step: int,
                      stack: contextlib.ExitStack):
        """``run(epoch, start_step, save_cb) -> (loss_sum, steps)`` for the
        fit's path."""
        if not self.streaming:
            return self._staged_runner(source)
        if self.stream_scan_steps > 0 and self.label_column is not None:
            runner = StreamRunner(
                self, self._run_steps,
                lambda epoch, rows: self._block_batches(
                    source, self._batch, self._epoch_seed(epoch),
                    segment_rows=rows))
            self.stream_stats_ = runner.stats
            runner.start(range(start_epoch, self.num_epochs), start_epoch,
                         start_step)
            stack.callback(runner.close)
            return lambda epoch, start, save_cb: runner.run(
                epoch, start, save_cb, self._zero())
        self.stream_stats_ = {"executor_decode": False}
        return lambda epoch, start, save_cb: self._run_stream_steps(
            source, epoch, start, save_cb)

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), device=self.device)

    def _run_epoch(self, run_epoch, model, opt, epoch: int,
                   start_step: int) -> Optional[Dict[str, Any]]:
        recorder = self._step_recorder
        phase_before = recorder.totals()
        steps_before = recorder.steps
        save_cb = ((lambda step: self._save_checkpoint(model, opt, epoch, step))
                   if self.checkpoint_dir and self.save_every_steps else None)
        # the epoch span IS the epoch timer: history's epoch_seconds is read
        # from the record the trace shows
        model.train()
        with obs.span("estimator.epoch", epoch=epoch,
                      resumed_at=start_step) as epoch_span:
            t_loop = time.perf_counter()
            loss_sum, steps = run_epoch(epoch, start_step, save_cb)
            # the epoch's one host sync
            t_s = time.perf_counter()
            loss_total = loss_sum.item()
            recorder.note("sync", time.perf_counter() - t_s)
            self._fit_step_wall += time.perf_counter() - t_loop
            epoch_span.set(steps=steps)
            phase_delta = {k: v - phase_before.get(k, 0.0)
                           for k, v in recorder.totals().items()}
            if phase_delta:
                # the analyzer splits the epoch by these
                epoch_span.set(**{f"{k}_s": round(phase_delta.get(k, 0.0), 6)
                                  for k in profiler.STEP_PHASES})
        obs.metrics.counter("estimator.steps").inc(steps)
        self._update_live_mfu(phase_delta, recorder.steps - steps_before)
        if steps == 0 and start_step > 0:
            # resumed exactly at the epoch's end: nothing trained, so no
            # record; finalize the epoch
            if self.checkpoint_dir:
                self._save_checkpoint(model, opt, epoch)
                self._gc_checkpoints(epoch)
            return None
        return {"epoch": epoch, "train_loss": loss_total / steps,
                "epoch_seconds": epoch_span.duration}

    # -- the steps ---------------------------------------------------------

    def _grads(self, x, y):
        """The forward and the backward of this rank's rows; the loss."""
        model, _, loss_fn = self._train
        loss = loss_fn(model(x), y)
        loss.backward()
        return loss

    def _step(self, x, y, loss_sum):
        _, opt, _ = self._train
        opt.zero_grad(set_to_none=True)
        # the partitioner averages the gradients and the loss over the
        # data axis (nothing with one rank on it)
        loss = self._partitioned_grads(x, y)
        sanitize.checked_step(opt, "Estimator.step")
        return loss_sum + loss.detach()

    def _first_step(self, x, y, loss_sum):
        """The fit's first step, timed as compile (lazy CUDA set-up, as the
        JAX package times its first dispatch) and counted for FLOPs."""
        with obs.span("estimator.compile", what="first_step") as cspan:
            loss_sum, flops = costmodel.count_flops(
                lambda: self._step(x, y, loss_sum))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.compile_seconds_ += cspan.duration
        self._flops_per_step = flops or None
        self._first_step_done = True
        return loss_sum

    def _run_steps(self, batches: Iterable, loss_sum, n: int):
        """Run ``n`` steps from ``(x, y)`` batches and note their compute
        time in the step recorder (the fit's first step is compile, not
        compute)."""
        capture = self._fit_capture
        if capture is not None:
            capture.begin_steps()
        t0 = time.perf_counter()
        compile_s, compiled = 0.0, 0
        for x, y in batches:
            if not self._first_step_done:
                t_c = time.perf_counter()
                loss_sum = self._first_step(x, y, loss_sum)
                compile_s += time.perf_counter() - t_c
                compiled += 1
            else:
                loss_sum = self._step(x, y, loss_sum)
        if n > compiled:
            self._step_recorder.note(
                "compute", time.perf_counter() - t0 - compile_s,
                steps=n - compiled)
        if capture is not None:
            capture.note_step(n)
        return loss_sum

    def _staged_runner(self, train: _HostArrays):
        """The device-resident path: the training set goes to the card once;
        each epoch gathers its batches there by index."""
        batch = self._batch
        steps = len(train) // batch
        xs, ys = self._partitioner.shard_inputs((train.features, train.labels))
        save_every = self.save_every_steps if self.checkpoint_dir else None
        chunk = min(save_every or steps, steps)

        def run(epoch, start_step, save_cb):
            perm = torch.from_numpy(
                train.order(batch, self._epoch_seed(epoch))).to(self.device)
            loss_sum = self._zero()
            done = start_step
            while done < steps:
                n = min(chunk, steps - done)
                idx = [perm[s * batch:(s + 1) * batch]
                       for s in range(done, done + n)]
                loss_sum = self._run_steps(
                    ((fmap(lambda a, i=i: a[i], xs), ys[i]) for i in idx),
                    loss_sum, n)
                done += n
                # the epoch-complete checkpoint is the epoch loop's
                if save_cb is not None and done < steps:
                    save_cb(done)
            return loss_sum, steps - start_step

        return run

    def _run_stream_steps(self, source, epoch: int, start_step: int, save_cb):
        """``stream_scan_steps=0``: one batch at a time from the block
        stream, uploaded a batch ahead."""
        recorder = self._step_recorder
        host_iter = block_iter = self._block_batches(
            source, self._batch, self._epoch_seed(epoch))
        if start_step:
            host_iter = itertools.islice(host_iter, start_step, None)
        train_iter = PrefetchingDeviceIterator(host_iter, self.device,
                                               mesh=self._mesh)
        loss_sum = self._zero()
        steps = start_step
        pending_save = None
        while True:
            h2d0 = train_iter.h2d_s
            t_iter = time.perf_counter()
            try:
                x, y = next(train_iter)
            except StopIteration:
                break
            h2d = train_iter.h2d_s - h2d0
            recorder.note("h2d", h2d)
            recorder.note("ingest", time.perf_counter() - t_iter - h2d)
            if pending_save is not None:
                # deferred a step: a save on the epoch's last step is
                # superseded by the epoch's own checkpoint
                save_cb(pending_save)
                pending_save = None
            loss_sum = self._run_steps([(x, y)], loss_sum, 1)
            steps += 1
            if save_cb is not None and steps % self.save_every_steps == 0:
                pending_save = steps
        self.stream_stats_["executor_decode"] = (
            self.stream_stats_.get("executor_decode", False)
            or bool(getattr(block_iter, "executor_decode_active", False)))
        return loss_sum, steps - start_step

    # -- fit statistics ------------------------------------------------------

    def _update_live_mfu(self, phase_delta: Dict[str, float],
                         steps: int) -> None:
        """Refresh the ``estimator.mfu`` / ``estimator.model_flops_per_sec``
        gauges from one epoch's device time (compute + sync seconds)."""
        flops_step = self._flops_per_step
        device_s = phase_delta.get("compute", 0.0) + phase_delta.get("sync", 0.0)
        if not flops_step or not steps or device_s <= 0.0:
            return
        mfps = flops_step * steps / device_s
        obs.metrics.gauge("estimator.model_flops_per_sec").set(mfps)
        mfu_val = costmodel.mfu(mfps, self._peak_info.get("peak"))
        if mfu_val is not None:
            obs.metrics.gauge("estimator.mfu").set(mfu_val)
        obs.flush_throttled(1.0)

    def _finish_fit_stats(self) -> None:
        recorder = self._step_recorder
        obs.metrics.counter("estimator.fits").inc()
        obs.metrics.gauge("estimator.compile_s").set(self.compile_seconds_)
        totals = recorder.totals()
        device_s = totals.get("compute", 0.0) + totals.get("sync", 0.0)
        flops_step = self._flops_per_step
        steps_total = recorder.steps
        mfps = (flops_step * steps_total / device_s
                if flops_step and steps_total and device_s > 0 else None)
        mfu_val = costmodel.mfu(mfps, self._peak_info.get("peak"))
        self.fit_stats_ = {
            "steps": steps_total,
            "step_phase_seconds": {k: round(v, 6) for k, v in totals.items()},
            "step_wall_s": (round(self._fit_step_wall, 6)
                            if self._fit_step_wall else None),
            "flops_per_step": flops_step,
            "model_flops_per_sec": mfps,
            "mfu": mfu_val,
            "peak_flops": self._peak_info.get("peak"),
            "peak_op_type": self._peak_info.get("op_type"),
            "device_kind": self._peak_info.get("kind"),
            "peak_source": self._peak_info.get("peak_source"),
            "profiler": "on" if recorder.enabled else "off",
        }
        if mfps:
            obs.metrics.gauge("estimator.model_flops_per_sec").set(mfps)
        if mfu_val is not None:
            obs.metrics.gauge("estimator.mfu").set(mfu_val)
        obs.flush_throttled(1.0)

    def explain_last_fit(self, top_k: int = 5) -> dict:
        """Critical-path wall-time attribution of the last ``fit()`` (its
        span tree, epochs split into ingest/h2d/compute/sync by the step
        recorder). The report's ``text`` field is human-readable."""
        records = getattr(self, "last_fit_records_", None)
        if not records:
            raise RuntimeError("no fit has run on this estimator yet")
        return profiler.explain_fit(records, top_k=top_k)

    # ------------------------------------------------------------------
    # evaluate / predict
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _evaluate(self, model, loss_fn, source) -> Dict[str, float]:
        """Row-weighted loss and metrics: a staged set over every row, in
        order, the tail batch included; a streamed one block by block,
        unshuffled, whole batches only."""
        if isinstance(source, _HostArrays):
            if source.labels is None:
                raise ValueError("evaluation needs a label_column")
            xs, ys = self._partitioner.shard_inputs(
                (source.features, source.labels))
            n, batch = len(source), self._batch
            batches = ((fmap(lambda a, s=s: a[s:s + batch], xs),
                        ys[s:s + batch]) for s in range(0, n, batch))
        else:
            batches = PrefetchingDeviceIterator(
                self._block_batches(source, self._batch, None,
                                    shuffle=False), self.device,
                mesh=self._mesh)
        model.eval()
        mstate = self._metrics.init_state(self.device)
        loss_sum = self._zero()
        rows = 0
        for x, y in batches:
            pred = model(x)
            mstate = self._metrics.update(mstate, pred, y)
            loss_sum = loss_sum + loss_fn(pred, y) * len(y)
            rows += len(y)
        if self._data_coordinate()[0] > 1:
            loss_sum, rows, mstate = self._sum_over_data(loss_sum, rows,
                                                         mstate)
        out = {"eval_loss": loss_sum.item() / max(rows, 1)}
        out.update({f"eval_{k}": v for k, v in self._metrics.compute(mstate).items()})
        return out

    def _sum_over_data(self, loss_sum, rows: int, mstate):
        """An evaluation's sums over the data axis: every coordinate's
        rows, loss and metric states."""
        import torch.distributed as dist

        names = self._metrics.names
        flat = torch.stack([loss_sum.float(), torch.tensor(
            float(rows), device=loss_sum.device)]
            + [t.float() for n in names for t in mstate[n]])
        dist.all_reduce(flat, group=self._mesh.group("data"))
        mstate = {n: (flat[2 + 2 * i], flat[3 + 2 * i])
                  for i, n in enumerate(names)}
        return flat[0], int(flat[1].item()), mstate

    def evaluate(self, ds) -> Dict[str, float]:
        """Evaluation with the trained model."""
        if self._model is None:
            raise RuntimeError("call fit() first")
        self._set_mesh()
        source = ds if self.streaming else self._stage_host(ds)
        return self._evaluate(self._model, self._resolve_loss(), source)

    def predict(self, batch) -> np.ndarray:
        """The model on a host feature batch (a numpy array, or a tuple of
        arrays on the mixed-dtype path), after ``fit()`` or a checkpoint
        load; returns f32 numpy."""
        if self._model is None:
            raise RuntimeError(
                "no model: call fit() or load_latest_checkpoint() first")
        self._model.eval()
        with torch.no_grad():
            out = self._model(self._to_device(batch))
        return out.float().cpu().numpy()

    def get_model(self) -> nn.Module:
        """The trained module, callable on tensors or numpy arrays."""
        if self._model is None:
            raise RuntimeError("call fit() first")
        return self._model

    @property
    def history(self) -> List[Dict[str, float]]:
        return self._history

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _save_checkpoint(self, model, opt, epoch: int,
                         step: Optional[int] = None) -> None:
        """Every rank gathers the split tensors whole; rank 0 writes, and
        the ranks wait for it, so the checkpoint is committed for all of
        them when this returns."""
        from raydp_tpu_torch.parallel import sharding

        t0 = time.perf_counter()
        placements = getattr(self, "_placements", {})
        state = {"params": model.state_dict(), "opt_state": opt.state_dict()}
        if placements:
            state = {"params": sharding.gather_state(state["params"],
                                                     placements),
                     "opt_state": sharding.gather_optimizer_state(
                         opt, state["opt_state"])}
        rank, world = _world()
        nbytes = (ckpt.save_state(self.checkpoint_dir, epoch, step, state)
                  if rank == 0 else 0)
        if world > 1:
            torch.distributed.barrier()
        stats = self.checkpoint_stats_
        stats["saves"] += 1
        stats["bytes"] += nbytes
        stats["seconds"] += time.perf_counter() - t0

    def _gc_checkpoints(self, epoch: int) -> None:
        if _world()[0] == 0:  # the writer removes
            ckpt.gc_checkpoints(self.checkpoint_dir, epoch,
                                self.keep_checkpoints)

    def _load_state(self, model, opt, state: dict) -> None:
        """A checkpoint's whole tensors into this rank's model and
        optimizer, cut to the blocks the mesh gives it."""
        from raydp_tpu_torch.parallel import sharding

        placements = getattr(model, "placements", {})
        model.load_state_dict(sharding.scatter_state(state["params"],
                                                     placements))
        if opt is not None:
            opt.load_state_dict(sharding.scatter_optimizer_state(
                opt, state["opt_state"]) if placements else state["opt_state"])

    def _load_params(self, epoch: int, step: Optional[int]) -> dict:
        """Restore a checkpoint's parameters into the model (built when
        there is none); the optimizer state is dropped."""
        state = ckpt.load_state(self.checkpoint_dir, epoch, step,
                                map_location="cpu")
        if self._model is None:
            self._set_mesh()
            self._model = self._shard_model(self._resolve_model())
        self._load_state(self._model, None, state)
        return state["params"]

    def load_checkpoint(self, epoch: int) -> dict:
        """Load epoch ``epoch``'s checkpoint for inference; returns its
        parameters (a state dict)."""
        return self._load_params(epoch, None)

    def load_latest_checkpoint(self):
        """Load the newest committed checkpoint under ``checkpoint_dir``
        (an epoch's own before its step checkpoints) for inference; returns
        ``(epoch, step)``, ``step`` None for an epoch checkpoint."""
        found = ckpt.latest_checkpoint(self.checkpoint_dir)
        if found is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.checkpoint_dir!r}")
        self._load_params(*found)
        return found
