"""The streamed fit's pipeline: the port's counterpart of
``JaxEstimator._build_stream_runner``.

One producer thread lives for the whole fit. For each epoch it reads the
dataset block by block in the streaming order (``ArrayDataset.iter_batches``),
shapes ``seg`` batches into one segment ([S, B, ...]; ``coalesce_segment``
reshapes a segment-sized slice, a mid-segment resume stacks batches), puts
float leaves on the int8 wire format when asked, and starts the segment's
upload (``SegmentUploader``: pinned buffers, copies on side streams). The
host iterator is itself pulled one segment ahead (``iter_prefetch``), so
block reads, wire encode, staging and the copy overlap the steps. A queue
of ``stream_prefetch_segments`` segments bounds what is in flight, and at
an epoch's end the producer rolls into the next epoch's first segment.

The consumer, on the fit's thread, takes each segment, makes the compute
stream wait for its copy (``Segment.ready``) and runs its S steps, widening
wire leaves per step on the card (``widen_wire``). Step checkpoints fall on
segment boundaries (``seg`` divides ``save_every_steps``) and are written
when the next segment arrives, so a checkpoint always has steps after it;
one at the stream's end is dropped, the epoch's own checkpoint supersedes
it.

``streaming="hybrid"``: the first fully streamed epoch's segments stay on
the card, and later epochs replay them in an order reshuffled per epoch by
``default_rng(seed + epoch)``, with no host reads and no uploads, as long
as they fit ``stream_cache_memory_limit``; past it the cache is dropped and
the fit streams on. A replayed epoch writes no step checkpoints (a
step-resume streams its epoch afresh, in another order).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from raydp_tpu_torch.exchange.features import f_nbytes, f_stack, fmap
from raydp_tpu_torch.exchange.torch_io import (
    SegmentUploader,
    coalesce_segment,
    iter_prefetch,
    quantize_rows,
    widen_wire,
)
from raydp_tpu_torch.obs import metrics

WIRE_DTYPES = ("int8",)


def wire_dtype_of(option) -> Optional[str]:
    """``stream_wire_quant``'s wire dtype: None when off, "int8" for True."""
    if not option:
        return None
    dtype = "int8" if option is True else str(option)
    if dtype not in WIRE_DTYPES:
        raise ValueError(f"stream_wire_quant={option!r}: only 'int8' (or True) "
                         "is supported")
    return dtype


def segment_steps(scan_steps: int, save_every: Optional[int]) -> int:
    """The segment length: ``scan_steps``, lowered to the largest divisor of
    the save cadence, so step checkpoints land on segment boundaries."""
    seg = int(scan_steps)
    if save_every:
        seg = min(seg, save_every)
        while save_every % seg:
            seg -= 1
    return seg


class StreamRunner:
    """The whole-fit pipeline of one streamed fit (see the module
    docstring). ``run_steps(batches, loss_sum, n)`` is the estimator's step
    loop; ``plan(epoch, start_step, segment_rows)`` its host iterator of an
    epoch."""

    def __init__(self, est, run_steps: Callable, plan: Callable):
        self._run_steps = run_steps
        self._plan = plan
        self._batch = est.batch_size
        self._shuffle, self._seed = est.shuffle, est.seed
        self._recorder = est._step_recorder
        self.save_every = (int(est.save_every_steps)
                           if est.checkpoint_dir and est.save_every_steps
                           else None)
        self.seg = segment_steps(est.stream_scan_steps, self.save_every)

        groups = est._feature_groups()
        leaf_dtypes = ([np.dtype(est.feature_dtype)] if groups is None
                       else [np.dtype(dt) for _, dt in groups])
        wire_dtype = wire_dtype_of(est.stream_wire_quant)
        self._wire_flags = [wire_dtype is not None
                            and np.issubdtype(dt, np.floating)
                            for dt in leaf_dtypes]
        self._wire_on = any(self._wire_flags)
        self._leaf_torch_dtypes = [torch.from_numpy(np.zeros(0, dt)).dtype
                                   for dt in leaf_dtypes]
        self._single_leaf = groups is None

        self._uploader = SegmentUploader(
            est.device, depth=max(2, est.stream_prefetch_segments))
        self._depth = est.stream_prefetch_segments
        self.stats: Dict[str, Any] = {
            "bytes_uploaded": 0,
            "bytes_by_epoch": {},
            "producer_idle_s": 0.0,
            "consumer_idle_s": 0.0,
            "segments": 0,
            "segment_steps": self.seg,
            "cached_epochs": 0,
            "staging_buffer_reuse": self._uploader.reuse_host_buffers,
            "staging_copies": 0,
            "upload_streams": self._uploader.upload_streams,
            "wire_dtype": wire_dtype if self._wire_on else None,
            "wire_bytes_saved": 0,
        }
        hybrid = est.streaming == "hybrid"
        self._cache: Optional[List[Any]] = [] if hybrid else None
        self._cache_ready = False
        # set once the consumer has ruled on the cache (sealed or dropped):
        # until then the producer holds at epoch boundaries, since a sealed
        # cache makes every later upload a waste
        self._gate = threading.Event() if hybrid else None
        self._budget = est._stream_cache_budget() if hybrid else 0
        self._q: Optional[queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._start_epoch = 0
        self._start_step = 0

    # -- the wire format ---------------------------------------------------

    def _wire_encode(self, hx):
        """Host half: each float leaf becomes (int8 q, f32 row scales); the
        wire container is a flat tuple ``(leaves..., scales...)``."""
        wire, scales = [], []
        for leaf, flag in zip(hx if isinstance(hx, tuple) else (hx,),
                              self._wire_flags):
            if flag:
                q, s = quantize_rows(np.asarray(leaf))
                wire.append(q)
                scales.append(s)
            else:
                wire.append(np.asarray(leaf))
        return tuple(wire + scales)

    def _step_input(self, x, i: int):
        """Step ``i`` of a segment's features, widened to the model's dtype
        where the wire carried int8."""
        if not self._wire_on:
            return fmap(lambda a: a[i], x)
        nf = len(self._wire_flags)
        scales = iter(x[nf:])
        out = [widen_wire(leaf[i], next(scales)[i], dt) if flag else leaf[i]
               for leaf, flag, dt in zip(x[:nf], self._wire_flags,
                                         self._leaf_torch_dtypes)]
        return out[0] if self._single_leaf else tuple(out)

    # -- the producer ------------------------------------------------------

    def _produce(self, epochs: List[int], out_q: queue.Queue,
                 stop: threading.Event) -> None:
        """Items: a Segment, None at an epoch's end, or an exception to
        raise on the consumer's side."""
        stats = self.stats

        def emit(item) -> bool:
            t0 = time.perf_counter()
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                except queue.Full:
                    continue
                # time parked on a full queue: the consumer is the bound
                idle = time.perf_counter() - t0
                stats["producer_idle_s"] += idle
                metrics.counter("estimator.stream.producer_idle_s").inc(idle)
                return True
            return False

        def upload(hx, hy, epoch):
            logical = f_nbytes(hx) + hy.nbytes
            if self._wire_on:
                hx = self._wire_encode(hx)
            nbytes = f_nbytes(hx) + hy.nbytes
            stats["bytes_uploaded"] += nbytes
            stats["bytes_by_epoch"][epoch] = (
                stats["bytes_by_epoch"].get(epoch, 0) + nbytes)
            stats["wire_bytes_saved"] += max(0, logical - nbytes)
            stats["segments"] += 1
            metrics.counter("estimator.stream.bytes_uploaded").inc(nbytes)
            metrics.counter("estimator.stream.segments").inc()
            t_up = time.perf_counter()
            segment = self._uploader.upload(hx, hy)
            self._recorder.note("h2d", time.perf_counter() - t_up,
                                steps=max(1, hy.shape[0]))
            stats["staging_copies"] = self._uploader.staging_copies
            return segment

        try:
            for epoch in epochs:
                if stop.is_set():
                    return
                if (self._gate is not None and not self._gate.is_set()
                        and epoch != epochs[0]):
                    while not self._gate.wait(0.2):
                        if stop.is_set():
                            return
                if self._cache is not None and self._cache_ready:
                    return  # every later epoch replays the device cache
                start = self._start_step if epoch == self._start_epoch else 0
                coalesced = start % self.seg == 0
                host_iter = self._plan(
                    epoch, self._batch * self.seg if coalesced else None)
                if start:
                    # the order is fixed by (seed, epoch): skipping the
                    # first steps replays exactly the rest
                    skip = start // self.seg if coalesced else start
                    host_iter = itertools.islice(host_iter, skip, None)
                if coalesced:
                    for x, y in iter_prefetch(host_iter, depth=1):
                        hx, hy, k = coalesce_segment(x, np.asarray(y),
                                                     self._batch)
                        if k and not emit(upload(hx, hy, epoch)):
                            return
                else:
                    xs: List[Any] = []
                    ys: List[np.ndarray] = []
                    for x, y in iter_prefetch(host_iter, depth=1):
                        xs.append(fmap(np.asarray, x))
                        ys.append(np.asarray(y))
                        if len(xs) == self.seg:
                            if not emit(upload(f_stack(xs), np.stack(ys), epoch)):
                                return
                            xs, ys = [], []
                    if xs and not emit(upload(f_stack(xs), np.stack(ys), epoch)):
                        return
                if not emit(None):
                    return
        except BaseException as exc:  # noqa: BLE001 - raised consumer-side
            emit(exc)

    def start(self, epochs, start_epoch: int, start_step: int) -> None:
        """Start the producer for ``epochs`` (the first resumed at
        ``start_step``)."""
        self._start_epoch, self._start_step = start_epoch, start_step
        self._q = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(list(epochs), self._q, self._stop),
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop, drain and join the producer (on any exit of the fit: a
        producer parked on a full queue would pin its segments)."""
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=10)
        self._thread = None

    # -- the consumer ------------------------------------------------------

    def _segment_steps(self, segment, loss_sum):
        n = segment.y.shape[0]
        return self._run_steps(
            ((self._step_input(segment.x, i), segment.y[i]) for i in range(n)),
            loss_sum, n)

    def run(self, epoch: int, start_step: int, save_cb, loss_sum):
        """One epoch's steps; returns ``(loss_sum, steps run)``."""
        if self._cache is not None and not self._cache_ready and start_step:
            # a resumed, partial epoch must not become the cache
            self._cache = None
        if self._cache is not None and self._cache_ready and start_step == 0:
            self.close()
            return self._run_cached(epoch, loss_sum)
        if self._thread is None:
            raise RuntimeError("the stream pipeline was not started")
        try:
            loss_sum, done = self._consume(start_step, save_cb, loss_sum)
            if self._cache is not None and start_step == 0:
                self._cache_ready = True  # one full epoch is on the card
        finally:
            if self._gate is not None:
                self._gate.set()
        return loss_sum, done - start_step

    def _run_cached(self, epoch: int, loss_sum):
        self.stats["cached_epochs"] += 1
        order = np.arange(len(self._cache))
        if self._shuffle:
            np.random.default_rng((self._seed or 0) + epoch).shuffle(order)
        done = 0
        for oi in order:
            segment = self._cache[int(oi)]
            loss_sum = self._segment_steps(segment, loss_sum)
            done += segment.y.shape[0]
        return loss_sum, done

    def _consume(self, done: int, save_cb, loss_sum):
        pending_save = None
        cache_bytes = 0
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            # time parked on an empty queue: the producer or the copy is
            # the bound
            idle = time.perf_counter() - t0
            self.stats["consumer_idle_s"] += idle
            metrics.counter("estimator.stream.consumer_idle_s").inc(idle)
            if item is None:
                break  # this epoch's end
            if isinstance(item, BaseException):
                raise item
            segment = item
            n = segment.y.shape[0]
            self._recorder.note("ingest", idle, steps=max(1, n))
            segment.ready()
            if self._cache is not None and not self._cache_ready:
                cache_bytes += segment.nbytes
                if cache_bytes > self._budget:
                    self._cache = None  # past the budget: stay streaming
                else:
                    self._cache.append(segment)
            if pending_save is not None:
                # more steps follow the boundary: commit its checkpoint
                if save_cb is not None:
                    save_cb(pending_save)
                pending_save = None
            loss_sum = self._segment_steps(segment, loss_sum)
            done += n
            if self.save_every is not None and done % self.save_every == 0:
                pending_save = done
        return loss_sum, done
