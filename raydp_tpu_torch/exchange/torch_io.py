"""Host-to-device feeding of the port's estimator: its copy of the streaming
half of ``raydp_tpu/exchange/jax_io.py``.

- ``PrefetchingDeviceIterator`` keeps ``depth`` batches ahead on the
  device; ``iter_prefetch`` pulls a host iterator ahead on a thread.
- ``SegmentUploader`` is the streamed fit's H2D path. A segment (a stack of
  batches) is copied into one of ``depth`` pinned host buffers, then to
  the card by a ``non_blocking`` copy on one of ``depth`` side streams,
  and an event marks the copy's end. The consumer makes the compute stream
  wait on that event (``Segment.ready``), and ``record_stream`` tells the
  caching allocator that the compute stream uses the segment's memory, so
  the memory is not handed to a later copy while a step still reads it. A
  pinned buffer is refilled only after the copy that last read it has
  finished. On the CPU a segment is a plain copy.
- ``quantize_rows`` / ``dequantize_rows`` / ``widen_wire``: the int8 wire
  format of streamed float features, per-row scales; ``widen_wire`` runs
  as torch ops on the card and equals ``dequantize_rows`` on the host bit
  for bit (both one f32 multiply).
- ``coalesce_segment`` shapes a segment-sized host slice into stacked
  batches.

The mesh helpers of ``jax_io``: ``partitioner_for`` gives the one
``parallel.partitioner.DataParallelPartitioner`` of a (mesh, axis, mode,
device), from a bounded cache of 8, and every feed here goes through it:
``device_put_batch`` / ``device_put_stacked``, and the ``mesh=`` of
``PrefetchingDeviceIterator``, ``SegmentUploader`` and
``dataset_batches_on_device``. ``data_sharding`` is the placement spec
that splits the batch dim over an axis.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from functools import partial
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raydp_tpu_torch import sanitize
from raydp_tpu_torch.exchange.features import f0, fmap


def _leaves(x) -> list:
    return list(x) if isinstance(x, tuple) else [x]


def _like(x, leaves):
    return tuple(leaves) if isinstance(x, tuple) else leaves[0]


def data_sharding(mesh=None, *, axis: str = "data", rank: int = 2) -> tuple:
    """The spec that splits the leading (batch) dim over ``axis`` (the
    stand-in for ``NamedSharding(mesh, P(axis, None, ...))``)."""
    return (axis,) + (None,) * (rank - 1)


# one partitioner per (mesh, axis, mode, device): its counters and resolved
# flags live on it. Bounded: an estimator builds a mesh per fit, and an
# unbounded dict keyed by id(mesh) would keep one per fit for the life of
# the process
_partitioner_cache: dict = {}
_PARTITIONER_CACHE_MAX = 8


def partitioner_for(mesh, axis: str = "data", shard_direct: bool = True,
                    device=None):
    """The shared ``DataParallelPartitioner`` for ``mesh``: every feed
    helper of this module routes through it, so the placement rules have
    one implementation (``parallel/partitioner.py``)."""
    from raydp_tpu_torch._device import resolve_device
    from raydp_tpu_torch.parallel.partitioner import DataParallelPartitioner

    device = resolve_device(device)
    key = (id(mesh), axis, bool(shard_direct), str(device))
    part = _partitioner_cache.get(key)
    if part is None or part.mesh is not mesh:
        part = DataParallelPartitioner(mesh, axis, shard_direct=shard_direct,
                                       device=device)
        while len(_partitioner_cache) >= _PARTITIONER_CACHE_MAX:
            _partitioner_cache.pop(next(iter(_partitioner_cache)))
        _partitioner_cache[key] = part
    return part


def device_put_batch(batch, mesh, axis: str = "data",
                     shard_direct: bool = True, device=None):
    """A host batch (an array or a tuple of arrays) on this rank's device,
    through ``Partitioner.shard_inputs``."""
    return partitioner_for(mesh, axis, shard_direct, device).shard_inputs(batch)


def device_put_stacked(arr, mesh, axis: str = "data",
                       shard_direct: bool = True, device=None):
    """A stacked [S, B, ...] host segment on this rank's device (the scan
    dim whole, the batch dim split over ``axis``), through
    ``Partitioner.shard_stacked``."""
    return partitioner_for(mesh, axis, shard_direct, device).shard_stacked(arr)


def put_batch(batch, device: torch.device):
    """A host (features, labels) batch as tensors on ``device``."""
    x, y = batch
    x = fmap(lambda a: torch.as_tensor(np.asarray(a)).to(device), x)
    return x, (None if y is None else torch.as_tensor(np.asarray(y)).to(device))


class PrefetchingDeviceIterator:
    """Wraps a host batch iterator and keeps ``depth`` batches ahead on the
    device. ``host_s`` and ``h2d_s`` accumulate the time spent pulling host
    batches and issuing their uploads (the step recorder reads their
    deltas)."""

    def __init__(self, host_iter: Iterator, device: torch.device,
                 depth: int = 1, *, mesh=None, axis: str = "data"):
        self._host_iter = iter(host_iter)
        self._device = device
        self._put = (partial(put_batch, device=device) if mesh is None else
                     partitioner_for(mesh, axis, device=device).shard_inputs)
        self._depth = max(1, int(depth))
        self._pending: deque = deque()
        self._exhausted = False
        self.host_s = 0.0
        self.h2d_s = 0.0
        self._fill()

    def _fill(self):
        while not self._exhausted and len(self._pending) < self._depth:
            t0 = time.perf_counter()
            try:
                batch = next(self._host_iter)
            except StopIteration:
                self._exhausted = True
                self.host_s += time.perf_counter() - t0
                return
            t1 = time.perf_counter()
            self.host_s += t1 - t0
            self._pending.append(self._put(batch))
            self.h2d_s += time.perf_counter() - t1

    def __iter__(self):
        return self

    def __next__(self):
        if not self._pending:
            raise StopIteration
        current = self._pending.popleft()
        self._fill()
        return current


def iter_prefetch(it: Iterator, depth: int = 1) -> Iterator:
    """Pull up to ``depth`` items of ``it`` ahead on a worker thread.
    Exceptions surface on the consuming side; closing the generator stops
    the worker."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    end = object()
    stop = threading.Event()

    def pull():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(end)
        except BaseException as exc:  # noqa: BLE001 - re-raised consumer-side
            q.put(exc)

    worker = threading.Thread(target=pull, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            q.get_nowait()  # unblock a worker parked on the full queue
        except queue.Empty:
            pass
        worker.join(timeout=10)


class Segment:
    """One uploaded segment: ``x`` (a tensor or a tuple) and ``y`` stacked
    [S, B, ...], and on CUDA the event that ends their copy."""

    __slots__ = ("x", "y", "event")

    def __init__(self, x, y, event=None):
        self.x, self.y, self.event = x, y, event

    def ready(self) -> None:
        """Make the current stream wait for the copy, and mark the segment's
        memory as used by it (call on the stream that will read it)."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream(self.y.device)
        stream.wait_event(self.event)
        for t in _leaves(self.x) + [self.y]:
            t.record_stream(stream)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in _leaves(self.x) + [self.y])


class SegmentUploader:
    """``depth``-way rotating H2D staging (see the module docstring).
    ``upload(hx, hy)`` returns a :class:`Segment`."""

    def __init__(self, device: torch.device, depth: int = 2, *, mesh=None,
                 axis: str = "data", partitioner=None):
        self._device = device
        if partitioner is None and mesh is not None:
            partitioner = partitioner_for(mesh, axis, device=device)
        self._partitioner = partitioner
        self._depth = max(2, int(depth))
        self._cuda = device.type == "cuda"
        self._slots: List[Optional[list]] = [None] * self._depth
        self._events: List[Optional[torch.cuda.Event]] = [None] * self._depth
        self._streams = ([torch.cuda.Stream(device) for _ in range(self._depth)]
                         if self._cuda else None)
        self._next = 0
        self.staging_copies = 0

    @property
    def upload_streams(self) -> int:
        return self._depth

    @property
    def reuse_host_buffers(self) -> bool:
        return self._cuda

    def upload(self, hx, hy) -> Segment:
        if self._partitioner is not None:
            hx, hy = self._partitioner.local_inputs((hx, hy), stacked=True)
        hosts = [torch.from_numpy(np.ascontiguousarray(a))
                 for a in _leaves(hx) + [hy]]
        for h in hosts:  # the decoded segment's arrays, shared
            sanitize.note_external_host_buffer(h, "SegmentUploader host")
        if not self._cuda:
            dev = [h.clone() for h in hosts]
            return Segment(_like(hx, dev[:-1]), dev[-1])
        slot = self._next % self._depth
        self._next += 1
        if self._events[slot] is not None:
            # the copy that last read this pinned buffer must be done
            # before the buffer is overwritten
            self._events[slot].synchronize()
        bufs = self._slots[slot]
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != [
                (h.shape, h.dtype) for h in hosts]:
            # first use, or a tail segment's shape: (re)allocate
            bufs = self._slots[slot] = [
                torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                for h in hosts]
        for b, h in zip(bufs, hosts):
            b.copy_(h)
        self.staging_copies += 1
        stream = self._streams[slot]
        with torch.cuda.stream(stream):
            dev = [b.to(self._device, non_blocking=True) for b in bufs]
            event = torch.cuda.Event()
            event.record(stream)
        self._events[slot] = event
        return Segment(_like(hx, dev[:-1]), dev[-1], event)


# ---------------------------------------------------------------------------
# the int8 wire format of streamed float features
# ---------------------------------------------------------------------------


def quantize_rows(a: np.ndarray, dtype=np.int8) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization of a float array [..., F]:
    ``(q, scale)`` with ``q = rint(a / scale)`` clipped to +-127 and
    ``scale = rowmax(|a|) / 127`` shaped [..., 1] (float32). All-zero rows
    get scale 1.0, so their round trip is exact."""
    a = np.asarray(a)
    info = np.iinfo(dtype)
    qmax = min(-info.min - 1, info.max)  # symmetric: +-127 for int8
    amax = np.max(np.abs(a), axis=-1, keepdims=True)
    scale = (amax / qmax).astype(np.float32)
    scale[scale == 0] = 1.0
    q = np.clip(np.rint(a / scale), -qmax, qmax).astype(dtype)
    return q, scale


def dequantize_rows(q, scale, dtype=np.float32) -> np.ndarray:
    """Host-side inverse of :func:`quantize_rows`: ``q * scale`` in f32,
    what :func:`widen_wire` must equal bit for bit."""
    return (np.asarray(q).astype(dtype) * np.asarray(scale)).astype(dtype)


def widen_wire(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The device half: ``q`` widened to ``dtype`` times its row's scale
    (scales [..., 1] broadcast over the features)."""
    return (q.to(dtype) * scale).to(dtype)


def coalesce_segment(features, labels, batch_size: int):
    """Shape a segment-sized host slice (``k*B [+tail]`` rows) into stacked
    batches: trim to whole batches and reshape ``[k*B, ...] -> [k, B,
    ...]``. Returns ``(xb, yb, k)``; ``k == 0`` when less than one batch
    remains (the caller drops that tail)."""
    n = len(f0(features))
    k = n // batch_size
    if k == 0:
        return None, None, 0

    def _r(a):
        a = np.asarray(a)
        return a[: k * batch_size].reshape((k, batch_size) + a.shape[1:])

    yb = None if labels is None else _r(labels)
    return fmap(_r, features), yb, k


def dataset_batches_on_device(
    dataset,
    mesh,
    batch_size: int,
    feature_columns: Sequence[str],
    label_column: Optional[str] = None,
    shuffle: bool = False,
    seed: Optional[int] = None,
    axis: str = "data",
    drop_last: bool = True,
    device=None,
) -> Iterator:
    """(features, labels) batches of ``dataset`` on this rank's device,
    through the mesh's partitioner, one batch ahead."""
    from raydp_tpu_torch._device import resolve_device

    host = dataset.iter_batches(
        batch_size, feature_columns, label_column, shuffle=shuffle,
        seed=seed, drop_last=drop_last)
    return PrefetchingDeviceIterator(host, resolve_device(device), mesh=mesh,
                                     axis=axis)
