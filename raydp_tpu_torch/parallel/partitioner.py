"""Partitioner: the one place the batch placement rules live, the
counterpart of ``raydp_tpu/parallel/partitioner.py``.

``shard_inputs`` puts a host batch on this rank's device, ``shard_stacked``
a stacked [S, B, ...] segment, and ``partition_step`` wraps a step under
the same rules. Every feed of the port (``exchange.torch_io``'s
``device_put_batch`` / ``device_put_stacked``, the estimator's staged,
streamed and per-batch runners) goes through one
``DataParallelPartitioner``, so the rules cannot fork per call site.

The JAX package places a process's rows on a mesh of devices and lets XLA
insert the collectives. A rank of the port is one process with one device,
and its collectives are explicit:

- **shard-direct** (default): the batch given is this process's own rows,
  as ``jax.make_array_from_process_local_data`` takes them, and it goes to
  the device whole. The ranks that share a coordinate on the data axis
  (they differ along the model axis) are given the same rows.
- **driver-staged** (``shard_direct=False``): the batch given is the
  global batch, and this rank takes the rows a ``NamedSharding`` over the
  data axis gives the device at its coordinate: block ``axis_index`` of
  ``axis size`` equal blocks of the batch dim (the leading dim, or the
  second for a stacked segment).
- ``partition_step`` is the one place where gradients are averaged over
  the data axis (an all-reduce of every gradient, flattened into one
  buffer, divided by the axis size), and the step's loss with them, so
  every rank reports the global loss, as every JAX process does.
- A mesh whose data axis has one rank is a plain path: the batch goes to
  the device as it is and the step runs with no collective at all.

The counters ``partitioner.shard_direct_puts`` and
``partitioner.driver_staged_puts`` keep the JAX package's names and count
placements on a mesh of more than one rank.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch

from raydp_tpu_torch import sanitize


class Partitioner:
    """Abstract partitioning of data and computation (the RecML shape)."""

    def shard_inputs(self, inputs: Any) -> Any:
        """Put a host batch (leading dim = batch) on the device."""
        raise NotImplementedError

    def shard_stacked(self, inputs: Any) -> Any:
        """Put a stacked [S, B, ...] host segment on the device."""
        raise NotImplementedError

    def partition_step(self, fn: Callable, *, params: Iterable = ()) -> Callable:
        """Wrap a step under this partitioner's rules."""
        raise NotImplementedError


class NullPartitioner(Partitioner):
    """No placement: inputs pass through, steps run as they are."""

    def shard_inputs(self, inputs: Any) -> Any:
        return inputs

    def shard_stacked(self, inputs: Any) -> Any:
        return inputs

    def partition_step(self, fn: Callable, *, params: Iterable = ()) -> Callable:
        return fn


def _tree(fn, x):
    """``fn`` on every leaf of nested tuples and lists (tuples out)."""
    if isinstance(x, (tuple, list)):
        return tuple(_tree(fn, a) for a in x)
    return fn(x)


def _to_tensor(a, device):
    if torch.is_tensor(a):
        return a.to(device)
    a = np.asarray(a)
    # on the CPU the tensor shares the caller's array
    sanitize.note_external_host_buffer(a, "partitioner input")
    return torch.as_tensor(a).to(device)


class DataParallelPartitioner(Partitioner):
    """The batch dim split over ``axis`` of ``mesh``; parameters whole or
    placed by the sharding rules. Batches land on ``device`` (CUDA unless
    ``"cpu"`` is asked for)."""

    def __init__(self, mesh, axis: str = "data", shard_direct: bool = True,
                 device=None):
        from raydp_tpu_torch._device import resolve_device
        from raydp_tpu_torch.obs import metrics

        self.mesh = mesh
        self.axis = axis
        self.shard_direct = bool(shard_direct)
        self.device = resolve_device(device)
        self.axis_size = int(mesh.shape.get(axis, 1))
        self.multi_rank = int(np.prod(list(mesh.shape.values()))) > 1
        self._direct_puts = metrics.counter("partitioner.shard_direct_puts")
        self._staged_puts = metrics.counter("partitioner.driver_staged_puts")

    # -- placement ------------------------------------------------------

    def rows(self, n: int):
        """This rank's rows of a global batch dim of ``n`` rows."""
        if n % self.axis_size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.axis_size} ranks of {self.axis!r}")
        per = n // self.axis_size
        start = self.mesh.axis_index(self.axis) * per
        return slice(start, start + per)

    def _local(self, x, stacked: bool):
        """This rank's rows of one host leaf, counted as a placement."""
        if x is None:
            return None
        if self.multi_rank:
            if self.shard_direct:
                self._direct_puts.inc()
            else:
                self._staged_puts.inc()
        if not self.shard_direct and self.axis_size > 1:
            dim = 1 if stacked else 0
            x = x[(slice(None),) * dim + (self.rows(x.shape[dim]),)]
        return x

    def local_inputs(self, inputs: Any, stacked: bool = False) -> Any:
        """``shard_inputs`` (or ``shard_stacked``) left on the host: the
        rows this rank places, for a caller that stages the upload itself
        (``exchange.torch_io.SegmentUploader``)."""
        return _tree(lambda a: self._local(a, stacked), inputs)

    def shard_inputs(self, inputs: Any) -> Any:
        """A host batch (an array, a tuple of arrays, or ``(x, y)`` with
        ``y`` possibly None) on the device: this process's rows
        (shard-direct), or this rank's block of the global batch."""
        return _tree(lambda a: None if a is None else _to_tensor(a, self.device),
                     self.local_inputs(inputs))

    def shard_stacked(self, inputs: Any) -> Any:
        """A stacked [S, B, ...] segment, split on its second dim."""
        return _tree(lambda a: None if a is None else _to_tensor(a, self.device),
                     self.local_inputs(inputs, stacked=True))

    # -- computation ----------------------------------------------------

    def partition_step(self, fn: Callable, *, params: Iterable = ()) -> Callable:
        """Wrap ``fn(*args) -> loss``, which runs the forward and the
        backward of this rank's rows: the gradients of ``params`` and the
        loss are averaged over the data axis before the wrapper returns
        (the caller's optimizer step comes after). With one rank on the
        data axis, ``fn`` itself."""
        if self.axis_size == 1:
            return fn
        import torch.distributed as dist

        params = list(params)
        group = self.mesh.group(self.axis)
        size = float(self.axis_size)

        def step(*args, **kwargs):
            loss = fn(*args, **kwargs)
            grads = [p.grad for p in params if p.grad is not None]
            dtype = grads[0].dtype if grads else loss.dtype
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.detach().reshape(1).to(dtype)])
            dist.all_reduce(flat, group=group)
            flat /= size
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            return flat[offset].to(loss.dtype)

        return step

