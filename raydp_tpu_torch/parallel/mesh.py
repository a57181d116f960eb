"""Meshes of ranks over ``torch.distributed``: the counterpart of
``raydp_tpu/parallel/mesh.py``.

A JAX mesh is an array of devices with named axes, and a collective over
an axis runs among the devices that differ only along it. Here the mesh is
an array of **ranks** of the default process group, and each axis has one
process group per line of ranks along it (``Mesh.group``), made with
``dist.new_group`` the first time the axis is used. ``make_mesh`` takes the
reference's axis spec (one ``-1`` axis absorbs the remaining ranks) and
needs no process group for its shape logic.

A layer that runs "inside shard_map" in the JAX package finds its axis
here: ``bound_axes(mesh)`` binds the mesh's axis names for the calls made
inside it (``sequence_parallel_apply`` and ``ring_attention_sharded`` bind
theirs), and ``bound_mesh`` / ``axis_env_size`` read the binding. An
axis name with no binding raises ``NameError``, as an unbound axis does in
JAX. A layer that needs its group again in the backward reads
it in the forward and keeps it: autograd may run the backward on another
thread, where the binding is not seen: ``Axis.of`` reads a bound axis's
group, this rank's index and the size into one value.

``replicated`` marks a tensor that every rank of an axis holds alike as an
input of a sharded computation (shard_map's ``P()``): the identity forward,
and the backward sums the gradient over the axis's group, which is the
transpose of a replicated input.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Ranks of the default process group arranged in named axes.

    ``ranks`` is an int array whose shape is the axes' sizes. ``shape``
    maps axis name to size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-d ranks for axes {self.axis_names}")
        self._groups: Dict[str, object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def _coords(self, rank: int) -> Tuple[int, ...]:
        found = np.argwhere(self.ranks == rank)
        if not len(found):
            raise ValueError(f"rank {rank} is not in {self!r}")
        return tuple(int(c) for c in found[0])

    def _lines(self, axis: str) -> np.ndarray:
        """[n_lines, axis size]: the rank lines along ``axis``, in a fixed
        order (every rank creates every line's group in this order)."""
        dim = self.axis_names.index(axis)
        moved = np.moveaxis(self.ranks, dim, -1)
        return moved.reshape(-1, self.ranks.shape[dim])

    def axis_index(self, axis: str, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) coordinate along ``axis``."""
        if rank is None:
            rank = _world_rank()
        return self._coords(rank)[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``. Every rank
        of the default group must ask for an axis's group the first time,
        in the same order, since ``dist.new_group`` is collective."""
        import torch.distributed as dist

        if axis not in self.axis_names:
            raise NameError(f"unbound axis name: {axis}")
        if axis not in self._groups:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"axis {axis!r} needs a process group: call "
                    "torch.distributed.init_process_group first")
            rank = dist.get_rank()
            mine = None
            for line in self._lines(axis):
                members = [int(r) for r in line]
                made = dist.new_group(members)
                if rank in members:
                    mine = made
            if mine is None:
                raise ValueError(f"rank {rank} is not in {self!r}")
            self._groups[axis] = mine
        return self._groups[axis]


def _world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _world_ranks() -> list:
    import torch.distributed as dist

    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def make_mesh(axes: Dict[str, int], ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh with named ``axes`` (e.g. {"data": 4, "model": 2}) over
    ``ranks`` (every rank of the default group when None; rank 0 alone
    without one). A -1 axis absorbs the remaining ranks, as in a reshape;
    at most one axis may be -1, and the axes must fit the ranks. Earlier
    axes are outer, later axes inner."""
    ranks = list(ranks if ranks is not None else _world_ranks())
    n = len(ranks)
    names = list(axes.keys())
    sizes = list(axes.values())
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1])) or 1
    if unknown:
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} ranks, have {n}")
    return Mesh(np.array(ranks[:total]).reshape(sizes), names)


def data_parallel_mesh(ranks: Optional[Sequence[int]] = None) -> Mesh:
    return make_mesh({"data": -1}, ranks)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return int(mesh.shape.get(axis, 1))


def multihost_mesh(axes: Dict[str, int], process_axis: str = "data") -> Mesh:
    """A mesh over the ranks of the default process group, brought up by
    ``spmd.bootstrap.initialize_from_env`` (rank 0 alone without one),
    with ``process_axis`` spanning the ranks slowest, as the JAX package
    spans hosts: the ranks are laid out with ``process_axis`` outermost and
    the array is transposed back to the caller's axis order."""
    if process_axis not in axes:
        raise ValueError(f"process_axis {process_axis!r} not in axes {list(axes)}")
    names = list(axes.keys())
    ordered = [process_axis] + [a for a in names if a != process_axis]
    built = make_mesh({a: axes[a] for a in ordered})
    if ordered == names:
        return built
    perm = [ordered.index(a) for a in names]
    return Mesh(np.transpose(built.ranks, perm), names)


# ---------------------------------------------------------------------------
# axis binding: the counterpart of the axis environment inside shard_map
# ---------------------------------------------------------------------------

_BOUND: contextvars.ContextVar[Tuple[Mesh, ...]] = contextvars.ContextVar(
    "raydp_tpu_torch_bound_meshes", default=())


@contextlib.contextmanager
def bound_axes(mesh: Mesh):
    """Bind ``mesh``'s axis names for the calls made inside the block."""
    token = _BOUND.set(_BOUND.get() + (mesh,))
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def bound_mesh(axis_name: str) -> Mesh:
    """The innermost bound mesh that has ``axis_name``."""
    for mesh in reversed(_BOUND.get()):
        if axis_name in mesh.axis_names:
            return mesh
    raise NameError(f"unbound axis name: {axis_name}")


def current_meshes() -> Tuple[Mesh, ...]:
    """The bound meshes, innermost last (to bind them again elsewhere)."""
    return _BOUND.get()


def axis_env_size(axis_name: str) -> int:
    """Size of a bound axis: the size of its group."""
    return mesh_axis_size(bound_mesh(axis_name), axis_name)


@dataclass(frozen=True)
class Axis:
    """A bound axis as a layer keeps it: its group, this rank's index along
    it, and its size."""

    group: object
    index: int
    size: int

    @classmethod
    def of(cls, axis_name: str) -> "Axis":
        bound = bound_mesh(axis_name)
        return cls(bound.group(axis_name), bound.axis_index(axis_name),
                   mesh_axis_size(bound, axis_name))

    def peer(self, offset: int) -> int:
        """The default group's rank of the rank ``offset`` steps along."""
        import torch.distributed as dist

        return dist.get_global_rank(self.group, (self.index + offset) % self.size)

    def rotate(self, tensors):
        """Each tensor to the next rank of the ring, the previous rank's
        back: one ``batch_isend_irecv`` for all of them. A ring of one rank
        is the identity and sends nothing."""
        import torch.distributed as dist

        if self.size == 1:
            return list(tensors)
        nxt, prv = self.peer(1), self.peer(-1)
        ops, received = [], []
        for t in tensors:
            t = t.contiguous()
            buf = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, nxt, self.group))
            ops.append(dist.P2POp(dist.irecv, buf, prv, self.group))
            received.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return received


class _Replicated(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over the
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as an input that every rank of ``group`` holds alike: each
    rank's gradient of it comes back summed over the group (shard_map's
    transpose of a ``P()`` input)."""
    return _Replicated.apply(x, group)
