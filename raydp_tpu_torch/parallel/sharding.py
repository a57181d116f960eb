"""Parameter-sharding rules: the counterpart of
``raydp_tpu/parallel/sharding.py``, regex on a parameter's path to a
placement on a mesh of ranks.

The JAX package names a ``PartitionSpec`` per parameter and lets XLA
place the arrays and insert the collectives. Here a :class:`Placement` is
the stand-in for ``NamedSharding(mesh, spec)``: ``spec`` names, per dim,
the mesh axis (or a tuple of axes) the dim is split over, None for a dim
every rank holds whole. What XLA did silently is explicit code, and all of
it is in this module:

- ``shard_module`` keeps in a module only this rank's block of each
  sharded parameter and tags the parameter with its placement
  (``param.placement``), which the model (``models/dlrm.py``), the
  optimizer (``optim.Adafactor``) and the checkpoints read;
- ``Placement.all_reduce`` sums over the ranks that share the other
  coordinates, the reduction of a sharded dim;
- ``gather_full`` / ``Placement.take`` go from a block to the whole tensor
  and back (checkpoints hold whole tensors, so a fit resumes at another
  axis size); ``gather_state`` / ``scatter_state`` do it for a state dict
  and an optimizer's state.

``shard_map_compat`` has no counterpart: a layer that runs inside
``shard_map`` in the JAX package binds its mesh with
``parallel.mesh.bound_axes`` here.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Placement:
    """One parameter of ``global_shape`` on ``mesh``: dim i is split into
    equal blocks over the axes ``spec[i]`` names (the first axis of a tuple
    major), or held whole where ``spec[i]`` is None."""

    def __init__(self, mesh, spec: Sequence, global_shape: Sequence[int]):
        self.mesh = mesh
        self.global_shape = tuple(int(s) for s in global_shape)
        spec = tuple(spec)
        self.spec = spec + (None,) * (len(self.global_shape) - len(spec))

    def __repr__(self) -> str:
        return f"Placement({self.spec}, {self.global_shape}, {self.mesh!r})"

    def split(self, dim: int) -> int:
        """How many blocks dim ``dim`` is cut into."""
        return int(np.prod([self.mesh.shape.get(a, 1)
                            for a in _axes_of(self.spec[dim])]))

    @property
    def replicated(self) -> bool:
        """Every rank holds the whole tensor."""
        return all(self.split(d) == 1 for d in range(len(self.global_shape)))

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes some dim is split over (size > 1)."""
        return tuple(a for d in range(len(self.global_shape))
                     for a in _axes_of(self.spec[d])
                     if self.mesh.shape.get(a, 1) > 1)

    def index(self, rank: Optional[int] = None) -> Tuple[slice, ...]:
        """This rank's (or ``rank``'s) block of the whole tensor."""
        out = []
        for d, size in enumerate(self.global_shape):
            block = 0
            for axis in _axes_of(self.spec[d]):
                block = (block * self.mesh.shape.get(axis, 1)
                         + self.mesh.axis_index(axis, rank))
            n = size // self.split(d)
            out.append(slice(block * n, (block + 1) * n))
        return tuple(out)

    def take(self, full, rank: Optional[int] = None):
        """This rank's block of the whole tensor (numpy or torch)."""
        return full[self.index(rank)]

    def all_reduce(self, t: torch.Tensor, dims: Optional[Sequence[int]] = None):
        """Sum ``t`` in place over the ranks that hold the other blocks of
        ``dims`` (every split dim when None): the reduction of a sharded
        dim."""
        import torch.distributed as dist

        dims = range(len(self.global_shape)) if dims is None else dims
        for d in dims:
            for axis in _axes_of(self.spec[d]):
                if self.mesh.shape.get(axis, 1) > 1:
                    dist.all_reduce(t, group=self.mesh.group(axis))
        return t

    def numel(self) -> int:
        """The whole tensor's count of elements."""
        return int(np.prod(self.global_shape))


def _path(name) -> str:
    """A parameter's path as the JAX package's rules see it: '/'-joined."""
    if isinstance(name, tuple):
        return "/".join(str(k) for k in name)
    return str(name).replace(".", "/")


def _divisible(shape, spec, mesh) -> bool:
    for dim, axis in zip(shape, tuple(spec)):
        if axis is None:
            continue
        size = 1
        for a in _axes_of(axis):
            size *= int(mesh.shape.get(a, 1))
        if dim % size:
            return False
    return True


def _named(params) -> List[Tuple[str, Any]]:
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    if isinstance(params, dict):
        return list(params.items())
    return list(params)


def shard_params_by_rules(
    mesh,
    named_params,
    rules: Sequence[Tuple[str, Any]],
    default=None,
) -> Dict[str, Placement]:
    """``{name: Placement}`` for a module, a dict or a list of ``(name,
    tensor)``: the first rule whose regex matches the parameter's
    '/'-joined path wins; unmatched parameters use ``default`` (replicated
    when None). A shape that does not divide the axis falls back to
    replication."""
    compiled = [(re.compile(pattern), tuple(spec)) for pattern, spec in rules]
    out = {}
    for name, leaf in _named(named_params):
        shape = tuple(leaf.shape)
        spec = tuple(default or ())
        path = _path(name)
        for regex, rule_spec in compiled:
            if regex.search(path):
                spec = rule_spec if _divisible(shape, rule_spec, mesh) else ()
                break
        out[name] = Placement(mesh, spec, shape)
    return out


def sharding_rules_fn(rules: Sequence[Tuple[str, Any]]) -> Callable:
    """The estimator's ``param_sharding_rules=``: ``fn(mesh, params)``."""

    def fn(mesh, params):
        return shard_params_by_rules(mesh, params, rules)

    return fn


def shard_module(module: torch.nn.Module,
                 placements: Dict[str, Placement]) -> torch.nn.Module:
    """Keep in ``module`` only this rank's block of each parameter that a
    placement splits, tag every parameter with its placement
    (``param.placement``), and keep the split ones as
    ``module.placements``. Parameters must hold their whole (global)
    values on entry."""
    split = {}
    for name, placement in placements.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        param = getattr(owner, leaf)
        if tuple(param.shape) != placement.global_shape:
            raise ValueError(f"{name}: shape {tuple(param.shape)}, placement "
                             f"for {placement.global_shape}")
        if not placement.replicated:
            param = torch.nn.Parameter(
                placement.take(param.data).clone(),
                requires_grad=param.requires_grad)
            setattr(owner, leaf, param)
            split[name] = placement
        param.placement = placement
    module.placements = split
    return module


def gather_full(local: torch.Tensor, placement: Optional[Placement]) -> torch.Tensor:
    """The whole tensor from every rank's block: each rank writes its block
    into zeros and the blocks are summed over the split axes (an
    all-reduce, which gloo takes on CUDA tensors too; each element is
    nonzero on one rank only, so the sum is exact)."""
    if placement is None or placement.replicated:
        return local
    full = local.new_zeros(placement.global_shape)
    full[placement.index()] = local
    return placement.all_reduce(full)


def gather_state(state: Dict[str, torch.Tensor],
                 placements: Dict[str, Placement]) -> Dict[str, torch.Tensor]:
    """A state dict with every split parameter gathered whole."""
    return {k: gather_full(v, placements.get(k)) for k, v in state.items()}


def scatter_state(state: Dict[str, torch.Tensor],
                  placements: Dict[str, Placement]) -> Dict[str, torch.Tensor]:
    """A state dict of whole tensors cut to this rank's blocks."""
    out = {}
    for k, v in state.items():
        placement = placements.get(k)
        out[k] = (v if placement is None or placement.replicated
                  else placement.take(v).clone())
    return out


def _state_placement(placement: Placement, value: torch.Tensor, dims,
                     like: Tuple[int, ...]) -> Optional[Placement]:
    """The placement of one optimizer-state tensor of a parameter placed by
    ``placement``: ``dims`` names the parameter dims it keeps (the
    optimizer's ``state_dims``); without it, a tensor of the parameter's
    shape ``like`` keeps them all and any other is replicated (a step
    count)."""
    if value.dim() == 0:
        return None
    if dims is None:
        if tuple(value.shape) != tuple(like):
            return None
        dims = range(len(placement.global_shape))
    dims = list(dims)
    return Placement(placement.mesh, [placement.spec[d] for d in dims],
                     [placement.global_shape[d] for d in dims])


def _optimizers(opt) -> list:
    inner = getattr(opt, "optimizers", None)
    return list(inner.values()) if isinstance(inner, dict) else [opt]


def _map_opt_state(opt, state: dict, fn, whole: bool) -> dict:
    """``state`` (``opt.state_dict()``'s structure) with ``fn(value,
    placement)`` applied to the state of each split parameter. ``whole``
    says whether the state's tensors are whole (or this rank's blocks)."""
    multi = isinstance(getattr(opt, "optimizers", None), dict)
    parts = list(state.items()) if multi else [(None, state)]
    out = {}
    for (label, sd), inner in zip(parts, _optimizers(opt)):
        params = [p for group in inner.param_groups for p in group["params"]]
        dims_of = getattr(inner, "state_dims", None)
        mapped = {}
        for index, per in sd["state"].items():
            p = params[int(index)]
            placement = getattr(p, "placement", None)
            if placement is None or placement.replicated:
                mapped[index] = per
                continue
            like = placement.global_shape if whole else tuple(p.shape)
            mapped[index] = {}
            for key, value in per.items():
                sp = (_state_placement(placement, value,
                                       dims_of(p, key) if dims_of else None,
                                       like)
                      if torch.is_tensor(value) else None)
                mapped[index][key] = (value if sp is None or sp.replicated
                                      else fn(value, sp))
        sd = dict(sd, state=mapped)
        if not multi:
            return sd
        out[label] = sd
    return out


def gather_optimizer_state(opt, state: dict) -> dict:
    """``opt.state_dict()`` with the state of split parameters whole."""
    return _map_opt_state(opt, state, gather_full, whole=False)


def scatter_optimizer_state(opt, state: dict) -> dict:
    """A whole optimizer state cut to this rank's blocks, for
    ``opt.load_state_dict``."""
    return _map_opt_state(opt, state, lambda v, p: p.take(v).clone(),
                          whole=True)
