"""Pipeline parallelism over ``torch.distributed``: the counterpart of
``raydp_tpu/parallel/pipeline.py``, a GPipe schedule of microbatches over
a mesh axis of ranks.

Each rank of the axis holds ONE stage's parameters. Over ``M + N - 1``
ticks, rank ``d`` runs its stage at tick ``t`` on microbatch ``t - d``, and
the activations move one rank to the right after every tick but the last
(``_shift``: ``all_to_all_single`` with split sizes, each rank sending to
the next rank of the ring and receiving from the previous one, since gloo
takes that op on CUDA tensors and not its point-to-point sends). The first
and last ``N - 1`` ticks of each rank are its bubble. The JAX package
computes the bubble ticks on zeros and throws them away; here a rank skips
their computation, and every rank still joins every tick's shift, so the
collectives stay in one order on every rank. A pipeline of one rank sends
nothing.

The backward is one ``torch.autograd.Function`` for the whole schedule
(``_Pipeline``), never left to the autograd engine: a bubble tick has no
node, so an engine-ordered backward would reach the collectives in a
different order on each rank. The forward keeps each live tick's stage
graph (its input and output); the backward runs the ticks in reverse, the
gradient moving one rank to the LEFT after every tick but the first, and
differentiates each saved stage call with ``torch.autograd.grad`` (the
stage's parameters, and its input where a rank to the left needs it).

Gradients follow shard_map's transposes. ``pipeline_sharded``'s output is
replicated: every rank holds the last stage's outputs (the JAX wrapper's
masked ``psum``) and takes the same loss from them, and its backward takes
that one cotangent on the last rank without summing it over the ranks.
The microbatches enter replicated (``mesh.replicated``): their gradient is
the sum over the ranks of each rank's part, which only stage 0 gives, so
every rank gets stage 0's. Parameters outside the pipeline, computed alike
on every rank from the replicated output, need no reduction.

The stage is functional, as in JAX: ``stage_fn(stage_params, x)`` with
``stage_params`` a pytree of tensors (``module_stage`` makes one of a
module). Its output must have its input's shape, checked on every rank
before any collective by evaluating the stage on fake CPU tensors (the
counterpart of ``jax.eval_shape``), so that every rank raises; the
check is kept per stage function, so keep the function from step to step.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree as pytree

from raydp_tpu_torch.parallel import mesh as _mesh


def module_stage(module: torch.nn.Module) -> Tuple[Callable, dict]:
    """``(stage_fn, stage_params)`` of a module: its parameters by name,
    and ``torch.func.functional_call`` of the module on them."""

    def stage_fn(params, x):
        return torch.func.functional_call(module, params, (x,))

    return stage_fn, dict(module.named_parameters())


# stage_fn -> {the shapes and types of its params and input: the output's
# shape}: a fake evaluation of a full-width stage takes seconds of host time
_SHAPES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _out_shape(stage_fn: Callable, stage_params: Any, x: torch.Tensor):
    """The stage's output shape for an input like ``x``, from fake CPU
    tensors: no memory, no kernel, no collective. Kept per stage function
    and shapes, so a caller that keeps its ``stage_fn`` pays it once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def spec(t):
        return (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t

    key = (spec(x), tuple(spec(t) for t in pytree.tree_leaves(stage_params)))
    known = _SHAPES.setdefault(stage_fn, {})
    if key not in known:
        def fake(t):
            if isinstance(t, torch.Tensor):
                return torch.empty(t.shape, dtype=t.dtype, device="cpu")
            return t

        with FakeTensorMode(), torch.no_grad():
            out = stage_fn(pytree.tree_map(fake, stage_params), fake(x))
        known[key] = tuple(out.shape)
    return known[key]


def _shift(x: torch.Tensor, axis: _mesh.Axis, offset: int) -> torch.Tensor:
    """``x`` to the rank ``offset`` steps along the ring, the rank
    ``offset`` steps back's to this one: ``all_to_all_single`` with split
    sizes (only the chunk to that peer is not empty)."""
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1)
    n = flat.numel()
    send = [0] * axis.size
    recv = [0] * axis.size
    send[(axis.index + offset) % axis.size] = n
    recv[(axis.index - offset) % axis.size] = n
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, recv, send, group=axis.group)
    return out.view(x.shape)


def _live(tick: int, index: int, m: int) -> bool:
    return 0 <= tick - index < m


def _forward_ticks(stage_fn, stage_params, micro, axis, keep: bool):
    """Run the forward schedule. Returns the banked outputs [M, ...] (the
    last rank's; zeros elsewhere) and, with ``keep``, each live tick's
    (input, output) with its graph, by microbatch."""
    n, me, m = axis.size, axis.index, micro.shape[0]
    ticks = m + n - 1
    outputs = torch.zeros_like(micro)
    saved = {}
    incoming = None
    for t in range(ticks):
        send = None
        if _live(t, me, m):
            j = t - me
            x = micro[j] if me == 0 else incoming
            if keep:
                with torch.enable_grad():
                    x = x.detach().requires_grad_(me > 0 or micro.requires_grad)
                    y = stage_fn(stage_params, x)
                saved[j] = (x, y)
                y = y.detach()
            else:
                y = stage_fn(stage_params, x)
            if me == n - 1:
                outputs[j] = y
            send = y
        if t < ticks - 1 and n > 1:
            incoming = _shift(send if send is not None else
                              torch.zeros_like(micro[0]), axis, 1)
    return outputs, saved


class _Pipeline(torch.autograd.Function):
    """The schedule with its own backward. Inputs: the stage function, the
    axis, the params' treedef, the microbatches, then the stage's
    parameter leaves."""

    @staticmethod
    def forward(ctx, stage_fn, axis, spec, micro, *leaves):
        stage_params = pytree.tree_unflatten(list(leaves), spec)
        outputs, saved = _forward_ticks(stage_fn, stage_params, micro, axis,
                                        keep=True)
        ctx.axis, ctx.saved, ctx.m = axis, saved, micro.shape[0]
        ctx.leaves = leaves
        ctx.micro_like = (micro.shape, micro.dtype, micro.device)
        return outputs

    @staticmethod
    def backward(ctx, g):
        axis, m, saved = ctx.axis, ctx.m, ctx.saved
        n, me = axis.size, axis.index
        shape, dtype, device = ctx.micro_like
        wrt = [i for i, leaf in enumerate(ctx.leaves)
               if isinstance(leaf, torch.Tensor) and leaf.requires_grad]
        grads = [None] * len(ctx.leaves)
        dmicro = (torch.zeros(shape, dtype=dtype, device=device)
                  if ctx.needs_input_grad[3] else None)
        incoming = None
        for t in reversed(range(m + n - 1)):
            send = None
            if _live(t, me, m):
                j = t - me
                x, y = saved.pop(j)
                gy = g[j] if me == n - 1 else incoming
                inputs = ([x] if x.requires_grad else []) + [ctx.leaves[i] for i in wrt]
                got = torch.autograd.grad(y, inputs, gy, allow_unused=True)
                if x.requires_grad:
                    dx, got = got[0], got[1:]
                    send = dx if dx is not None else torch.zeros_like(x)
                    if me == 0 and dmicro is not None:
                        dmicro[j] = send
                for i, gi in zip(wrt, got):
                    if gi is not None:
                        grads[i] = gi if grads[i] is None else grads[i] + gi
            if t > 0 and n > 1:
                incoming = _shift(send if send is not None else
                                  torch.zeros(shape[1:], dtype=dtype, device=device),
                                  axis, -1)
        ctx.saved = None
        for i in wrt:
            if grads[i] is None:
                grads[i] = torch.zeros_like(ctx.leaves[i])
        return (None, None, None, dmicro, *grads)


def pipeline_apply(stage_fn: Callable, stage_params: Any,
                   microbatches: torch.Tensor, axis_name: str = "pp") -> torch.Tensor:
    """Run a pipeline of ``N = axis size`` stages over M microbatches, on
    the bound axis ``axis_name``. Per rank: ``stage_params`` is THIS rank's
    stage (a pytree of tensors), ``microbatches`` [M, B, ...] the whole
    stream (every rank passes it; only stage 0 reads it). Returns [M, B,
    ...]: the last rank's outputs there, zeros elsewhere, as the JAX
    package's. Differentiable in the parameters and the microbatches (each
    rank's own part: stage 0's input gradient on rank 0, zeros elsewhere).
    Raises ``ValueError`` on every rank if the stage changes the
    activation's shape."""
    axis = _mesh.Axis.of(axis_name)
    got = _out_shape(stage_fn, stage_params, microbatches[0])
    if got != tuple(microbatches.shape[1:]):
        raise ValueError(
            "pipeline stages must preserve activation shape "
            f"(got {tuple(microbatches.shape[1:])} -> {got})")
    leaves, spec = pytree.tree_flatten(stage_params)
    needs = torch.is_grad_enabled() and (microbatches.requires_grad or any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in leaves))
    if not needs:
        return _forward_ticks(stage_fn, stage_params, microbatches, axis,
                              keep=False)[0]
    return _Pipeline.apply(stage_fn, axis, spec, microbatches, *leaves)


class _FromLast(torch.autograd.Function):
    """The last rank's outputs on every rank (the reference's masked
    ``psum``: the other ranks hold zeros). The output is replicated and so
    is its cotangent: the backward gives it to the last rank alone, not
    summed over the ranks."""

    @staticmethod
    def forward(ctx, outs, axis):
        ctx.last = axis.index == axis.size - 1
        return _from_last(outs, axis)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def _from_last(outs, axis):
    import torch.distributed as dist

    out = outs.detach().clone()
    dist.all_reduce(out, group=axis.group)
    return out


def pipeline_sharded(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                     mesh, num_microbatches: int, axis: str = "pp") -> torch.Tensor:
    """The pipeline over ``mesh``'s axis ``axis`` on every rank's same
    ``x`` [B, ...], split into ``num_microbatches``: each rank passes its
    own stage (``stage_params``, a pytree of tensors) and gets the whole
    output [B, ...], the same on every rank. A loss taken from it on every
    rank alike is the loss (not a share of it): after ``backward`` each
    rank holds its stage's gradients and the input's whole gradient.
    Raises ``ValueError`` if M does not divide the batch."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} microbatches")
    micro = x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
    with _mesh.bound_axes(mesh):
        ax = _mesh.Axis.of(axis)
        if ax.size == 1:  # the one rank is the last stage
            out = pipeline_apply(stage_fn, stage_params, micro, axis)
        else:
            if torch.is_grad_enabled() and micro.requires_grad:
                micro = _mesh.replicated(micro, ax.group)
            outs = pipeline_apply(stage_fn, stage_params, micro, axis)
            out = (_FromLast.apply(outs, ax) if outs.requires_grad
                   else _from_last(outs, ax))
    return out.reshape(b, *out.shape[2:])
