"""Model replica actors: the serving plane's unit of capacity; the port's
copy of ``raydp_tpu/serve/replica.py``.

A replica is an ordinary cluster actor (forked from the zygote like every
light actor -- set ``RAYDP_TPU_TORCH_ZYGOTE_WARM_TORCH=1`` before the first
``cluster.init`` on a machine to put torch and the port's model and serving
modules into the fork template, so a replica's spin-up is the fork, the
CUDA context and the checkpoint) that

- loads a checkpoint through the port's ``Estimator``
  (``load_latest_checkpoint``: parameters only, no optimizer state) on
  ``spec.device`` -- the card unless the spec asks for the CPU; a replica
  that finds no card raises, it never serves on the CPU unasked;
- warms each batch-shape bucket once per generation, where the JAX package
  compiles it ahead of time: one call at that shape under
  ``torch.no_grad()``, counted by ``obs.costmodel.count_flops`` (what the
  port's kernels report included), the shape kept in an LRU of
  ``MAX_COMPILED`` shapes. The batcher pads every dispatch to a bucket, so
  a replica runs few shapes and each shape's numerics are bit-stable: at a
  fixed shape per-row results do not depend on the batch's other rows,
  which is what makes kill/no-kill byte-identity gates honest;
- swaps a whole generation (module, fingerprint, warmed shapes)
  ATOMICALLY on ``reload``: a new module loads the newest checkpoint and is
  warmed while the old one serves every in-flight and concurrent request,
  so a rolling reload never serves half-loaded state.

Inference is pure and stateless between requests -- a re-dispatched
request (replica SIGKILLed mid-flight) recomputes the identical answer,
which is the whole basis of the batcher's zero-drop re-admission.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

from raydp_tpu_torch import obs, sanitize
from raydp_tpu_torch.exchange.features import (
    as_feature_rows,
    f0,
    f_slice,
    fmap,
    pad_rows,
)


@dataclass
class ReplicaSpec:
    """Everything a replica process needs to build its model and serve it.
    Travels cloudpickled inside the actor spawn spec; deliberately holds NO
    trained weights -- the checkpoint directory is the weight channel, which
    is what makes rolling reload and post-crash respawn trivially correct.

    ``model`` is what ``Estimator(model=...)`` takes: best a model class of
    the port or a ``functools.partial`` of one (called with ``device`` and
    ``seed``), which cloudpickle carries by reference; a module instance is
    copied for each generation."""

    model: Any
    checkpoint_dir: str
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    # optional example feature row(s): lets the replica warm every bucket
    # at load time (boot and reload both), so no request ever pays a warm.
    # Without it buckets warm on first use.
    example: Any = None
    name: str = "default"
    extra_estimator_kwargs: dict = field(default_factory=dict)
    # DecodeEngine kwargs (serve/decode.py) -- non-empty enables the
    # decode_submit/decode_poll streaming surface on each replica
    decode: dict = field(default_factory=dict)
    # where the replica serves: None is the card, "cpu" the CPU
    device: Any = None


def _peak_op_type(module: torch.nn.Module) -> str:
    """The ``device_peak_flops`` op type of the module's compute dtype."""
    dtype = getattr(module, "dtype", None)
    if dtype is None:
        dtype = next(module.parameters()).dtype
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


class _ModelState:
    """One immutable generation of servable state. ``infer`` reads the
    replica's ``_active`` reference once and works off this object alone, so
    a concurrent reload (which builds a whole new _ModelState and swaps the
    reference) can never expose a torn view."""

    __slots__ = (
        "fingerprint", "epoch", "step", "module", "device", "peak",
        "compiled", "flops",
    )

    # with dynamic batching ON the shape set is exactly the bucket ladder;
    # OFF dispatches raw request shapes -- bound the cache so an adversarial
    # shape stream cannot grow it without limit (LRU 32, the JAX package's)
    MAX_COMPILED = 32

    def __init__(self, fingerprint, epoch, step, module, device):
        from raydp_tpu_torch.obs.costmodel import device_peak_flops

        self.fingerprint = fingerprint
        self.epoch = epoch
        self.step = step
        self.module = module
        self.device = device
        # the card's table peak for the model's compute dtype (None when
        # the device is not in the table: the mfu gauge then never moves)
        self.peak = device_peak_flops(device, _peak_op_type(module))["peak"]
        self.compiled: "OrderedDict[tuple, bool]" = OrderedDict()  # warmed shape keys
        self.flops: dict = {}  # shape key -> counted FLOPs per call

    @staticmethod
    def _shape_key(x):
        if isinstance(x, tuple):
            return tuple((a.shape, str(a.dtype)) for a in x)
        return ((x.shape, str(x.dtype)),)

    def run(self, x) -> np.ndarray:
        """The module on a host feature batch; f32 numpy back on the host
        (the copy back is the sync that ends the call on the card)."""
        on_device = (
            torch.cuda.device(self.device) if self.device.type == "cuda"
            else contextlib.nullcontext()
        )
        with on_device, torch.no_grad():
            out = self.module(fmap(
                lambda a: torch.as_tensor(a).to(self.device), x))
            return out.float().cpu().numpy()

    def warm_for(self, x) -> None:
        """Warm this batch's exact shape on a miss: one call, counted.
        Lock-free: two threads racing the same miss both warm and one wins
        the slot -- wasteful once, never wrong."""
        key = self._shape_key(x)
        if key in self.compiled:
            return
        from raydp_tpu_torch.obs.costmodel import count_flops

        with obs.span("serve.replica_compile", bucket=int(len(f0(x)))):
            # the FLOPs are counted HERE, inside the one-time warm (boot or
            # first touch), so no request's latency carries the count
            _, flops = count_flops(lambda: self.run(x))
        obs.metrics.counter("serve.replica.compiles").inc()
        self.flops[key] = flops
        self.compiled[key] = True
        while len(self.compiled) > self.MAX_COMPILED:
            try:
                evicted, _ = self.compiled.popitem(last=False)
                self.flops.pop(evicted, None)
            except KeyError:  # a racing evictor emptied the cache first
                break

    def flops_for(self, x):
        """The counted FLOPs per call of this batch shape (None before the
        shape's warm recorded it) -- the numerator of the live serve.mfu
        gauge. A pure cache read: the request path never pays the count."""
        return self.flops.get(self._shape_key(x))


class ModelReplica:
    """The actor class. Spawned with ``max_concurrency >= 2`` so ``reload``
    (and health probes) proceed while ``infer`` traffic is in flight."""

    def __init__(self, spec: ReplicaSpec):
        from raydp_tpu_torch._device import resolve_device

        self._spec = spec
        self._device = resolve_device(spec.device)  # no card: raise
        self._active: Optional[_ModelState] = None
        # serializes reloads only -- infer never takes it (infer reads the
        # _active reference, which swaps atomically)
        self._reload_lock = sanitize.named_lock(
            "serve.replica_reload", threading.Lock()
        )
        # lazy decode engine (serve/decode.py): built on the first
        # decode_submit so non-streaming deployments pay nothing
        self._decode = None
        self._decode_lock = sanitize.named_lock(
            "serve.replica_decode", threading.Lock()
        )
        self._load_s: dict = {}  # the last load's split, for info()
        self._load()  # a replica is never "up but weightless"

    # -- lifecycle -----------------------------------------------------

    def _load(self) -> dict:
        """Restore the newest committed checkpoint into a NEW module and
        build a fresh generation, warming the configured buckets BEFORE the
        swap: until the new state is warm, ``self._active`` (the old
        weights) keeps serving -- the rolling-reload contract."""
        from raydp_tpu_torch.estimator import Estimator

        spec = self._spec
        with self._reload_lock:
            t0 = time.perf_counter()
            model = spec.model
            if isinstance(model, torch.nn.Module):
                model = copy.deepcopy(model)  # a generation never shares weights
            est = Estimator(
                model=model, checkpoint_dir=spec.checkpoint_dir,
                device=self._device, **dict(spec.extra_estimator_kwargs),
            )
            epoch, step = est.load_latest_checkpoint()
            fingerprint = hashlib.blake2b(
                f"{spec.checkpoint_dir}:{epoch}:{step}".encode(),
                digest_size=8,
            ).hexdigest()
            state = _ModelState(fingerprint, epoch, step,
                                est.get_model().eval(), self._device)
            t1 = time.perf_counter()
            if spec.example is not None:
                rows = as_feature_rows(spec.example)
                for bucket in spec.buckets:
                    if int(bucket) >= len(f0(rows)):
                        state.warm_for(pad_rows(rows, int(bucket)))
            self._load_s = {"checkpoint": t1 - t0,
                            "warm": time.perf_counter() - t1}
            self._active = state  # the atomic swap: new weights go live here
            # a live decode engine holds the OLD module -- retire it; the
            # next decode_submit rebuilds against the new generation
            # (in-flight streams fail fast and the client re-prefills, as
            # after a replica death)
            with self._decode_lock:
                stale, self._decode = self._decode, None
            if stale is not None:
                stale.close()
            obs.metrics.counter("serve.replica.reloads").inc()
            obs.flush_throttled()
            return self.info()

    def infer(self, x, n_valid: int):
        """Run the batch through the active generation and return
        ``(rows, compute_s)``: the FIRST ``n_valid`` prediction rows as host
        numpy -- padded rows are sliced off server-side, so they cannot leak
        into any response -- plus the measured compute seconds (the batcher's
        per-stage latency decomposition and the dispatch-vs-compute split in
        request traces both read it). The ``serve.replica_infer`` span
        parents under the dispatching batch's trace context, which rode in
        on the RPC frame -- the replica-side hop of a sampled request
        trace."""
        state = self._active
        with obs.span(
            "serve.replica_infer", rows=int(n_valid),
            fingerprint=state.fingerprint,
        ):
            state.warm_for(x)
            t0 = time.perf_counter()
            out = state.run(x)[: int(n_valid)]
            compute_s = time.perf_counter() - t0
        obs.metrics.counter("serve.replica.infers").inc()
        obs.metrics.counter("serve.replica.rows").inc(int(n_valid))
        obs.metrics.histogram("serve.replica.compute_s").observe(compute_s)
        # live serving MFU: the counted FLOPs of this exact shape over
        # measured compute, against the device's table peak -- the serving
        # twin of the estimator's fit-loop mfu gauge
        flops = state.flops_for(x)
        if flops and state.peak and compute_s > 0:
            obs.metrics.gauge("serve.mfu").set(flops / compute_s / state.peak)
        obs.flush_throttled()
        return out, compute_s

    def reload(self) -> dict:
        """Pick up the newest checkpoint (rolling reload entry point). Old
        weights serve until the new generation is restored and warm."""
        return self._load()

    # -- decode serving (docs/serving.md, "Decode serving") ------------

    def _decode_engine(self):
        engine = self._decode
        if engine is not None:
            return engine
        with self._decode_lock:
            if self._decode is None:
                from raydp_tpu_torch.serve.decode import DecodeEngine

                self._decode = DecodeEngine(
                    self._active.module, device=self._device,
                    **dict(self._spec.decode or {}),
                )
            return self._decode

    def decode_submit(
        self, prompt_tokens, max_new_tokens: int, stream_id=None,
        trace_ctx=None,
    ) -> str:
        """Queue an autoregressive generation on this replica's
        continuous-batching engine; returns the stream id to poll.
        ``trace_ctx`` is a sampled stream's (trace_id, root_span_id) --
        the engine's prefill + step fan-in spans parent under it, the
        replica-side hop of one stream trace."""
        return self._decode_engine().submit(
            prompt_tokens, max_new_tokens, stream_id, trace_ctx=trace_ctx
        )

    def decode_poll(self, stream_id: str, cursor: int = 0) -> dict:
        """Tokens at/after ``cursor`` plus terminal state for a stream."""
        return self._decode_engine().poll(stream_id, cursor)

    def decode_stats(self) -> dict:
        engine = self._decode
        return engine.stats() if engine is not None else {}

    def decode_explain(self, stream_id=None):
        """The engine-kept timing record for one retired stream (newest by
        default) -- fetched by ``deployment.explain_last_stream()``; works
        with tracing off. None when the engine never ran or the record
        aged out."""
        engine = self._decode
        return engine.explain(stream_id) if engine is not None else None

    def warm(self, example) -> int:
        """Warm every configured bucket for ``example``'s row shape;
        returns the number of warmed shapes in the active generation."""
        state = self._active
        rows = as_feature_rows(example)
        for bucket in self._spec.buckets:
            if int(bucket) >= len(f0(rows)):
                state.warm_for(pad_rows(rows, int(bucket)))
        return len(state.compiled)

    def profile(self, payload=None, out_dir: Optional[str] = None) -> dict:
        """On-demand compute capture of ONE warm inference (the serve
        plane's half of the compute observatory, obs/profiler.py): run
        ``payload`` (default: the deployment's warm ``example``) through
        the active generation under a capture window -- a ``torch.profiler``
        trace of the host and, once this process has a CUDA context, the
        card -- and return the capture summary + measured compute. The
        capture runs in THIS replica process; artifacts land in its
        ``artifacts/`` dir."""
        from raydp_tpu_torch.obs.profiler import capture

        source = payload if payload is not None else self._spec.example
        if source is None:
            raise ValueError(
                "profile() needs a payload (deployment has no example=)"
            )
        rows = as_feature_rows(source)
        # route through the batcher's bucket shapes (pad to the smallest
        # fitting bucket; an oversized payload is TRUNCATED to the largest
        # -- the serving path only ever runs bucket shapes, and a raw shape
        # must not warm into the bucket-keyed cache of a live replica) and
        # warm OUTSIDE the window: the capture must show one steady-state
        # inference, not a warm
        n_rows = len(f0(rows))
        if self._spec.buckets:
            fitting = [
                int(b) for b in self._spec.buckets if int(b) >= n_rows
            ]
            if fitting:
                rows = pad_rows(rows, min(fitting))
            else:
                largest = max(int(b) for b in self._spec.buckets)
                rows = f_slice(rows, 0, largest)
                n_rows = largest
        state = self._active
        state.warm_for(rows)
        state.run(rows)  # uncaptured warm-up call
        with capture(out_dir=out_dir) as cap:
            # a real span inside the window: the span capture shows at least
            # the inference interval it exists to show
            with obs.span("serve.replica_profile",
                          fingerprint=state.fingerprint):
                t0 = time.perf_counter()
                state.run(rows)
                compute_s = time.perf_counter() - t0
        result = cap.result()
        result.update({
            "compute_ms": round(compute_s * 1000.0, 3),
            "rows": n_rows,
            "batch_rows": len(f0(rows)),  # the bucket shape actually run
            "fingerprint": state.fingerprint,
        })
        return result

    def info(self) -> dict:
        """The active generation with the seconds its load took (the model
        built and its checkpoint restored; the buckets warmed). Ships this
        process's telemetry first, so the head's view of this replica is
        current when a caller inspects it."""
        obs.flush()
        state = self._active
        return {
            "name": self._spec.name,
            "pid": os.getpid(),
            "fingerprint": state.fingerprint if state else None,
            "epoch": state.epoch if state else None,
            "step": state.step if state else None,
            "buckets_compiled": len(state.compiled) if state else 0,
            "load_s": dict(self._load_s),
        }
