"""Observability of the port: its own copies of the parts of
``raydp_tpu/obs`` that the estimator's fit reports through.

- **Tracing** (``obs.span`` / ``obs.instant`` / ``obs.collect``): spans as
  plain dicts, caught by thread-local collectors (the fit's epoch and
  compile times and ``explain_last_fit`` read these) and, with
  ``RAYDP_TPU_TRACE=1``, kept in a local ring. Shipping them to a cluster
  head waits for the port's cluster runtime.
- **Metrics** (``obs.metrics``): the always-on process-local registry of
  counters, gauges and histograms (``estimator.*``, ``mem.*``).
- **Profiler** (``obs.profile_fit``, ``obs.sample_memory``): the step
  recorder, capture windows through ``torch.profiler``, fit attribution
  and the memory plane (``obs/profiler.py``).
- **Cost model** (``obs/costmodel.py``): FLOPs, device peaks, MFU.

Still to port (ROADMAP Queue 1): the time-series mirror, export to
Perfetto JSON, the flight recorder, shipping to the head and
``explain_last_query``.
"""

from __future__ import annotations

from raydp_tpu_torch.obs.logging import get_logger, log
from raydp_tpu_torch.obs.metrics import metrics
from raydp_tpu_torch.obs.tracing import (
    collect,
    current_context,
    current_sinks,
    enabled,
    flush,
    flush_throttled,
    instant,
    record_span,
    span,
    use_context,
    use_sinks,
)

__all__ = [
    "collect",
    "current_context",
    "current_sinks",
    "enabled",
    "flush",
    "flush_throttled",
    "get_logger",
    "instant",
    "log",
    "metrics",
    "profile_fit",
    "record_span",
    "sample_memory",
    "span",
    "use_context",
    "use_sinks",
]


def profile_fit(steps: int = 16, out_dir=None, torch_trace: bool = True):
    """Arm a bounded fit capture window (obs/profiler.py): the
    ``torch.profiler`` trace covers the first ``steps`` train steps, the
    span capture the whole ``with`` body."""
    from raydp_tpu_torch.obs.profiler import profile_fit as _profile_fit

    return _profile_fit(steps=steps, out_dir=out_dir, torch_trace=torch_trace)


def sample_memory(force: bool = False):
    """Sample this process's memory plane now (obs/profiler.py)."""
    from raydp_tpu_torch.obs.profiler import sample_memory as _sample

    return _sample(force=force)
