"""Observability of the port: its own copy of ``raydp_tpu/obs``, which the
estimator's fit, the decode engine and the cluster runtime report through.

- **Tracing** (``obs.span`` / ``obs.instant`` / ``obs.collect``): spans as
  plain dicts, caught by thread-local collectors (the fit's epoch and
  compile times and ``explain_last_fit`` read these) and, with
  ``RAYDP_TPU_TRACE=1`` (or ``tracing.set_enabled``), kept in a ring that
  ships to the cluster head on ``obs.flush`` with the metrics snapshot and
  the log ring, trace and span ids riding the cluster's RPC frames;
  ``obs.mint_context`` makes a sampled stream's root, and
  ``obs.set_process_role`` names this process's track.
- **Metrics** (``obs.metrics``): the always-on process-local registry of
  counters, gauges and histograms (``estimator.*``, ``serve.decode.*``,
  ``serve.{ttft,tpot}_ms``, ``mem.*``, ``cluster.*``);
  ``obs.dump_metrics()`` merges every process's from the head.
- **Time series** (``obs/timeseries.py``): the head's store behind its
  Prometheus scrape endpoint and ``cluster.query_metrics``, and a windowed
  process-local mirror fed by every flush (``obs.query_local_series``).
- **Export** (``obs.export_trace``): the cluster's trace as Perfetto JSON.
- **Flight recorder** (``obs/recorder.py``): the recent-log ring (the
  decode engine's ``serve.decode.state`` notes among its lines), the
  head's per-process rings and the crash dossier it writes on a terminal
  actor death.
- **Profiler** (``obs.profile_fit``, ``obs.sample_memory``): the step
  recorder, capture windows through ``torch.profiler``, fit attribution
  and the memory plane, with ``current_mem_pressure`` behind the decode
  engine's admission veto (``obs/profiler.py``).
- **Analysis** (``obs/analysis.py``): critical-path attribution of a
  fit and of an ETL session's last query (``obs.explain_last_query``),
  and ``explain_stream`` of a decode stream's record.
- **Cost model** (``obs/costmodel.py``): FLOPs, device peaks, MFU.

Stdlib only at import (torch is imported where a function needs it): the
head, the agents and the zygote import this package.
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
    mint_context,
    record_span,
    set_process_role,
    span,
    use_context,
    use_sinks,
    with_context,
)

__all__ = [
    "collect",
    "current_context",
    "current_sinks",
    "dump_metrics",
    "enabled",
    "explain_last_query",
    "export_trace",
    "flush",
    "flush_throttled",
    "get_logger",
    "instant",
    "log",
    "metrics",
    "mint_context",
    "profile_fit",
    "query_local_series",
    "record_span",
    "sample_memory",
    "set_process_role",
    "span",
    "use_context",
    "use_sinks",
    "with_context",
]


def export_trace(path: str) -> str:
    """Write this process's trace as Chrome-trace/Perfetto JSON
    (obs/export.py)."""
    from raydp_tpu_torch.obs.export import export_trace as _export

    return _export(path)


def explain_last_query(session=None, top_k: int = 5) -> dict:
    """Critical-path wall-time attribution of the active session's last
    query (obs/analysis.py)."""
    from raydp_tpu_torch.obs.analysis import explain_last_query as _explain

    return _explain(session=session, top_k=top_k)


def dump_metrics() -> dict:
    from raydp_tpu_torch.obs.export import dump_metrics as _dump

    return _dump()


def query_local_series(name: str, window_s: float = 60.0, labels=None):
    """This process's windowed time-series mirror (obs/timeseries.py)."""
    from raydp_tpu_torch.obs.timeseries import query_local

    return query_local(name, window_s, labels)


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
