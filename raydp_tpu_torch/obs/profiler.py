"""Compute observatory: the port's copy of ``raydp_tpu/obs/profiler.py``.

- **Step recorder** (:class:`StepPhaseRecorder`): one fit's per-step phase
  split -- host ingest wait, H2D upload, compute dispatch, device sync --
  into ``estimator.step.{ingest,h2d,compute,sync}_ms`` histograms and
  per-fit totals. ``RAYDP_TPU_STEP_PROFILER=0`` swaps in a shared no-op.
- **Capture window** (:class:`CaptureWindow` / :func:`profile_fit`): an
  on-demand deep capture. ``torch.profiler`` takes the place of
  ``jax.profiler``: it records the host and, on a CUDA device, the card,
  and writes a Chrome trace (``trace.json``). The window always collects
  the obs span records of the wrapped region too (``spans.json``).
- **Fit attribution** (:func:`explain_fit`): the critical-path analyzer
  over a fit's span tree.
- **Memory plane** (:func:`sample_memory`): RSS, the card's allocated
  bytes (``torch.cuda.memory_allocated``, where the JAX package reads its
  device's live arrays) and host pressure, as high-watermark gauges. The
  JAX package's /dev/shm namespace bytes wait for the port's store.
  :func:`current_mem_pressure` is what the decode engine's admission veto
  reads: the live ``mem.pressure`` gauge, floored by the windowed max of
  the process-local time series. As in the JAX package it is *host* memory
  pressure (1 - MemAvailable / MemTotal). The port's KV page pool is one
  device tensor, which this gauge does not see: the pool's own page
  arithmetic guards it, and there is no device-memory veto, because the
  JAX package has none.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.obs.metrics import metrics

STEP_PROFILER_ENV = "RAYDP_TPU_STEP_PROFILER"
ARTIFACTS_DIR_ENV = "RAYDP_TPU_ARTIFACTS_DIR"

STEP_PHASES = ("ingest", "h2d", "compute", "sync")

_step_profiler_on = os.environ.get(STEP_PROFILER_ENV, "1") not in (
    "0", "false", "False"
)


def step_profiler_enabled() -> bool:
    return _step_profiler_on


def set_step_profiler(on: bool) -> None:
    """Bench/test hook (the step recorder's on/off probe); prefer the env
    var so spawned processes agree."""
    global _step_profiler_on
    _step_profiler_on = bool(on)


def artifacts_dir(*sub: str) -> str:
    """The artifact root (``artifacts/`` or ``RAYDP_TPU_ARTIFACTS_DIR``),
    with optional subdirs, created on demand."""
    root = os.environ.get(ARTIFACTS_DIR_ENV, "artifacts")
    path = os.path.join(root, *sub) if sub else root
    os.makedirs(path, exist_ok=True)
    return path


# ---------------------------------------------------------------------------
# step recorder
# ---------------------------------------------------------------------------


class _NoopRecorder:
    """Shared do-nothing recorder for the disabled arm."""

    __slots__ = ()
    enabled = False
    steps = 0

    def note(self, phase: str, seconds: float, steps: int = 1) -> None:
        pass

    def totals(self) -> Dict[str, float]:
        return {}


_NOOP_RECORDER = _NoopRecorder()


class StepPhaseRecorder:
    """Accumulates one fit's per-step phase split.

    ``note(phase, seconds, steps)`` charges ``seconds`` of wall time to a
    phase across ``steps`` train steps: once a step, or once a segment of
    ``steps`` steps (the histogram then records the per-step average of
    the segment). ``steps`` counts the steps noted under ``compute``.
    Notes come from the consumer and from the stream's producer thread,
    so the totals are updated under a lock."""

    __slots__ = ("enabled", "steps", "_totals", "_hists", "_lock")

    def __init__(self):
        self.enabled = True
        self.steps = 0
        self._totals = {phase: 0.0 for phase in STEP_PHASES}
        self._hists = {
            phase: metrics.histogram(f"estimator.step.{phase}_ms")
            for phase in STEP_PHASES
        }
        self._lock = threading.Lock()

    def note(self, phase: str, seconds: float, steps: int = 1) -> None:
        seconds = max(seconds, 0.0)
        with self._lock:
            self._totals[phase] += seconds
            if phase == "compute":
                self.steps += steps
        self._hists[phase].observe(seconds / max(steps, 1) * 1000.0)

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)


def step_recorder() -> Any:
    """A fresh recorder for one fit, or the shared no-op when the step
    profiler is off."""
    return StepPhaseRecorder() if _step_profiler_on else _NOOP_RECORDER


# ---------------------------------------------------------------------------
# capture window
# ---------------------------------------------------------------------------

_capture_lock = threading.Lock()
_armed_capture: Optional["CaptureWindow"] = None


def armed_capture() -> Optional["CaptureWindow"]:
    """The capture window the next (or current) fit should feed, if any."""
    return _armed_capture


class CaptureWindow:
    """On-demand deep capture of a compute region.

    - ``steps=None`` (:func:`capture`): the ``torch.profiler`` trace
      brackets the ``with`` body.
    - ``steps=N`` (:func:`profile_fit`): the window arms itself; the
      estimator calls :meth:`begin_steps` before its steps and
      :meth:`note_step` after them, and the trace stops after N steps
      while the fit runs on.

    Either way the window's obs span records are collected on the entering
    thread and written to ``<out_dir>/spans.json`` at exit; the trace (with
    ``torch_trace``) goes to ``<out_dir>/torch_trace/trace.json``.
    ``result()`` summarizes."""

    def __init__(self, steps: Optional[int] = None,
                 out_dir: Optional[str] = None, torch_trace: bool = True):
        from raydp_tpu_torch.obs import tracing

        self.steps = int(steps) if steps else None
        self.out_dir = out_dir or os.path.join(
            artifacts_dir("profiles"), time.strftime("%Y%m%dT%H%M%S")
        )
        self._want_trace = bool(torch_trace)
        self._collector = tracing.collect()
        self.records: List[dict] = []
        self.trace_path: Optional[str] = None
        self._prof = None
        self._budget_done = False
        self._seen_steps = 0
        self.path: Optional[str] = None

    # -- torch.profiler half ---------------------------------------------

    def _start_trace(self) -> None:
        if not self._want_trace or self._prof is not None:
            return
        self._prof = start_trace()
        if self._prof is None:
            self._want_trace = False  # another trace runs: spans only

    def _stop_trace(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self.trace_path = stop_trace(prof, os.path.join(self.out_dir,
                                                        "torch_trace"))

    # -- fit-step protocol (driven by the estimator) ---------------------

    def begin_steps(self) -> None:
        """Steps of the captured fit are about to run: start the trace,
        unless the step budget is spent."""
        if self.steps is not None and not self._budget_done:
            self._start_trace()

    def note_step(self, n: int = 1) -> None:
        if self.steps is None:
            return
        self._seen_steps += n
        if self._seen_steps >= self.steps and not self._budget_done:
            self._budget_done = True
            self._stop_trace()

    # -- context manager -------------------------------------------------

    def __enter__(self) -> "CaptureWindow":
        global _armed_capture
        with _capture_lock:
            if _armed_capture is not None:
                raise RuntimeError("another profiler capture is active")
            _armed_capture = self
        self.records = self._collector.__enter__()
        if self.steps is None:
            self._start_trace()
        return self

    def __exit__(self, *exc) -> bool:
        global _armed_capture
        self._stop_trace()
        self._collector.__exit__(*exc)
        with _capture_lock:
            if _armed_capture is self:
                _armed_capture = None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(self.out_dir, "spans.json")
            with open(path, "w") as f:
                json.dump(self.records, f, default=str)
            self.path = path
        except OSError:
            self.path = None  # a full disk must not fail the profiled fit
        return False

    def result(self) -> dict:
        return {
            "out_dir": self.out_dir,
            "spans_path": self.path,
            "span_records": len(self.records),
            "trace_path": self.trace_path,
            "steps_captured": self._seen_steps if self.steps else None,
        }


_trace_lock = threading.Lock()
_trace_active = False


def start_trace():
    """A started ``torch.profiler.profile`` over the host and, when CUDA is
    initialised, the card; None when a trace is already running in this
    process (the profiler takes one at a time, so a capture window inside
    a fit with ``profile_dir`` keeps the fit's trace)."""
    global _trace_active
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _trace_lock:
        if _trace_active:
            return None
        _trace_active = True
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except BaseException:
        with _trace_lock:
            _trace_active = False
        raise
    return prof


def stop_trace(prof, trace_dir: str) -> Optional[str]:
    """Stop ``prof`` (from :func:`start_trace`) and write its Chrome trace
    to ``<trace_dir>/trace.json``; returns the path (None for no trace)."""
    global _trace_active
    if prof is None:
        return None
    try:
        prof.__exit__(None, None, None)
    finally:
        with _trace_lock:
            _trace_active = False
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def profile_fit(steps: int = 16, out_dir: Optional[str] = None,
                torch_trace: bool = True) -> CaptureWindow:
    """Arm a bounded fit capture::

        with obs.profile_fit(steps=32) as cap:
            estimator.fit(ds)
        print(cap.result())

    The trace covers the first ``steps`` train steps; the span capture the
    whole window."""
    return CaptureWindow(steps=steps, out_dir=out_dir, torch_trace=torch_trace)


def capture(out_dir: Optional[str] = None,
            torch_trace: bool = True) -> CaptureWindow:
    """Bracket-style capture (no step budget)."""
    return CaptureWindow(steps=None, out_dir=out_dir, torch_trace=torch_trace)


# ---------------------------------------------------------------------------
# fit attribution
# ---------------------------------------------------------------------------


def explain_fit(records: List[dict], top_k: int = 5) -> dict:
    """Critical-path attribution of one fit's span records (the
    ``estimator.fit`` tree: epoch, compile and eval children, epoch leaves
    split by the step recorder's ingest/h2d/compute/sync args).
    ``Estimator.explain_last_fit()`` is the instance-method spelling."""
    from raydp_tpu_torch.obs.analysis import attribute, format_report

    report = attribute(records, root_name="estimator.fit", top_k=top_k)
    report["text"] = format_report(report)
    return report


# ---------------------------------------------------------------------------
# memory plane
# ---------------------------------------------------------------------------

MEM_SAMPLE_MIN_INTERVAL_S = 1.0

_mem_lock = threading.Lock()
_last_mem_sample = 0.0
_page_size = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _read_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _page_size
    except (OSError, ValueError, IndexError):
        try:
            import resource

            # ru_maxrss is the PEAK (KB on linux): a stand-in where /proc
            # is absent
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, OSError):
            return None


def _device_live_bytes() -> Optional[int]:
    """Bytes the caching allocator has handed out on the current card, only
    where CUDA is already initialised (the sampler must not be the thing
    that creates a CUDA context)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return int(torch.cuda.memory_allocated())


def _mem_pressure() -> Optional[float]:
    """Host memory pressure in [0, 1]: 1 - MemAvailable/MemTotal."""
    try:
        total = avail = None
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = float(line.split()[1])
                if total is not None and avail is not None:
                    break
        if not total or avail is None:
            return None
        return max(0.0, min(1.0, 1.0 - avail / total))
    except (OSError, ValueError, IndexError):
        return None


def sample_memory(force: bool = False) -> Optional[dict]:
    """Sample this process's memory plane into the registry
    (high-watermark gauges ``mem.{rss,device}_bytes`` and
    ``mem.pressure``), at most once every
    :data:`MEM_SAMPLE_MIN_INTERVAL_S` unless ``force``; returns the sample
    dict, or None when throttled."""
    global _last_mem_sample
    now = time.monotonic()
    with _mem_lock:
        if not force and now - _last_mem_sample < MEM_SAMPLE_MIN_INTERVAL_S:
            return None
        _last_mem_sample = now
    sample: Dict[str, float] = {}
    for key, value in (("rss_bytes", _read_rss_bytes()),
                       ("device_bytes", _device_live_bytes()),
                       ("pressure", _mem_pressure())):
        if value is not None:
            sample[key] = float(value)
            metrics.gauge(f"mem.{key}").set_watermark(value)
    return sample


def current_mem_pressure(window_s: float = 10.0) -> float:
    """Host memory pressure as the admission veto reads it: the max over
    this process's recent windowed ``mem.pressure`` series, with the live
    gauge as the freshness floor."""
    from raydp_tpu_torch.obs import timeseries

    sample_memory()
    live = metrics.gauge("mem.pressure").value
    windowed = timeseries.windowed_local("mem.pressure", window_s=window_s)
    if windowed["series"] and windowed["max"] is not None:
        return max(live, windowed["max"])
    return live
