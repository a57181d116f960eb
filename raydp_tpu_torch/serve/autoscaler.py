"""Serving controller: SLO-aware autoscaling + replica self-healing; the
port's copy of ``raydp_tpu/serve/autoscaler.py``.

One background thread per deployment, ticking every ``serve.autoscale.tick_s``
seconds:

- **healing** (always on): replicas the batcher marked failed — or the head
  reports DEAD — are replaced with fresh spawns (warm zygote forks), keeping
  the deployment at its target count. The batcher keeps serving with the
  survivors meanwhile; this is the actuator half of zero-drop failover.
- **autoscaling** (``serve.autoscale.enabled``): the decision inputs are the
  ``obs`` gauges the batcher maintains — ``serve.queue_depth`` (rows of
  admission backlog) and ``serve.p99_ms`` (windowed completion latency) —
  evaluated with the SUSTAINED-signal shape of the ETL plane's
  ``etl.dynamicAllocation.sustainedStages``: only ``sustained_ticks``
  CONSECUTIVE over-threshold ticks scale out (one burst must not fork
  replicas that idle-drain seconds later), and only as many consecutive
  fully-idle ticks scale back in. Scale-out spawns (bounded by
  ``max_replicas``); scale-in picks the youngest replica and DRAINS it —
  the batcher stops routing to it, its in-flight batches complete, then it
  is killed (bounded by ``min_replicas``).

The signal read is injectable (``signal_fn``) so policy decisions are unit-
testable without load generation.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from raydp_tpu_torch import obs


class ServeController:
    def __init__(self, deployment, conf,
                 signal_fn: Optional[Callable[[], dict]] = None):
        self._deployment = deployment
        self._conf = conf
        self._signal_fn = signal_fn or self._default_signals
        self._stop = threading.Event()
        self._hot_streak = 0
        self._idle_streak = 0
        self._thread = threading.Thread(
            target=self._run, name="serve-controller", daemon=True
        )
        self._thread.start()

    def _default_signals(self) -> dict:
        """The decision inputs, read from the WINDOWED time-series mirror
        (obs/timeseries.py) with the live gauges as the freshness floor:
        the p99 signal is the max over the recent window — one sub-tick dip
        between flushes must not reset a sustained-breach streak — and a
        scrape of the head shows a controller-shaped consumer the exact
        same series (docs/observability.md "Time series")."""
        from raydp_tpu_torch.obs import timeseries as _ts

        p99 = obs.metrics.gauge("serve.p99_ms").value
        # window ~2 ticks: wide enough to bridge a sub-tick dip between
        # flushes, NARROWER than the sustained period — a single spiky
        # flush must not read as hot for >= sustained_ticks consecutive
        # ticks (that would convert one burst sample into a scale-out,
        # the exact failure the sustained-signal shape exists to prevent)
        window_s = max(2.0 * self._conf.tick_s, 0.5)
        windowed = _ts.windowed_local("serve.p99_ms", window_s=window_s)
        if windowed["series"]:
            p99 = max(p99, windowed["max"] or 0.0)
        from raydp_tpu_torch.obs.profiler import current_mem_pressure

        return {
            "queue_rows": obs.metrics.gauge("serve.queue_depth").value,
            "inflight": self._deployment.batcher.inflight_total(),
            "p99_ms": p99,
            # memory watermark plane: scale-out is vetoed while the host
            # is under memory pressure (tick() reads this)
            "mem_pressure": current_mem_pressure(window_s=window_s),
        }

    def _run(self) -> None:
        while not self._stop.wait(self._conf.tick_s):
            try:
                self.tick()
                # the serving driver's ~1s telemetry tick: ship the batcher
                # gauges/histograms so the head TSDB (scrape endpoint,
                # query_metrics) stays live under request load — and feed
                # this process's own windowed mirror for the signals above
                obs.flush_throttled(1.0)
            except Exception:
                obs.log.error("serve controller tick failed", exc_info=True)

    def tick(self) -> Optional[str]:
        """One control decision; returns "out"/"in"/None (tests call this
        directly with an injected signal_fn)."""
        deployment = self._deployment
        deployment.heal()
        if not self._conf.autoscale:
            return None
        signals = self._signal_fn()
        replicas = max(1, deployment.replica_count())
        backlog = signals.get("queue_rows", 0.0) / replicas
        p99 = signals.get("p99_ms", 0.0)
        slo = self._conf.slo_p99_ms
        hot = backlog > self._conf.target_queue_per_replica or (
            slo is not None and p99 > slo
        )
        idle = (
            signals.get("queue_rows", 0.0) == 0
            and signals.get("inflight", 0) == 0
            and (slo is None or p99 < slo / 2)
        )
        self._hot_streak = self._hot_streak + 1 if hot else 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if (
            self._hot_streak >= self._conf.sustained_ticks
            and replicas < self._conf.max_replicas
        ):
            pressure = signals.get("mem_pressure", 0.0) or 0.0
            if pressure > self._conf.max_mem_pressure:
                # hot but the HOST is out of memory headroom: forking a
                # replica would trade latency for an OOM — hold, keep the
                # streak hot, and leave a visible marker
                obs.metrics.counter("serve.scale_out_vetoed_mem").inc()
                obs.instant("serve.autoscale_veto_mem",
                            mem_pressure=round(pressure, 4))
                return None
            self._hot_streak = 0
            deployment.scale_to(replicas + 1)  # counts serve.scale_out
            obs.instant("serve.autoscale_out", replicas=replicas + 1,
                        backlog=backlog, p99_ms=p99)
            return "out"
        if (
            self._idle_streak >= self._conf.sustained_ticks
            and replicas > self._conf.min_replicas
        ):
            self._idle_streak = 0
            deployment.scale_to(replicas - 1)  # counts serve.scale_in
            obs.instant("serve.autoscale_in", replicas=replicas - 1)
            return "in"
        return None

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
