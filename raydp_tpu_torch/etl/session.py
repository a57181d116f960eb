"""ETL session lifecycle: the analog of the reference's ``raydp.init_spark``.

Parity map :
- ``init_etl(app_name, num_executors, executor_cores, executor_memory, ...)``
  ↔ ``raydp.init_spark`` (reference context.py:154-231): singleton guarded by
  an RLock, optional placement-group pre-creation with per-executor bundles,
  atexit cleanup.
- ``EtlSession`` ↔ ``_SparkContext`` + ``SparkCluster`` (context.py:32-147,
  ray_cluster.py:32-155): builds configs, spawns the master/holder actor and
  one restartable executor actor per requested executor.
- The named master actor ``<app>_ETL_MASTER`` ↔ ``RayDPSparkMaster``
  (ray_cluster_master.py:36-213): the long-lived ownership-transfer target so
  converted data can outlive the session (``stop_etl(cleanup_data=False)``).
- ``etl.actor.resource.cpu`` config ↔ ``spark.ray.actor.resource.cpu``
  (SparkOnRayConfigs.java:1-12): actor-scheduling CPU decoupled from task
  parallelism, enabling fractional-CPU executors.

No JVM anywhere: executors are Python actor processes running Arrow kernels.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

import pyarrow as pa

from raydp_tpu_torch.cluster import api as cluster
from raydp_tpu_torch.cluster.common import ClusterError
from raydp_tpu_torch.etl import plan as lp
from raydp_tpu_torch.etl.dataframe import DataFrame
from raydp_tpu_torch.etl.executor import EtlExecutor
from raydp_tpu_torch.etl.planner import Planner
from raydp_tpu_torch.etl.tasks import write_table_block
from raydp_tpu_torch.store.object_store import ObjectHolder
from raydp_tpu_torch.sanitize import named_lock as _named_lock
from raydp_tpu_torch.submit import submitted_overrides
from raydp_tpu_torch.utils import parse_memory_size

_lock = _named_lock("etl.session", threading.RLock())
_active_session: Optional["EtlSession"] = None

MASTER_ACTOR_SUFFIX = "_ETL_MASTER"  # parity: RAYDP_SPARK_MASTER_SUFFIX


class EtlSession:
    """A running ETL engine: master/holder actor + executor actor pool."""

    def __init__(
        self,
        app_name: str,
        num_executors: int,
        executor_cores: int,
        executor_memory: Union[str, int],
        configs: Optional[Dict[str, Any]] = None,
        placement_group_strategy: Optional[str] = None,
        placement_group: Optional[cluster.PlacementGroup] = None,
        placement_group_bundle_indexes: Optional[List[int]] = None,
        _co_tenants: int = 0,
    ):
        self.app_name = app_name
        self.num_executors = num_executors
        self.executor_cores = executor_cores
        self.executor_memory = parse_memory_size(executor_memory)
        self.configs = dict(configs or {})
        # multi-tenant plane (raydp_tpu_torch.tenancy):
        # ``tenancy.enabled`` (default ON) makes this session a named TENANT
        # of the cluster — tenant-prefixed block ids, head tenant-table
        # registration, fair-share dispatch admission, shared plan cache.
        # OFF restores the pre-tenancy single-session behavior byte-for-byte
        # (the A/B parity arm). ``_co_tenants`` is init_etl's count of other
        # live sessions on this driver: >0 selects the explicit-attach
        # capacity path below.
        self._tenancy_enabled = str(
            self.configs.get("tenancy.enabled", "true")
        ).lower() in ("1", "true", "yes")
        from raydp_tpu_torch.tenancy import registry as _treg

        self.tenant_ns = (
            _treg.tenant_namespace(app_name) if self._tenancy_enabled else ""
        )
        self._admission = None
        self._attach_node_id = None  # explicit-attach capacity, retired at stop
        if self.tenant_ns:
            # threaded to every executor/service process this session spawns
            # (their whole process writes under this tenant's namespace)
            self.configs["tenancy.namespace"] = self.tenant_ns
        # executors parallelize batched run_tasks calls with this many
        # threads (the per-task dispatch path gets the same width from the
        # actor's max_concurrency pool)
        self.configs.setdefault("etl.executor.cores", executor_cores)
        self.default_parallelism = int(
            self.configs.get(
                "etl.default.parallelism", max(2, num_executors * executor_cores)
            )
        )
        self._pg: Optional[cluster.PlacementGroup] = placement_group
        self._owns_pg = False
        self._stopped = False

        # resources are logical (the reference CI similarly starts Ray with
        # --num-cpus 6 on 2-core runners): size the cluster to the session
        actor_cpu_needed = float(
            self.configs.get("etl.actor.resource.cpu", executor_cores)
        )
        # placement-group bundles reserve full executor_cores each, even when
        # fractional actor CPUs are configured — size for whichever is larger
        per_executor_cpu = actor_cpu_needed
        if placement_group_strategy is not None or placement_group is not None:
            per_executor_cpu = max(per_executor_cpu, float(executor_cores))
        cpus_needed = num_executors * per_executor_cpu + 1.0
        memory_needed = (num_executors + 1) * self.executor_memory
        if not cluster.is_initialized():
            cluster.init(
                num_cpus=max(float(os.cpu_count() or 1), cpus_needed),
                memory=max(4 << 30, memory_needed),
            )
        elif _co_tenants > 0:
            # EXPLICIT attach semantics (tenancy): other tenants are LIVE on
            # this cluster, so free capacity is not ours to assume — add a
            # logical node holding this tenant's FULL requested quota. The
            # first tenant's executors are never resized or killed, and this
            # tenant never schedules into capacity a co-tenant's elastic
            # scale-out is about to claim. (Resources are logical, as at
            # init: the reference CI similarly over-subscribes small hosts.)
            # Remembered for stop(): the node retires with the tenant (when
            # empty), so attach/stop cycles don't inflate the resource table.
            self._attach_node_id = cluster.add_node(
                {
                    "CPU": max(1.0, cpus_needed),
                    "memory": max(float(1 << 30), float(memory_needed)),
                }
            )
        else:
            # an existing cluster may be sized for a smaller earlier session
            # (sequential re-attach — no live co-tenant): grow it by the
            # DEFICIT with an extra logical node rather than failing to
            # place, exactly the pre-tenancy behavior
            totals = cluster.total_resources()
            total_cpu = sum(r.get("CPU", 0.0) for r in totals.values())
            total_mem = sum(r.get("memory", 0.0) for r in totals.values())
            if total_cpu < cpus_needed or total_mem < memory_needed:
                cluster.add_node(
                    {
                        "CPU": max(1.0, cpus_needed - total_cpu),
                        "memory": max(float(1 << 30), memory_needed - total_mem),
                    }
                )
        if self.tenant_ns:
            # named-tenant admission at the head BEFORE any actor spawns: a
            # duplicate ACTIVE tenant (this driver or another) rejects here
            # with nothing to roll back. Quota conf:
            #   tenancy.weight            — fair-share DRR weight
            #   tenancy.max_block_bytes   — head-enforced stored-bytes cap
            #     (0 = unlimited); rejects with TenantQuotaError, typed
            try:
                cluster.head_rpc(
                    "tenant_register",
                    name=self.tenant_ns,
                    weight=float(self.configs.get("tenancy.weight", 1.0)),
                    max_block_bytes=int(
                        self.configs.get("tenancy.max_block_bytes", 0)
                    ),
                )
            except ClusterError as exc:
                if "already running" in str(exc):
                    raise RuntimeError(str(exc)) from exc
                # an OLDER head (no tenant table) degrades to untracked
                # single-tenant behavior instead of failing the session
                if "unknown head method" not in str(exc):
                    raise
                self.tenant_ns = ""
                self._tenancy_enabled = False
                self.configs.pop("tenancy.namespace", None)

        # placement group pre-creation (parity: _prepare_placement_group,
        # reference context.py:94-113)
        if placement_group_strategy is not None and placement_group is None:
            bundles = [
                {"CPU": float(executor_cores), "memory": float(self.executor_memory)}
                for _ in range(num_executors)
            ]
            self._pg = cluster.create_placement_group(
                bundles, strategy=placement_group_strategy
            )
            self._owns_pg = True
        self._bundle_indexes = placement_group_bundle_indexes

        # master actor: named, long-lived ownership target. ETL/storage
        # actors run Arrow kernels only — never torch on a card — so they
        # start "light" (forked from the zygote, or python -S; override with
        # etl.actor.light=False for UDFs that need site packages' startup)
        self._light_actors = bool(self.configs.get("etl.actor.light", True))
        # spawned non-blocking so the master's process startup overlaps the
        # executors' (they are independent); readiness is gathered below
        self.master = cluster.spawn(
            ObjectHolder, name=f"{app_name}{MASTER_ACTOR_SUFFIX}",
            max_restarts=0, light=self._light_actors, block=False,
        )

        # per-host block service (store/block_service.py): the owner of
        # record for completed executor blocks, so executor SIGKILL loses
        # zero blocks and scale-in needs no reown sweep. Spawned non-blocking
        # (zygote warm fork, like every light actor) and REGISTERED at the
        # head after the readiness barrier below — before any query runs.
        # max_restarts=3: the service is stateless (segments live in
        # /dev/shm, ownership at the head), so a crash-restart with the same
        # identity loses nothing; only an intentional kill is real loss
        # (→ lineage recovery). ``store.block_service`` conf, default ON;
        # OFF restores executor-owned blocks byte-for-byte.
        self._block_service_enabled = str(
            self.configs.get("store.block_service", "true")
        ).lower() in ("1", "true", "yes")
        self.block_service = None
        if self._block_service_enabled:
            from raydp_tpu_torch.store.block_service import (
                BLOCK_SERVICE_SUFFIX,
                BlockService,
            )

            self.block_service = cluster.spawn(
                BlockService,
                app_name,
                name=f"{app_name}{BLOCK_SERVICE_SUFFIX}",
                max_restarts=3,
                max_concurrency=4,
                light=self._light_actors,
                block=False,
            )

        # executor pool: restartable actors (parity: setMaxRestarts(3),
        # RayExecutorUtils.java:63); +1 concurrency for data-plane reads
        # (parity: setMaxConcurrency(2), :65)
        actor_cpu = float(
            self.configs.get("etl.actor.resource.cpu", executor_cores)
        )
        # etl.actor.env.FOO=bar → FOO=bar in every executor's environment
        # (the reference's spark.executorEnv.* analog)
        self._executor_env = {
            key[len("etl.actor.env."):]: str(value)
            for key, value in self.configs.items()
            if key.startswith("etl.actor.env.")
        }
        self.executors = []
        for i in range(num_executors):
            bundle = -1
            if self._pg is not None:
                indexes = self._bundle_indexes or list(range(num_executors))
                bundle = indexes[i % len(indexes)]
            # 60s covers the worst drain: a stopped tenant's executor in a
            # crash-restart loop (respawn → dead-master connect timeout →
            # crash, × max_restarts) holds its CPU charge for several
            # 15s-plus cycles before the head marks it DEAD and credits
            # the resources back
            deadline = time.monotonic() + 60.0
            while True:
                try:
                    handle = cluster.spawn(
                        EtlExecutor,
                        i,
                        app_name,
                        self.configs,
                        name=f"{app_name}-etl-executor-{i}",
                        num_cpus=actor_cpu,
                        memory=float(self.executor_memory),
                        max_restarts=3,
                        max_concurrency=max(2, executor_cores + 1),
                        placement_group=self._pg.id if self._pg else None,
                        bundle_index=bundle,
                        block=False,
                        light=self._light_actors,
                        env=self._executor_env,
                    )
                    break
                except ClusterError:
                    # a predecessor session's killed actors may still be
                    # draining their resources/names; wait briefly (other
                    # errors — bad config, pickling — fail immediately)
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            self.executors.append(handle)
        from raydp_tpu_torch import obs

        with obs.span(
            "etl.session_boot", app=app_name, executors=num_executors
        ):
            # the readiness barrier: the span shows how much of session
            # startup waits on actor spawn/warm-up on the trace timeline
            for handle in self.executors:
                handle.wait_ready()
            self.master.wait_ready()
            if self.block_service is not None:
                from raydp_tpu_torch.store import block_service as _bs

                try:
                    self.block_service.wait_ready()
                    # tenant-scoped ownership: this service adopts ONLY this
                    # tenant's handoffs, so its death at stop_etl can never
                    # tombstone a co-tenant's blocks
                    _bs.register_service(
                        self.block_service._actor_id, tenant=self.tenant_ns
                    )
                except Exception:
                    # no service, no handoff: the head falls back to
                    # executor ownership and lineage covers losses (the
                    # executor tier) — degraded, not broken, but say so
                    obs.log.warning(
                        "block service failed to start; executor death "
                        "falls back to lineage recovery", exc_info=True,
                    )
                    obs.metrics.counter(
                        "block_service.spawn_failures"
                    ).inc()
                    self.block_service = None
        obs.metrics.counter("etl.sessions_started").inc()
        self._next_executor_id = num_executors

        self._planner = Planner(
            self.executors,
            default_parallelism=self.default_parallelism,
            executor_slots=executor_cores,
        )
        # shuffle data-plane knobs:
        #   planner.shuffle_indexed_blocks (default on) — ONE indexed block
        #     per map task (M objects per shuffle, not M×R); off = legacy
        #     per-split blocks (the A/B path correctness tests compare)
        #   planner.arrow_threads (default off) — arrow kernel threading on
        #     group_by/join hot paths for multi-core deployments; plumbed to
        #     the driver-local planner here and to executors via configs
        self._planner.shuffle_indexed_blocks = str(
            self.configs.get("planner.shuffle_indexed_blocks", "true")
        ).lower() in ("1", "true", "yes")

        # millisecond control plane knobs (all default ON; parity tests flip
        # them for A/B byte-identical comparisons):
        #   planner.plan_cache        — compiled-plan cache (fingerprint →
        #                               lowered program; literals/blocks
        #                               rebind without recompilation)
        #   planner.compiled_dispatch — whole-plan run_plan dispatch (one
        #                               RPC per executor per query)
        #   planner.head_bypass       — lease-stamped location pushing +
        #                               executor-side location cache (head
        #                               lookups become the miss path)
        #   cluster.doorbell          — persistent actor dispatch sockets
        #                               (skip per-call connect/handshake)
        def _flag(name: str, default: str = "true") -> bool:
            return str(self.configs.get(name, default)).lower() in (
                "1", "true", "yes",
            )

        self._planner.plan_cache = _flag("planner.plan_cache")
        self._planner.compiled_dispatch = _flag("planner.compiled_dispatch")
        self._planner.head_bypass = _flag("planner.head_bypass")
        # lineage-based recovery: default ON —
        # a lost block re-executes its producing task on surviving
        # executors instead of failing the query; budget/depth bound a
        # flapping cluster to a fast failure
        self._planner.lineage_recovery = _flag("planner.lineage_recovery")
        self._planner.recovery_budget = int(
            self.configs.get("planner.recovery_budget", 64)
        )
        self._planner.recovery_max_depth = int(
            self.configs.get("planner.recovery_max_depth", 3)
        )
        # multi-tenant wiring (raydp_tpu_torch.tenancy):
        #   tenancy.fair_share        (default on) — fair-share dispatch
        #     admission: every stage acquires a DRR ticket sized to its
        #     width; per-tenant in-flight/queue quotas reject typed
        #   tenancy.shared_plan_cache (default on) — identical plan
        #     fingerprints from different tenants reuse one compiled
        #     program (plan_cache.cross_tenant_hits)
        #   tenancy.max_inflight_tasks / tenancy.max_queued_requests /
        #   tenancy.admission_timeout_s / tenancy.weight — scheduler knobs
        self._planner.tenant = self.tenant_ns
        if self.tenant_ns:
            self._planner.shared_plan_cache = _flag("tenancy.shared_plan_cache")
            if _flag("tenancy.fair_share"):
                from raydp_tpu_torch.tenancy import registry as _treg2

                sched = _treg2.scheduler()
                sched.register(
                    self.tenant_ns,
                    weight=float(self.configs.get("tenancy.weight", 1.0)),
                    max_inflight=int(
                        self.configs.get(
                            "tenancy.max_inflight_tasks",
                            max(8, num_executors * executor_cores * 8),
                        )
                    ),
                    max_queued=int(
                        self.configs.get("tenancy.max_queued_requests", 64)
                    ),
                    timeout_s=float(
                        self.configs.get("tenancy.admission_timeout_s", 300.0)
                    ),
                )
                self._admission = sched.handle(self.tenant_ns)
                self._planner.admission = self._admission
        from raydp_tpu_torch.store import object_store as _store

        _store.set_location_cache(self._planner.head_bypass)
        # driver-side half of the block-service toggle (executors read the
        # same conf from their configs dict): OFF keeps driver-context
        # registrations un-flagged too, for strict A/B parity
        _store.set_block_service(self._block_service_enabled)
        cluster.set_doorbell(_flag("cluster.doorbell"))
        from raydp_tpu_torch.etl import tasks as _tasks

        _tasks.set_arrow_threads(
            str(self.configs.get("planner.arrow_threads", "false")).lower()
            in ("1", "true", "yes")
        )

        # dynamic allocation (reference: Spark's doRequestTotalExecutors /
        # doKillExecutors hooks, RayCoarseGrainedSchedulerBackend.scala:
        # 229-252 — there the ENGINE decides when to scale; here the policy
        # watches stage width and idle time):
        #   etl.dynamicAllocation.enabled        (default False)
        #   etl.dynamicAllocation.maxExecutors   (default 4x initial)
        #   etl.dynamicAllocation.minExecutors   (default initial count)
        #   etl.dynamicAllocation.tasksPerSlot   (default 2)
        #   etl.dynamicAllocation.idleTimeout    (seconds, default 10)
        self._dyn_enabled = str(
            self.configs.get("etl.dynamicAllocation.enabled", "false")
        ).lower() in ("1", "true", "yes")
        self._dyn_min = int(
            self.configs.get("etl.dynamicAllocation.minExecutors", num_executors)
        )
        self._dyn_max = int(
            self.configs.get(
                "etl.dynamicAllocation.maxExecutors", max(num_executors * 4, 1)
            )
        )
        self._dyn_tasks_per_slot = max(
            1, int(self.configs.get("etl.dynamicAllocation.tasksPerSlot", 2))
        )
        self._dyn_idle_s = float(
            self.configs.get("etl.dynamicAllocation.idleTimeout", 10.0)
        )
        #   etl.dynamicAllocation.sustainedStages (default 1): how many
        #   CONSECUTIVE over-threshold stages must be observed before
        #   scaling out — >1 makes scale-out react to sustained dispatch-
        #   queue depth instead of a single wide stage (one burst should
        #   not fork executors it will idle-kill ten seconds later)
        self._dyn_sustained = max(
            1, int(self.configs.get("etl.dynamicAllocation.sustainedStages", 1))
        )
        #   etl.dynamicAllocation.maxMemPressure (default 0.95): scale-out
        #   is held while host memory pressure (the mem.pressure watermark
        #   gauge) exceeds this — same veto shape (and default) as the
        #   serve autoscaler's serve.autoscale.max_mem_pressure
        self._dyn_max_mem_pressure = float(
            self.configs.get("etl.dynamicAllocation.maxMemPressure", 0.95)
        )
        self._wide_streak = 0
        self._last_stage_ts = time.monotonic()
        self._dealloc_stop = threading.Event()
        # touch the elasticity counters so they appear in dump_metrics()
        # snapshots even before the first scale event (pinned-schema tests
        # and dashboards rely on the keys existing)
        from raydp_tpu_torch import obs as _obs

        _obs.metrics.counter("cluster.scale_out")
        _obs.metrics.counter("cluster.scale_in")
        _obs.metrics.counter("lineage.reexecuted_tasks")
        _obs.metrics.counter("lineage.recovered_blocks")
        _obs.metrics.counter("etl.task_retries")
        _obs.metrics.counter("block_service.handoffs")
        _obs.metrics.counter("etl.reown_failures")
        _obs.metrics.counter("rpc.retries")
        _obs.metrics.counter("rpc.deadline_exceeded")
        # telemetry plane v2: hand the head its
        # obs.* confs — span-ring capacity, dossier dir, and (when asked)
        # the Prometheus scrape endpoint. ``obs.scrape_port`` off by
        # default; "auto"/0 binds an ephemeral port reported back here.
        #   obs.scrape_port      — off | auto | <port>
        #   obs.head_ring_spans  — head trace-ring capacity (spans)
        #   obs.dossier_dir      — where crash dossiers land
        self.scrape_addr: Optional[tuple] = None
        scrape_conf = str(self.configs.get("obs.scrape_port", "off")).lower()
        ring_conf = self.configs.get("obs.head_ring_spans", None)
        dossier_conf = self.configs.get("obs.dossier_dir", None)
        if scrape_conf not in ("off", "", "false") or ring_conf or dossier_conf:
            try:
                settings = cluster.head_rpc(
                    "obs_configure",
                    head_ring_spans=(
                        int(ring_conf) if ring_conf is not None else None
                    ),
                    dossier_dir=(
                        str(dossier_conf) if dossier_conf else None
                    ),
                    scrape_port=(
                        (0 if scrape_conf in ("auto", "0") else int(scrape_conf))
                        if scrape_conf not in ("off", "", "false") else None
                    ),
                    timeout=15.0,
                )
                addr = settings.get("scrape_addr")
                self.scrape_addr = tuple(addr) if addr else None
            except Exception:
                # an older head without the op (or a mid-boot hiccup): the
                # session still works, just without the live endpoints
                _obs.log.warning(
                    "obs_configure failed; scrape/dossier confs not applied",
                    exc_info=True,
                )
        if self._dyn_enabled:
            self._planner.scale_hook = self._on_stage_width
            threading.Thread(
                target=self._dealloc_loop, name="etl-dealloc", daemon=True
            ).start()

    # ------------------------------------------------------------------
    # data sources
    # ------------------------------------------------------------------

    def range(
        self, start: int, end: Optional[int] = None, step: int = 1,
        num_partitions: Optional[int] = None,
    ) -> DataFrame:
        if end is None:
            start, end = 0, start
        n = num_partitions or self.default_parallelism
        return DataFrame(self, lp.RangeSource(start, end, step, n))

    def from_arrow(
        self, table: pa.Table, num_partitions: Optional[int] = None
    ) -> DataFrame:
        """Distribute a driver-local Table as object-store partitions (their
        metadata registers in ONE batched RPC frame)."""
        from raydp_tpu_torch.store import object_store as store

        n = num_partitions or self.default_parallelism
        n = max(1, min(n, max(1, table.num_rows)))
        per = -(-table.num_rows // n)
        blocks = []
        # tenant scope: driver-written source blocks mint tenant-prefixed
        # ids too, so accounting/quota and per-tenant GC keying cover them
        with store.tenant_scope(self.tenant_ns), store.batched_registration():
            for i in range(n):
                chunk = table.slice(i * per, per)
                ref, _ = write_table_block(chunk)
                blocks.append(ref)
        return DataFrame(self, lp.ArrowSource(blocks, table.schema))

    def from_pandas(self, pdf, num_partitions: Optional[int] = None) -> DataFrame:
        return self.from_arrow(
            pa.Table.from_pandas(pdf, preserve_index=False), num_partitions
        )

    createDataFrame = from_pandas

    def from_items(self, rows: List[Dict[str, Any]], num_partitions: Optional[int] = None) -> DataFrame:
        return self.from_arrow(pa.Table.from_pylist(rows), num_partitions)

    def read_parquet(
        self, paths: Union[str, Sequence[str]], num_partitions: Optional[int] = None,
        columns: Optional[List[str]] = None,
    ) -> DataFrame:
        files = _expand_files(paths, (".parquet", ".pq"))
        groups = _group_files(files, num_partitions or self.default_parallelism)
        return DataFrame(self, lp.ParquetSource(groups, columns))

    def read_csv(
        self, paths: Union[str, Sequence[str]], num_partitions: Optional[int] = None,
        **options,
    ) -> DataFrame:
        files = _expand_files(paths, (".csv", ".txt", ".tsv", ".gz"))
        groups = _group_files(files, num_partitions or self.default_parallelism)
        return DataFrame(self, lp.CsvSource(groups, options))

    @property
    def last_query_stats(self) -> dict:
        """Wall time, output partitions, and per-stage task counts/timings of
        the most recent action (first-class step timing). Derived
        from the obs layer's span records — the same ones ``export_trace``
        puts on the timeline."""
        return self._planner.last_query_stats

    def dump_metrics(self) -> dict:
        """Cluster-wide metrics snapshot (see ``cluster.dump_metrics``)."""
        return cluster.dump_metrics()

    def export_trace(self, path: str) -> str:
        """Write the cluster's collected trace as Perfetto JSON."""
        return cluster.export_trace(path)

    def query_metrics(self, name: str, window_s: float = 60.0,
                      labels: Optional[Dict[str, str]] = None,
                      aggregate: bool = False):
        """Windowed time-series from the head TSDB (see
        ``cluster.query_metrics``)."""
        return cluster.query_metrics(name, window_s, labels, aggregate)

    def explain_last_query(self, top_k: int = 5) -> dict:
        """Critical-path wall-time attribution of the last query
        (``obs.analysis.explain_last_query``)."""
        from raydp_tpu_torch.obs.analysis import explain_last_query

        return explain_last_query(session=self, top_k=top_k)

    def profile_fit(self, steps: int = 16, out_dir: Optional[str] = None,
                    torch_trace: bool = True):
        """Arm an on-demand fit capture window (obs/profiler.py)::

            with session.profile_fit(steps=32) as cap:
                estimator.fit_on_etl(df)
            cap.result()  # spans.json + torch.profiler trace under out_dir

        The ``torch.profiler`` trace covers the first ``steps`` train
        steps; the estimator's step paths drive the budget."""
        from raydp_tpu_torch.obs.profiler import profile_fit

        return profile_fit(steps=steps, out_dir=out_dir,
                           torch_trace=torch_trace)

    def mem_pressure(self, window_s: float = 10.0) -> float:
        """This driver's host memory pressure in [0, 1] (the windowed max
        of the ``mem.pressure`` series with the live gauge as floor) — the
        signal the elasticity policy and serve autoscaler consult before
        growing a pool."""
        from raydp_tpu_torch.obs.profiler import current_mem_pressure

        return current_mem_pressure(window_s=window_s)

    # ------------------------------------------------------------------
    # dynamic allocation (reference doRequestTotalExecutors/doKillExecutors,
    # RayCoarseGrainedSchedulerBackend.scala:229-252)
    # ------------------------------------------------------------------

    def __getstate__(self):
        # sessions travel inside pickled Datasets (shards shipped to rank
        # actors); thread objects are process-private, and a shipped session
        # must not run an allocation policy of its own
        state = dict(self.__dict__)
        state.pop("_dealloc_stop", None)
        state["_dyn_enabled"] = False
        # the admission handle wraps this driver's process-local scheduler
        # (thread-locals + locks): a shipped session dispatches unthrottled
        state["_admission"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._dealloc_stop = threading.Event()
        self.__dict__.setdefault("_admission", None)
        self.__dict__.setdefault("tenant_ns", "")
        self.__dict__.setdefault("_tenancy_enabled", False)
        # a SHIPPED session must never retire cluster capacity: the driver
        # that created it owns the attach node's lifecycle
        self._attach_node_id = None

    def _on_stage_width(self, num_tasks: int) -> None:
        """Scale-up half of dynamic allocation: called by the planner before
        dispatching a stage. A stage wider than tasksPerSlot × slots grows
        the pool (bounded by maxExecutors) IN TIME for this stage's dispatch
        to round-robin onto the new executors. With ``sustainedStages`` > 1
        the trigger is SUSTAINED dispatch-queue depth: only after that many
        consecutive over-threshold stages does the pool grow."""
        self._last_stage_ts = time.monotonic()
        slots = max(1, int(self.executor_cores))
        desired = -(-num_tasks // (self._dyn_tasks_per_slot * slots))
        desired = min(self._dyn_max, max(desired, len(self.executors)))
        if desired > len(self.executors):
            self._wide_streak += 1
            if self._wide_streak < self._dyn_sustained:
                return  # one wide stage is a burst, not sustained depth
            try:
                # memory watermark plane: a sustained-wide stage does not
                # justify forking executors into a host already out of
                # memory headroom (same veto shape as the serve autoscaler)
                from raydp_tpu_torch.obs.profiler import current_mem_pressure

                if current_mem_pressure() > self._dyn_max_mem_pressure:
                    from raydp_tpu_torch.obs import metrics

                    metrics.counter("etl.scale_out_vetoed_mem").inc()
                    return
                self.request_total_executors(desired)
            except ClusterError:  # no capacity: the stage runs on the current pool
                pass  # no capacity: the stage runs on the current pool
        else:
            self._wide_streak = 0

    def _dealloc_loop(self) -> None:
        """Scale-down half: after idleTimeout with no stage activity (and no
        stage in flight), shrink back to minExecutors."""
        while not self._dealloc_stop.wait(1.0):
            if (
                len(self.executors) > self._dyn_min
                and self._planner._inflight == 0
                and time.monotonic() - self._last_stage_ts > self._dyn_idle_s
            ):
                try:
                    # count is recomputed under the lock via min_keep: a
                    # concurrent explicit kill_executors could shrink the
                    # pool between this check and the victim selection
                    self.kill_executors(
                        len(self.executors),
                        only_if_idle=True,
                        min_keep=self._dyn_min,
                    )
                except Exception:
                    # idle-scale-down is opportunistic, but a persistently
                    # failing one pins the pool at max size — count it
                    from raydp_tpu_torch.obs import metrics

                    metrics.counter("etl.dynamic_scale_failures").inc()

    def prune_dead_executors(self) -> int:
        """Drop DEAD handles from the pool. Executors killed out-of-band
        (chaos SIGKILL, node loss, restarts exhausted) are skipped by the
        dispatch ladder but still COUNT toward pool size — without the
        prune, a scale-out "restoring" the pool after a loss would no-op
        against the corpses. Returns how many handles were removed."""
        from raydp_tpu_torch.cluster.common import ActorState

        dead_ids = set()
        for handle in list(self.executors):
            try:
                if handle.state() == ActorState.DEAD:
                    dead_ids.add(handle._actor_id)
            except ClusterError as exc:
                # ONLY a positive "actor unknown" counts as dead; a
                # transient head stall must not evacuate a live pool (and
                # poison the dead-owner registry for live owners) — the
                # dispatch ladder skips dead executors anyway, so keeping
                # a corpse one more round is the safe error
                if "unknown" in str(exc):
                    dead_ids.add(handle._actor_id)
            except Exception:  # transport hiccup probing liveness: keep the handle, the next prune re-checks
                pass
        if not dead_ids:
            return 0
        # same lock discipline as kill_executors: the planner's executor
        # list must never be observed mid-edit by a stage submission
        planner = self._planner
        with planner._inflight_lock:
            self.executors = [
                h for h in self.executors if h._actor_id not in dead_ids
            ]
            planner.executors = list(self.executors)
        from raydp_tpu_torch.store import object_store as _store

        for actor_id in dead_ids:
            _store.note_owner_dead(actor_id)
        return len(dead_ids)

    def request_total_executors(self, total: int) -> int:
        """Scale the executor pool up to ``total`` (no-op when already at or
        above). Dead handles are pruned first, so "restore the pool to N"
        after an executor loss really yields N LIVE executors. Returns the
        live executor count."""
        self.prune_dead_executors()
        actor_cpu = float(self.configs.get("etl.actor.resource.cpu", self.executor_cores))
        grow = total - len(self.executors)
        if grow > 0:
            # ensure capacity (resources are logical; mirror the init sizing)
            available = cluster.available_resources()
            free_cpu = sum(r.get("CPU", 0.0) for r in available.values())
            free_mem = sum(r.get("memory", 0.0) for r in available.values())
            need_cpu = grow * actor_cpu
            need_mem = grow * float(self.executor_memory)
            if free_cpu < need_cpu or free_mem < need_mem:
                cluster.add_node(
                    {
                        "CPU": max(1.0, need_cpu - free_cpu),
                        "memory": max(float(1 << 30), need_mem - free_mem),
                    }
                )
        added = 0
        t0 = time.perf_counter()
        while len(self.executors) < total:
            i = self._next_executor_id
            self._next_executor_id += 1
            handle = cluster.spawn(
                EtlExecutor,
                i,
                self.app_name,
                self.configs,
                name=f"{self.app_name}-etl-executor-{i}",
                num_cpus=actor_cpu,
                memory=float(self.executor_memory),
                max_restarts=3,
                max_concurrency=max(2, self.executor_cores + 1),
                light=self._light_actors,
                env=getattr(self, "_executor_env", {}),
            )
            self.executors.append(handle)
            added += 1
        self._planner.executors = list(self.executors)
        if added:
            from raydp_tpu_torch import obs

            # scale-out rides the zygote warm-fork spawn path — the elapsed
            # time on the instant is the sub-second-scale-out evidence
            obs.metrics.counter("cluster.scale_out").inc(added)
            obs.instant(
                "cluster.scale_out",
                added=added,
                pool=len(self.executors),
                seconds=round(time.perf_counter() - t0, 4),
            )
        return len(self.executors)

    def _service_owns_blocks(self) -> bool:
        """True when the per-host block service is the live owner of record
        — scale-in skips the reown sweep entirely (the departing executors
        never owned their blocks). A DEAD service means recently written
        blocks fell back to executor ownership (the head's handoff
        fallback), so the reown runs as before."""
        handle = self.block_service
        if handle is None:
            return False
        from raydp_tpu_torch.cluster.common import ActorState

        try:
            return handle.state() != ActorState.DEAD
        except Exception:
            # can't reach the head: assume the worst (executor-owned) and
            # let the reown path try — its own failure is now counted
            return False

    def kill_executors(
        self, count: int = 1, only_if_idle: bool = False, min_keep: int = 0
    ) -> int:
        """Scale down by killing ``count`` executors (intentional exit: no
        restart). Their blocks are RE-OWNED to the session master first —
        a graceful scale-down must not destroy still-referenced data (the
        segments survive the process; only owner-death GC would unlink them).
        The reference needs its external shuffle service for the same reason
        (ray_cluster.py:126-134).

        ``only_if_idle`` (the dealloc-loop path) makes the idle check and the
        victim selection one atomic step under the planner's inflight lock:
        a stage submission increments ``_inflight`` under the same lock
        before dispatching, so either it lands first (kill aborts) or it
        blocks until the planner's executor list no longer contains the
        victims — its tasks can never round-robin onto them."""
        from raydp_tpu_torch.cluster.common import ActorState

        planner = self._planner
        with planner._inflight_lock:
            if only_if_idle and planner._inflight != 0:
                return len(self.executors)
            # clamp INSIDE the lock: the pool may have shrunk since the
            # caller computed ``count``, and the dealloc loop must never
            # take the pool below minExecutors
            count = min(count, max(0, len(self.executors) - min_keep))
            victims = self.executors[-count:] if count else []
            self.executors = self.executors[: len(self.executors) - len(victims)]
            # sync the planner BEFORE any kill: a stage submitted during the
            # (kill + DEAD-drain) window must not round-robin onto victims
            planner.executors = list(self.executors)
        if victims and not self._service_owns_blocks():
            # No live block service (conf off, or the service died): the
            # victims own their blocks, so graceful scale-in re-replicates
            # ownership BEFORE the kill — the departing executor's blocks
            # move to the session master (their segments survive the
            # process; only owner-death GC would unlink them). Blocks the
            # reown misses — racing writes, an older head — stay covered by
            # lineage recovery. With a
            # live service this whole sweep is skipped: the blocks were
            # never executor-owned, and tests pin the zero-reown-RPC
            # contract.
            for handle in victims:
                try:
                    cluster.head_rpc(
                        "object_reown_all",
                        old_owner=handle._actor_id,
                        new_owner=self.master._actor_id,
                    )
                except Exception:
                    # best-effort stays valid (older head / racing shutdown:
                    # lineage recovery covers) — but the signal must not be
                    # invisible: a persistently failing reown means every
                    # scale-in is silently betting on lineage
                    from raydp_tpu_torch import obs

                    obs.metrics.counter("etl.reown_failures").inc()
                    obs.instant(
                        "etl.reown_failed", executor=handle._actor_id
                    )
        for handle in victims:
            try:
                handle.kill(no_restart=True)
            except Exception:  # teardown races actor death
                pass
        deadline = time.monotonic() + 15.0
        for handle in victims:
            while time.monotonic() < deadline:
                try:
                    if handle.state() == ActorState.DEAD:
                        break
                except Exception:  # teardown races actor death
                    break
                time.sleep(0.05)
        self._planner.executors = list(self.executors)
        if victims:
            from raydp_tpu_torch import obs
            from raydp_tpu_torch.store import object_store as _store

            obs.metrics.counter("cluster.scale_in").inc(len(victims))
            obs.instant(
                "cluster.scale_in",
                removed=len(victims),
                pool=len(self.executors),
            )
            # the victims are dead for good: any block the reown missed is
            # lost — feed the store's dead-owner registry so stale cached
            # locations fast-path to OwnerDiedError (→ lineage recovery)
            # instead of paying a head round trip to learn the same thing
            for handle in victims:
                _store.note_owner_dead(handle._actor_id)
        return len(self.executors)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def stop(self, cleanup_data: bool = True, del_obj_holder: bool = True) -> None:
        """Stop executors (intentional kill: no restart). Blocks owned by the
        dead executors are GC'd by the head. With ``cleanup_data=False`` the
        master/holder actor is kept alive, so blocks whose ownership was
        transferred to it survive the session — the reference's
        ``stop_spark(cleanup_data=False)`` semantics (context.py:223-231,
        test_data_owner_transfer.py:79-123)."""
        if self._stopped:
            return
        self._stopped = True
        self._dealloc_stop.set()
        # tenancy teardown FIRST: parked admissions wake (they fail fast
        # against the dying pool instead of waiting out their timeout) and
        # the head frees the tenant name for a later re-attach. Only THIS
        # tenant's scheduler state and tenant record are touched — a
        # co-tenant's dispatches, blocks, and accounting are invisible here.
        if self.tenant_ns:
            try:
                from raydp_tpu_torch.tenancy import registry as _treg

                _treg.scheduler().unregister(self.tenant_ns)
            except Exception:  # scheduler teardown is driver-local bookkeeping; the kill path below must always run
                pass
            try:
                cluster.head_rpc("tenant_unregister", name=self.tenant_ns)
            except Exception:  # head may already be down at teardown; the tenant record is advisory once the session died
                pass
        killed = list(self.executors)
        # the block service dies WITH the session (intentional kill): the
        # ownership contract — non-transferred data dies at stop
        # (test_ownership_dies_with_session) — must hold for service-owned
        # blocks exactly as it did for executor-owned ones. Data meant to
        # survive was transferred to the master before stop, as always.
        if self.block_service is not None:
            killed.append(self.block_service)
            self.block_service = None
        # stale handles must not look like a live pool (Dataset._slice_block
        # and any late queries fall back to driver-local paths)
        self._planner.executors = []
        from raydp_tpu_torch.store import object_store as _store

        for handle in killed:
            try:
                handle.kill(no_restart=True)
            except Exception:  # teardown races actor death
                pass
            # intentional kills are final: record the dead owners so stale
            # head-bypass locations fast-path to OwnerDiedError instead of
            # costing a head round trip per read (the head proactively
            # unregisters their blocks at death — satellite of the lineage
            # recovery plane)
            _store.note_owner_dead(handle._actor_id)
        self.executors = []
        # drain: wait for the head to reap the executors so their resources
        # and names are free before a subsequent init_etl schedules
        deadline = time.monotonic() + 15.0
        for handle in killed:
            while time.monotonic() < deadline:
                try:
                    from raydp_tpu_torch.cluster.common import ActorState

                    if handle.state() == ActorState.DEAD:
                        break
                except Exception:  # teardown races actor death
                    break
                time.sleep(0.002)  # the head reaps intentional kills in ~ms
        if cleanup_data and del_obj_holder:
            try:
                self.master.kill(no_restart=True)
            except Exception:  # teardown races actor death
                pass
        if self._owns_pg and self._pg is not None:
            try:
                cluster.remove_placement_group(self._pg)
            except Exception:  # teardown races placement-group removal
                pass
            self._pg = None
        attach_node = getattr(self, "_attach_node_id", None)
        if attach_node is not None:
            # retire the attach-capacity node with its tenant — but ONLY if
            # empty: a co-tenant's actor scheduled onto it must never be
            # collateral of this session's stop (the head declines then and
            # the node lingers as plain spare capacity, the lesser evil)
            try:
                cluster.head_rpc(
                    "remove_node", node_id=attach_node, only_if_empty=True
                )
            except Exception:  # head may already be down at teardown; a phantom logical node is harmless then
                pass
            self._attach_node_id = None
        from raydp_tpu_torch.tenancy import registry as _treg3

        _treg3.discard_session(self)
        global _active_session
        with _lock:
            if _active_session is self:
                _active_session = None

    def __enter__(self) -> "EtlSession":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _expand_files(paths, extensions) -> List[str]:
    import glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for ext in extensions:
                out.extend(sorted(glob.glob(os.path.join(p, f"*{ext}"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files matched {paths}")
    return out


def _group_files(files: List[str], num_partitions: int) -> List[List[str]]:
    n = max(1, min(num_partitions, len(files)))
    groups: List[List[str]] = [[] for _ in range(n)]
    for i, f in enumerate(files):
        groups[i % n].append(f)
    return groups


def init_etl(
    app_name: str,
    num_executors: int = 1,
    executor_cores: int = 1,
    executor_memory: Union[str, int] = "500M",
    configs: Optional[Dict[str, Any]] = None,
    placement_group_strategy: Optional[str] = None,
    placement_group: Optional[cluster.PlacementGroup] = None,
    placement_group_bundle_indexes: Optional[List[int]] = None,
) -> EtlSession:
    """Start a session — ``raydp.init_spark`` parity (reference
    context.py:154-231). With the multi-tenant plane on (``tenancy.enabled``
    conf, default ON) a second ``init_etl`` under a
    NEW app name ATTACHES to the running cluster as a named tenant at its
    requested quota (the reference's named-app-on-a-shared-Ray-cluster
    shape); the same name, or any session with tenancy off, keeps the
    init_spark singleton guard and raises."""
    global _active_session
    from raydp_tpu_torch.tenancy import registry as _treg

    with _lock:
        tenancy_on = str(
            (configs or {}).get("tenancy.enabled", "true")
        ).lower() in ("1", "true", "yes")
        live = _treg.sessions()
        if live:
            legacy = any(not s._tenancy_enabled for s in live)
            if not tenancy_on or legacy:
                raise RuntimeError(
                    "an ETL session is already running; call stop_etl() first "
                    "(parity: init_spark singleton guard, reference "
                    "context.py:129-147; concurrent tenants need "
                    "tenancy.enabled on every session)"
                )
            ns = _treg.tenant_namespace(app_name)
            if any(s.tenant_ns == ns for s in live):
                raise RuntimeError(
                    f"tenant {ns!r} is already running on this cluster; "
                    "stop it (or pick another app_name) first"
                )
        # operator overrides from raydp-tpu-submit win over application args
        # (spark-submit --conf precedence, reference bin/raydp-submit)
        overrides = submitted_overrides()
        num_executors = overrides.get("num_executors", num_executors)
        executor_cores = overrides.get("executor_cores", executor_cores)
        executor_memory = overrides.get("executor_memory", executor_memory)
        if overrides.get("configs"):
            configs = {**(configs or {}), **overrides["configs"]}
        try:
            session = EtlSession(
                app_name,
                num_executors,
                executor_cores,
                executor_memory,
                configs=configs,
                placement_group_strategy=placement_group_strategy,
                placement_group=placement_group,
                placement_group_bundle_indexes=placement_group_bundle_indexes,
                _co_tenants=len(live),
            )
        except BaseException as exc:
            # roll back the head's tenant registration when construction
            # failed AFTER it (spawn failure, readiness timeout): otherwise
            # the name stays ACTIVE with no session to stop and every retry
            # is rejected until the head restarts. The duplicate-rejection
            # path must NOT unregister — that record belongs to the LIVE
            # tenant (possibly another driver's) this init collided with.
            if tenancy_on and not (
                isinstance(exc, RuntimeError) and "already running" in str(exc)
            ):
                try:
                    # deliberate blocking under the lock:
                    # the session lock serializes init/stop BY DESIGN — the
                    # whole EtlSession construction above blocks under it —
                    # and this bounded rollback RPC runs only on the
                    # construction-failure path; releasing first would let a
                    # concurrent init of the same name race the unregister)
                    cluster.head_rpc(
                        "tenant_unregister",
                        name=_treg.tenant_namespace(app_name),
                    )
                except Exception:  # rollback is best-effort; the original construction error is what the caller needs
                    pass
            raise
        _treg.add_session(session)
        _active_session = session
        atexit.register(_atexit_stop)
        return session


def _atexit_stop() -> None:
    # every still-live tenant stops (multi-session: one atexit sweep)
    from raydp_tpu_torch.tenancy import registry as _treg

    for session in _treg.sessions():
        session.stop()


def stop_etl(cleanup_data: bool = True, del_obj_holder: bool = True) -> None:
    """Stop the CURRENT session: this thread's (``tenancy.use_session`` /
    the thread that created it), else the most recently created live one —
    the single-session behavior unchanged. Co-tenants keep running; stop
    them via their own ``session.stop()`` or this function on their
    thread."""
    session = active_session()
    if session is not None:
        session.stop(cleanup_data=cleanup_data, del_obj_holder=del_obj_holder)


def active_session() -> Optional[EtlSession]:
    """The running session bound to THIS thread (the thread that created it
    or a ``tenancy.use_session`` scope), falling back to the most recently
    created live session — which is exactly the old singleton contract when
    one session exists. None once stopped/absent."""
    from raydp_tpu_torch.tenancy import registry as _treg

    return _treg.current_session()


def adopt_frame(df) -> DataFrame:
    """The estimator's input as an ETL DataFrame: a DataFrame as it is, a
    pandas DataFrame distributed through the running session (the
    reference's ``_check_and_convert``; it lives here so the estimator
    imports neither pandas nor pyarrow)."""
    if isinstance(df, DataFrame):
        return df
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        pd = None
    if pd is not None and isinstance(df, pd.DataFrame):
        session = active_session()
        if session is None:
            raise RuntimeError(
                "fit_on_etl received a pandas DataFrame but no ETL "
                "session is running; call raydp_tpu_torch.init_etl first"
            )
        return session.from_pandas(df)
    raise TypeError(
        f"expected raydp_tpu_torch.etl.DataFrame or pandas.DataFrame, "
        f"got {type(df).__name__}"
    )
