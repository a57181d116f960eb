"""Driver-side query planner / stage scheduler.

Walks a logical plan (plan.py), fuses narrow chains, breaks stages at wide
nodes, and drives executor actors through map/reduce shuffle rounds — the role
Spark's DAGScheduler plays inside the reference (its hot
loop), rebuilt Arrow-native on this framework's actor runtime.

Also owns schema inference: the narrow/merge kernels are *executed on empty
tables* locally, so the inferred schema is by construction what the executors
will produce (no separate analyzer to drift out of sync).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from raydp_tpu_torch.cluster.common import ActorDiedError as _ActorDied
from raydp_tpu_torch.cluster.common import ClusterError as _ClusterError
from raydp_tpu_torch.etl import plan as lp
from raydp_tpu_torch.etl import tasks as T
from raydp_tpu_torch.store import object_store as store


@dataclass
class Materialized:
    """A fully materialized plan: partitions as object-store blocks."""

    schema: pa.Schema
    blocks: List[Optional[store.ObjectRef]]
    counts: List[int]  # rows per partition

    @property
    def num_rows(self) -> int:
        return sum(self.counts)


class Planner:
    """Executes logical plans over a pool of executors (or in-process when the
    pool is empty — local mode, used by unit tests and schema probes)."""

    def __init__(
        self,
        executors: Optional[Sequence[Any]] = None,
        default_parallelism: int = 4,
        owner: Optional[str] = None,
        executor_slots: int = 1,
    ):
        self.executors = list(executors or [])
        self.default_parallelism = max(1, default_parallelism)
        self.owner = owner  # ownership target for produced blocks
        # project-fusion rewrite (collapse adjacent Projects into one):
        # tests flip this off to verify fused == unfused byte-identically
        self.fuse_projects = True
        # indexed shuffle blocks: a map task writes ONE block holding all R
        # splits (+offset footer) instead of R blocks — M metadata RPCs and
        # M objects per shuffle instead of M×R. Tests flip this off to
        # verify indexed == legacy byte-identically.
        self.shuffle_indexed_blocks = True
        # per-executor parallel task slots (the session sets this to
        # executor_cores, matching the executor-side run_tasks thread pool);
        # sizes the reply-timeout budget of batched dispatches
        self.executor_slots = max(1, int(executor_slots))
        # millisecond control plane (all default on; session confs flip
        # them for A/B parity tests):
        #   planner.plan_cache — fingerprint logical plans and cache the
        #     lowered program so repeated query shapes skip planning/
        #     lowering; literals and ArrowSource block refs are parameter
        #     slots that rebind without recompilation
        #   planner.compiled_dispatch — ship the compiled program in a
        #     single run_plan dispatch per executor (executors cache the
        #     program by fingerprint, so warm dispatches carry only the
        #     binding) instead of per-stage spec shipping
        #   planner.head_bypass — push lease-stamped block locations with
        #     the dispatch so executors resolve sibling blocks peer-to-peer
        #     (store.lookup_many head RPCs become the miss path)
        self.plan_cache = True
        self.compiled_dispatch = True
        self.head_bypass = True
        # lineage-based recovery: every registered
        # block records a compact lineage entry; a read that surfaces a
        # lost-block error re-executes just the producing tasks on surviving
        # executors and REBINDS the regenerated blocks under the original
        # ids. Bounded: at most recovery_budget producing-task groups per
        # query and recovery_max_depth transitive input levels — a flapping
        # cluster fails fast instead of looping.
        self.lineage_recovery = True
        self.recovery_budget = 64
        self.recovery_max_depth = 3
        from raydp_tpu_torch.etl import lineage as _lineage

        self.lineage = _lineage.LineageRegistry()
        from raydp_tpu_torch.sanitize import named_lock as _recovery_named_lock

        # serializes whole recovery passes: two threads losing the same
        # block (estimator feed + driver query) must not both re-execute
        # its producing task — the loser's probe then finds the winner's
        # rebind and does zero work. Held across the recovery's RPCs BY
        # DESIGN (serializing recovery is the point; the lock is outermost
        # and its holders take no other path back into it).
        self._recovery_lock = _recovery_named_lock("planner.recovery")
        import collections

        from raydp_tpu_torch.sanitize import named_lock as _named_lock

        self._plan_cache: "collections.OrderedDict" = collections.OrderedDict()  # guarded-by: self._plan_cache_lock
        self._plan_cache_lock = _named_lock("planner.plan_cache")
        self._plans_shipped: set = set()  # (actor_id, program_id) delivered
        # observability: rolling stats of the most recent query (first-class
        # step timing; the reference defers everything to the
        # Ray/Spark dashboards). Stage logs are thread-local so concurrent
        # queries on one session don't interleave each other's stages.
        import threading

        self.last_query_stats: dict = {}
        self.last_query_records: list = []  # raw spans behind the stats
        self._tls = threading.local()
        # dynamic allocation: the session installs a hook called with each
        # stage's width BEFORE dispatch (scale-up happens in time for the
        # stage to use the new executors); _inflight gates scale-DOWN so an
        # idle-timeout never kills executors under a running stage
        self.scale_hook = None
        self._inflight = 0
        from raydp_tpu_torch.sanitize import named_lock

        self._inflight_lock = named_lock("planner.inflight")
        # multi-tenant plane (raydp_tpu_torch.tenancy):
        #   admission — the session's fair-share AdmissionHandle; every
        #     dispatch path acquires a ticket for its stage width before
        #     touching the pool (None = tenancy off, zero overhead)
        #   tenant — this session's tenant namespace; threads the block-id
        #     prefix (store.tenant_scope) around each query's writes
        #   shared_plan_cache — probe/publish the process-wide fingerprint-
        #     keyed program cache so identical queries from different
        #     tenants compile once (plan_cache.cross_tenant_hits)
        self.admission = None
        self.tenant = ""
        self.shared_plan_cache = False

    def __getstate__(self):
        # planners travel inside pickled sessions (Dataset._session → workers);
        # thread-local state is process-private and recreated on arrival
        state = dict(self.__dict__)
        state.pop("_tls", None)
        # process-private: the allocation hook closes over the live session
        # and the lock is unpicklable; a shipped planner runs without them
        state.pop("scale_hook", None)
        state.pop("_inflight_lock", None)
        state["_inflight"] = 0
        # the admission handle wraps the driver's process-local scheduler
        state.pop("admission", None)
        # the compiled-plan cache and its delivery bookkeeping are process-
        # private (programs pin wire blobs; shipped-state is per connection)
        state.pop("_plan_cache", None)
        state.pop("_plan_cache_lock", None)
        state.pop("_plans_shipped", None)
        # lineage entries hold live specs/closures — process-private
        state.pop("lineage", None)
        state.pop("_recovery_lock", None)
        return state

    def __setstate__(self, state):
        import threading

        self.__dict__.update(state)
        self._tls = threading.local()
        self.scale_hook = None
        from raydp_tpu_torch.sanitize import named_lock

        self._inflight_lock = named_lock("planner.inflight")
        self.__dict__.setdefault("fuse_projects", True)
        self.__dict__.setdefault("executor_slots", 1)
        self.__dict__.setdefault("shuffle_indexed_blocks", True)
        self.__dict__.setdefault("plan_cache", True)
        self.__dict__.setdefault("compiled_dispatch", True)
        self.__dict__.setdefault("head_bypass", True)
        self.__dict__.setdefault("lineage_recovery", True)
        self.__dict__.setdefault("recovery_budget", 64)
        self.__dict__.setdefault("recovery_max_depth", 3)
        self.admission = None
        self.__dict__.setdefault("tenant", "")
        self.__dict__.setdefault("shared_plan_cache", False)
        from raydp_tpu_torch.etl import lineage as _lineage

        self.lineage = _lineage.LineageRegistry()
        self._recovery_lock = named_lock("planner.recovery")
        import collections

        self._plan_cache = collections.OrderedDict()  # unpickle re-init: the object is not yet shared with any thread
        self._plan_cache_lock = named_lock("planner.plan_cache")
        self._plans_shipped = set()

    # ------------------------------------------------------------------
    # task submission
    # ------------------------------------------------------------------

    MAX_TASK_RETRIES = 2

    def _dispatch(
        self, spec: T.TaskSpec, i: int, attempt: int,
        preferred: Optional[int] = None,
    ):
        """Send a task, skipping permanently-dead executors (a DEAD actor
        raises ActorDiedError at call time; RESTARTING ones block instead).
        ``preferred`` (locality) is tried first on the initial attempt."""
        last_exc: Optional[BaseException] = None
        n = len(self.executors)
        # task-rotated fallback order either way: when the preferred
        # executor is dead, failover spreads across the pool instead of
        # herding every task onto executor 0
        order = [(i + attempt + offset) % n for offset in range(n)]
        if preferred is not None and attempt == 0:
            first = preferred % n
            order.remove(first)
            order.insert(0, first)
        for idx in order:
            try:
                future = self.executors[idx].run_task.remote(spec)
            except _ActorDied as exc:
                last_exc = exc
                continue
            from raydp_tpu_torch import obs

            obs.metrics.counter("etl.actor_dispatches").inc()
            return future
        raise last_exc  # every executor is dead

    def _executor_nodes(self) -> List[Optional[str]]:
        """node_id per executor (cached; actors keep their node across
        restarts unless rescheduled, and a stale entry only costs locality)."""
        cache = getattr(self, "_executor_node_cache", None)
        if cache is None or len(cache) != len(self.executors):
            cache = []
            for handle in self.executors:
                try:
                    record = handle._record()
                    cache.append(record.node_id if record else None)
                except Exception:
                    cache.append(None)
            self._executor_node_cache = cache
        return cache

    def _preferred_executors(
        self, specs: List[T.TaskSpec]
    ) -> List[Optional[int]]:
        """Locality: prefer the executor on the node holding the most bytes
        of each task's input blocks (parity: getPreferredLocations from Ray
        owner addresses, reference RayDatasetRDD.scala:53-55)."""
        if len(self.executors) < 2:
            return [None] * len(specs)
        block_ids = list(
            {
                b.object_id
                for spec in specs
                for read in spec.reads
                for b in read.blocks
                if b is not None
            }
        )
        if not block_ids:
            return [None] * len(specs)
        from raydp_tpu_torch.cluster import api as cluster_api

        try:
            locations = cluster_api.head_rpc(
                "object_locations", object_ids=block_ids
            )
        except Exception:
            return [None] * len(specs)
        nodes = self._executor_nodes()
        prefs: List[Optional[int]] = []
        for i, spec in enumerate(specs):
            weight: dict = {}
            for read in spec.reads:
                for b in read.blocks:
                    if b is None:
                        continue
                    node = locations.get(b.object_id)
                    if node is not None:
                        weight[node] = weight.get(node, 0) + max(1, b.size)
            best = max(weight, key=weight.get) if weight else None
            candidates = [j for j, n in enumerate(nodes) if n == best]
            prefs.append(candidates[i % len(candidates)] if candidates else None)
        return prefs

    def _node_hosts(self) -> dict:
        """node_id → host map from the head's node table (cached for the
        planner's lifetime; hosts never change for a live node)."""
        cache = getattr(self, "_node_host_cache", None)
        if cache is None:
            from raydp_tpu_torch.cluster import api as cluster_api

            try:
                cache = {
                    n.node_id: getattr(n, "host", "") or n.shm_ns
                    for n in cluster_api.head_rpc("nodes")
                }
            except Exception:
                cache = {}
            self._node_host_cache = cache
        return cache

    def _executor_hosts(self) -> List[Optional[str]]:
        """host per executor (the host axis of ``_executor_nodes``)."""
        node_hosts = self._node_hosts()
        return [
            node_hosts.get(node) if node is not None else None
            for node in self._executor_nodes()
        ]

    def _reduce_prefs(
        self, specs: List[T.TaskSpec]
    ) -> Optional[List[Optional[int]]]:
        """Host-axis locality for reduce/exchange placement: score each
        reducer with ``obs/costmodel.exchange_placement`` over the head's
        block→host map and prefer an executor on the host holding the most
        input bytes. Counts ``planner.locality_hits`` (a reducer landed
        where its bytes live) vs ``planner.locality_misses`` (the best host
        had no executor). Scoring only engages on a genuinely multi-host
        pool — on one host every placement is equally local and the
        counters would be noise."""
        if len(self.executors) < 2:
            return None
        hosts = self._executor_hosts()
        live_hosts = {h for h in hosts if h is not None}
        if len(live_hosts) < 2:
            return None
        block_ids = list(
            {
                b.object_id
                for spec in specs
                for read in spec.reads
                for b in read.blocks
                if b is not None
            }
            | {
                ref.object_id
                for spec in specs
                for read in spec.reads
                for ref, _, _ in read.slices
            }
        )
        if not block_ids:
            return None
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.cluster import api as cluster_api
        from raydp_tpu_torch.obs import costmodel

        try:
            object_hosts = cluster_api.head_rpc(
                "object_hosts", object_ids=block_ids
            )
        except Exception:
            return None
        prefs: List[Optional[int]] = []
        hits = misses = 0
        for r, spec in enumerate(specs):
            bytes_by_host: dict = {}
            for read in spec.reads:
                for b in read.blocks:
                    if b is None:
                        continue
                    row = object_hosts.get(b.object_id)
                    if row is None:
                        continue
                    host, size = row
                    bytes_by_host[host] = (
                        bytes_by_host.get(host, 0) + max(1, size)
                    )
                # indexed-shuffle inputs: the reducer reads a WINDOW of the
                # map's single-block output — weigh the slice, not the block
                for ref, _off, length in read.slices:
                    row = object_hosts.get(ref.object_id)
                    if row is None:
                        continue
                    host, _size = row
                    bytes_by_host[host] = (
                        bytes_by_host.get(host, 0) + max(1, length)
                    )
            best, _scores = costmodel.exchange_placement(bytes_by_host)
            if best is None:
                prefs.append(None)
                continue
            candidates = [j for j, h in enumerate(hosts) if h == best]
            if candidates:
                hits += 1
                prefs.append(candidates[r % len(candidates)])
            else:
                misses += 1
                prefs.append(None)
        if hits:
            obs.metrics.counter("planner.locality_hits").inc(hits)
        if misses:
            obs.metrics.counter("planner.locality_misses").inc(misses)
        return prefs

    def submit(
        self,
        specs: List[T.TaskSpec],
        on_result: Optional[Callable[[int, T.TaskResult], None]] = None,
    ) -> List[T.TaskResult]:
        """Run tasks across the pool; a task whose executor died mid-flight is
        retried on another executor (Spark task-retry parity — executor actors
        restart, so transient deaths must not fail the query). Only connection
        breakage retries: timeouts and remote application errors propagate
        (a slow task re-executed elsewhere would duplicate side effects).

        ``on_result`` streams each task's (final, post-retry) result OUT OF
        the gather loop as it lands — the map-completion notification feed
        the barrier-free reduce start is built on.

        The whole stage runs inside an ``obs.span("etl.stage")`` — the SAME
        record that lands on the trace timeline is what ``last_query_stats``
        aggregates (via ``_instrumented``'s collector), and its context
        propagates through the dispatch RPCs so executor-side task spans
        link under it."""
        from raydp_tpu_torch import obs

        prefs: List[Optional[int]] = []
        # fair-share admission (tenancy/scheduler.py): a ticket for this
        # stage's width, BEFORE any executor sees a task — the weighted-DRR
        # queue is what keeps one tenant's wide shuffle from starving a
        # co-tenant's interactive stages. Re-entrant per thread (nested
        # stages ride the outer ticket); None when tenancy is off.
        admission = getattr(self, "admission", None)
        ticket = admission.acquire(len(specs)) if admission is not None else None
        hook = self.scale_hook
        if hook is not None:
            with self._inflight_lock:
                self._inflight += 1
            try:
                hook(len(specs))
            except Exception:
                # allocation policy failures must never fail the query —
                # but a broken policy should show up somewhere
                obs.metrics.counter("etl.scale_hook_failures").inc()
        batched = False
        stage_span = obs.span("etl.stage", tasks=len(specs))
        stage_span.__enter__()
        try:
            if not self.executors:
                results = []
                for i, s in enumerate(specs):
                    try:
                        result = T.run_task(s)
                    except _ClusterError as exc:
                        # local-mode lost-block read: recover via lineage
                        # (one retry — the rebound metadata serves the rest)
                        if not self._try_block_recovery(exc, specs=(s,)):
                            raise
                        result = T.run_task(s)
                    results.append(result)
                    if on_result is not None:
                        on_result(i, result)
                self._record_lineage(specs, results)
                return results
            prefs = self._preferred_executors(specs)
            # one-dispatch batch path: a stage wider than the pool's task
            # slots ships each executor its whole task list in ONE
            # run_tasks RPC instead of one round trip per task
            if len(specs) > len(self.executors):
                batched = True
                results = self._submit_batched(specs, prefs, on_result)
            else:
                futures = [
                    (self._dispatch(spec, i, 0, prefs[i]), spec, i)
                    for i, spec in enumerate(specs)
                ]
                results = self._gather(futures, specs, on_result)
            self._record_lineage(specs, results)
            return results
        finally:
            if admission is not None:
                admission.release(ticket)
            if hook is not None:
                with self._inflight_lock:
                    self._inflight -= 1
            stage_span.set(
                locality_preferred=sum(1 for p in prefs if p is not None),
                dispatch="batched" if batched else "per_task",
            )
            obs.metrics.counter("etl.stages").inc()
            obs.metrics.counter("etl.tasks_dispatched").inc(len(specs))
            if batched:
                obs.metrics.counter("etl.dispatch_batches").inc()
            try:
                # executor-side wall time per task: lets query stats
                # split compute from dispatch/transport overhead
                stage_span.set(
                    server_seconds=round(
                        sum(r.server_seconds for r in results), 6
                    ),
                    read_s=round(sum(r.read_seconds for r in results), 6),
                    compute_s=round(
                        sum(r.compute_seconds for r in results), 6
                    ),
                    emit_s=round(sum(r.emit_seconds for r in results), 6),
                )
            except (NameError, AttributeError):  # dispatch raised before results existed
                pass  # dispatch raised before results existed
            stage_span.__exit__(None, None, None)

    def _submit_batched(
        self,
        specs: List[T.TaskSpec],
        prefs: List[Optional[int]],
        on_result: Optional[Callable[[int, T.TaskResult], None]] = None,
    ) -> List[T.TaskResult]:
        """Group tasks by executor (locality-preferred, round-robin filled)
        and dispatch each group as ONE run_tasks call — per-task actor round
        trips collapse to one per executor. A group whose executor dies
        mid-flight falls back to the per-task retry ladder."""
        n = len(self.executors)
        groups: List[List[int]] = [[] for _ in range(n)]
        # preferences are honored STRICTLY — the per-task path dispatches to
        # the preferred executor first too, and locality tests pin outputs
        # to the data's node; unpreferred tasks balance onto the emptiest
        # groups
        for i in range(len(specs)):
            p = prefs[i]
            if p is not None:
                groups[p % n].append(i)
        for i in range(len(specs)):
            if prefs[i] is None:
                groups[min(range(n), key=lambda g: len(groups[g]))].append(i)
        futures = []
        fallback: List[int] = []
        for idx, group in enumerate(groups):
            if not group:
                continue
            # the per-task path gives every task its own 300s reply budget;
            # a batch's single reply must get the equivalent wall budget —
            # tasks run executor_slots wide inside run_tasks
            waves = -(-len(group) // max(1, self.executor_slots))
            try:
                futures.append(
                    (
                        self.executors[idx].run_tasks.options(
                            timeout=300.0 * waves
                        ).remote([specs[i] for i in group]),
                        group,
                    )
                )
                from raydp_tpu_torch import obs

                obs.metrics.counter("etl.actor_dispatches").inc()
            except _ActorDied:
                fallback.extend(group)
        results: List[Optional[T.TaskResult]] = [None] * len(specs)
        for future, group in futures:
            try:
                batch = future.result()
                for i, r in zip(group, batch):
                    results[i] = r
                    if on_result is not None:
                        on_result(i, r)
            except (ConnectionError, EOFError, _ActorDied):
                from raydp_tpu_torch import obs

                obs.instant(
                    "etl.batch_retry", tasks=len(group), attempt=1
                )
                obs.metrics.counter("etl.task_retries").inc(len(group))
                fallback.extend(group)
            except _ClusterError as exc:
                # a lost-block read inside the batch fails the whole reply:
                # lineage-recover the named blocks, refresh every group
                # member's pushed metas, and fall back to the per-task
                # ladder (anything else propagates unchanged)
                if not self._try_block_recovery(
                    exc, specs=[specs[i] for i in group]
                ):
                    raise
                from raydp_tpu_torch import obs

                obs.instant(
                    "etl.batch_retry", tasks=len(group), attempt=1,
                    recovered=True,
                )
                obs.metrics.counter("etl.task_retries").inc(len(group))
                fallback.extend(group)
        if fallback:
            # per-task retry ladder over a DENSE spec list (_gather indexes
            # positionally), then scatter back to stage positions
            dense_specs = [specs[i] for i in fallback]
            retry_futures = [
                (self._dispatch(dense_specs[j], fallback[j], 1), dense_specs[j], j)
                for j in range(len(fallback))
            ]
            dense_cb = None
            if on_result is not None:
                on_result_fn = on_result

                def dense_cb(j, r):
                    on_result_fn(fallback[j], r)

            retried = self._gather(retry_futures, dense_specs, dense_cb)
            for j, i in enumerate(fallback):
                results[i] = retried[j]
        return results  # type: ignore[return-value]

    def _gather(
        self,
        futures,
        specs: List[T.TaskSpec],
        on_result: Optional[Callable[[int, T.TaskResult], None]] = None,
    ) -> List[T.TaskResult]:
        from raydp_tpu_torch import obs

        results: List[Optional[T.TaskResult]] = [None] * len(specs)
        for attempt in range(self.MAX_TASK_RETRIES + 1):
            retry: List[Tuple[Any, T.TaskSpec, int]] = []
            for future, spec, i in futures:
                try:
                    results[i] = future.result()
                except (ConnectionError, EOFError, _ActorDied):
                    if attempt == self.MAX_TASK_RETRIES:
                        raise
                    obs.instant(
                        "etl.task_retry", task=i, attempt=attempt + 1
                    )
                    obs.metrics.counter("etl.task_retries").inc()
                    retry.append((self._dispatch(spec, i, attempt + 1), spec, i))
                    continue
                except _ClusterError as exc:
                    # application-level lost-block error (OwnerDiedError /
                    # not-found out of the task's reads): re-execute the
                    # producing tasks via lineage, then retry THIS task
                    # against the rebound blocks. Any other application
                    # error propagates exactly as before.
                    if attempt == self.MAX_TASK_RETRIES or not (
                        self._try_block_recovery(exc, specs=(spec,))
                    ):
                        raise
                    obs.instant(
                        "etl.task_retry", task=i, attempt=attempt + 1,
                        recovered=True,
                    )
                    obs.metrics.counter("etl.task_retries").inc()
                    retry.append((self._dispatch(spec, i, attempt + 1), spec, i))
                    continue
                if on_result is not None:
                    on_result(i, results[i])
            if not retry:
                break
            futures = retry
        return results  # type: ignore[return-value]

    def gather_predispatched(
        self,
        futures: List[Optional[Any]],
        specs: List[T.TaskSpec],
    ) -> List[T.TaskResult]:
        """Stage bookkeeping for tasks whose DISPATCH already happened inside
        the previous stage's gather loop (barrier-free reduce start): same
        span, metrics, and retry ladder as ``submit()``; a ``None`` future
        (its eager dispatch failed) is re-dispatched here through the normal
        failover ladder."""
        from raydp_tpu_torch import obs

        # admission note: the eager dispatches happened INSIDE the map
        # stage's gather loop, under the map stage's ticket (the launcher
        # runs on that thread) — this ticket accounts the reduce round's
        # occupancy from here on, and is a no-op on that same thread
        admission = getattr(self, "admission", None)
        ticket = admission.acquire(len(specs)) if admission is not None else None
        hook = self.scale_hook
        if hook is not None:
            with self._inflight_lock:
                self._inflight += 1
            try:
                hook(len(specs))
            except Exception:
                obs.metrics.counter("etl.scale_hook_failures").inc()
        stage_span = obs.span("etl.stage", tasks=len(specs))
        stage_span.__enter__()
        try:
            triples = []
            for i, (future, spec) in enumerate(zip(futures, specs)):
                if future is None:
                    future = self._dispatch(spec, i, 0)
                triples.append((future, spec, i))
            results = self._gather(triples, specs)
            self._record_lineage(specs, results)
            return results
        finally:
            if admission is not None:
                admission.release(ticket)
            if hook is not None:
                with self._inflight_lock:
                    self._inflight -= 1
            stage_span.set(dispatch="pipelined")
            obs.metrics.counter("etl.stages").inc()
            obs.metrics.counter("etl.tasks_dispatched").inc(len(specs))
            try:
                stage_span.set(
                    server_seconds=round(
                        sum(r.server_seconds for r in results), 6
                    ),
                    read_s=round(sum(r.read_seconds for r in results), 6),
                    compute_s=round(
                        sum(r.compute_seconds for r in results), 6
                    ),
                    emit_s=round(sum(r.emit_seconds for r in results), 6),
                )
            except (NameError, AttributeError):  # dispatch raised before results existed
                pass  # dispatch raised before results existed
            stage_span.__exit__(None, None, None)

    # ------------------------------------------------------------------
    # lineage recording + recovery
    # ------------------------------------------------------------------

    def _record_lineage(self, specs, results) -> None:
        """Record each dispatched spec's produced blocks (one dict insert
        per block — the ~free happy-path half of lineage recovery)."""
        if not self.lineage_recovery:
            return
        reg = getattr(self, "lineage", None)
        if reg is None:
            return
        for spec, res in zip(specs, results):
            if res is not None:
                reg.record_spec(spec, res)

    def _charge_recovery(self, n: int) -> None:
        """Debit ``n`` producing-task re-executions against the per-query
        budget; a flapping cluster fails fast instead of looping."""
        from raydp_tpu_torch.etl.lineage import RecoveryError

        spent = getattr(self._tls, "recovery_spent", 0) + n
        if spent > self.recovery_budget:
            raise RecoveryError(
                f"per-query re-execution budget exhausted ({spent} > "
                f"{self.recovery_budget} producing tasks) — refusing to "
                "chase a flapping cluster"
            )
        self._tls.recovery_spent = spent

    def _submit_recovery(self, spec: T.TaskSpec):
        """Re-run ONE producing task. Rides submit() so the re-execution
        gets the normal dispatch/failover surface and its fresh blocks are
        lineage-recorded like any other task's."""
        return self.submit([spec])[0]

    def recover_blocks(self, refs) -> int:
        """Public recovery entry (Dataset reads, estimator feeds): lineage-
        re-execute the producing tasks of the given refs/ids and rebind the
        regenerated blocks under the original ids. Out-of-query calls get a
        fresh re-execution budget."""
        from raydp_tpu_torch.etl import lineage as L

        ids = [getattr(r, "object_id", r) for r in refs]
        if not getattr(self._tls, "query_active", False):
            self._tls.recovery_spent = 0
        self._tls.in_recovery = True
        try:
            with self._recovery_lock:
                return L.recover_blocks(self, ids)
        finally:
            self._tls.in_recovery = False

    def _try_block_recovery(self, exc: BaseException, specs=()) -> bool:
        """Classify-and-recover for a task/dispatch failure: True when
        ``exc`` named lost blocks and lineage restored them (the caller
        re-dispatches after the pushed metas are refreshed); False when the
        error is not a lost-block error, recovery is disabled/re-entered,
        or recovery itself failed (the caller re-raises the original)."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.etl import lineage as L

        if not self.lineage_recovery or getattr(self, "lineage", None) is None:
            return False
        if getattr(self._tls, "in_recovery", False):
            return False
        if not L.is_lost_block_error(exc):
            return False
        ids = L.missing_ids(exc)
        if not ids:
            return False
        if not getattr(self._tls, "query_active", False):
            # outside the query wrapper (direct submit() callers) each
            # incident gets a fresh budget — the per-QUERY budget must not
            # accumulate across unrelated operations until it permanently
            # disables recovery on this thread
            self._tls.recovery_spent = 0
        # widen to EVERY input the failing spec(s) read: a read fails one
        # stale block at a time, and recovering one-per-retry-attempt would
        # exhaust the task ladder on wide losses — recover_blocks probes
        # the whole set and re-executes only what is actually lost
        for spec in specs:
            ids.extend(L.spec_input_ids(spec))
        ids = list(dict.fromkeys(ids))
        self._tls.in_recovery = True
        try:
            with self._recovery_lock:
                L.recover_blocks(self, ids)
        except _ClusterError:
            obs.instant("lineage.recovery_failed", blocks=len(ids))
            # an UNRECOVERED query is exactly what the flight recorder
            # exists for: ask the head for a crash dossier naming the lost
            # blocks while the victims' final rings are still resident.
            # Best-effort and bounded — evidence, never a new failure mode.
            try:
                from raydp_tpu_torch.cluster import api as _capi

                _capi.head_rpc(
                    "obs_dossier", reason="unrecovered_query",
                    victim={"lost_blocks": ids[:16],
                            "error": repr(exc)[:300]},
                    timeout=10.0,
                )
            except Exception:  # dossier assembly is best-effort; the original lost-block error is what the caller must see
                pass
            return False
        finally:
            self._tls.in_recovery = False
        for spec in specs:
            L.refresh_spec_metas(spec, ids)
        return True

    # ------------------------------------------------------------------
    # schema inference (run the pipeline on empty tables, locally)
    # ------------------------------------------------------------------

    def infer_schema(self, node: lp.PlanNode) -> pa.Schema:
        return self._empty_result(node).schema

    def _empty_result(self, node: lp.PlanNode) -> pa.Table:
        cached = getattr(node, "_cached_empty", None)
        if cached is not None:
            return cached
        result = self._empty_result_uncached(node)
        try:
            node._cached_empty = result  # type: ignore[attr-defined]
        except AttributeError:  # slotted plan nodes cannot cache; recompute is correct
            pass
        return result

    def _empty_result_uncached(self, node: lp.PlanNode) -> pa.Table:
        if isinstance(node, lp.GlobalLimit):
            return self._empty_result(node.child)
        if isinstance(node, lp.ArrowSource):
            return node.schema.empty_table()
        if isinstance(node, lp.RangeSource):
            return pa.schema([("id", pa.int64())]).empty_table()
        if isinstance(node, lp.ParquetSource):
            import pyarrow.parquet as pq

            schema = pq.read_schema(node.file_groups[0][0])
            if node.columns:
                schema = pa.schema([schema.field(c) for c in node.columns])
            return schema.empty_table()
        if isinstance(node, lp.CsvSource):
            # read only the first batch of the first file for column types
            from pyarrow import csv as pacsv

            opts = node.read_options
            with pacsv.open_csv(
                node.file_groups[0][0],
                read_options=pacsv.ReadOptions(
                    column_names=opts.get("column_names"),
                    autogenerate_column_names=opts.get(
                        "autogenerate_column_names", False
                    ),
                ),
                parse_options=pacsv.ParseOptions(delimiter=opts.get("delimiter", ",")),
                convert_options=pacsv.ConvertOptions(
                    column_types=opts.get("column_types")
                ),
            ) as reader:
                return reader.schema.empty_table()
        if isinstance(node, (lp.Filter, lp.Sample, lp.PartitionHead, lp.Repartition)):
            return self._empty_result(node.children()[0])
        if isinstance(node, lp.Project):
            child = self._empty_result(node.child)
            return T.apply_narrow(child, node, 0)
        if isinstance(node, lp.MapBatches):
            child = self._empty_result(node.child)
            return T.apply_narrow(child, node, 0)
        if isinstance(node, lp.Union):
            return self._empty_result(node.inputs[0])
        if isinstance(node, lp.GroupByAgg):
            child = self._empty_result(node.child)
            return T.final_agg(
                T.partial_agg(child, node.keys, node.aggs), node.keys, node.aggs
            )
        if isinstance(node, lp.Join):
            left = self._empty_result(node.left)
            right = self._empty_result(node.right)
            return left.join(right, keys=node.on, join_type=node.how, use_threads=T.arrow_threads())
        if isinstance(node, (lp.Sort, lp.Distinct)):
            return self._empty_result(node.children()[0])
        if isinstance(node, lp.Window):
            return T.window_compute(
                self._empty_result(node.child), node.partition_by,
                node.order_by, node.ascending, node.exprs,
            )
        raise TypeError(f"cannot infer schema for {type(node).__name__}")

    def partition_count(self, node: lp.PlanNode) -> int:
        """Structural output-partition count — no execution. For GlobalLimit
        this is an upper bound (the trim can drop whole blocks)."""
        if isinstance(node, lp.GlobalLimit):
            return min(self.partition_count(node.child), max(1, node.n))
        if isinstance(node, lp.ArrowSource):
            return len(node.blocks)
        if isinstance(node, lp.RangeSource):
            return node.num_partitions
        if isinstance(node, (lp.ParquetSource, lp.CsvSource)):
            return len(node.file_groups)
        if isinstance(node, lp.Union):
            return sum(self.partition_count(c) for c in node.inputs)
        if isinstance(node, lp.GroupByAgg):
            return 1 if not node.keys else self._num_partitions(node.num_partitions)
        if isinstance(node, (lp.Join, lp.Sort, lp.Distinct)):
            return self._num_partitions(node.num_partitions)
        if isinstance(node, lp.Window):
            if not node.partition_by:
                return 1
            return self._num_partitions(node.num_partitions)
        if isinstance(node, lp.Repartition):
            return self._num_partitions(node.num_partitions)
        children = node.children()
        if children:
            return self.partition_count(children[0])
        raise TypeError(f"cannot count partitions of {type(node).__name__}")

    # ------------------------------------------------------------------
    # materialization
    # ------------------------------------------------------------------

    def _split_narrow(self, node: lp.PlanNode) -> Tuple[lp.PlanNode, List[lp.PlanNode]]:
        """Peel the chain of narrow ops off the top of the plan (returned
        bottom-up, ready to apply in order)."""
        chain: List[lp.PlanNode] = []
        current = node
        while isinstance(
            current, (lp.Project, lp.Filter, lp.MapBatches, lp.Sample, lp.PartitionHead)
        ):
            chain.append(current)
            current = current.children()[0]
        chain.reverse()
        return current, chain

    def _strip_children(self, chain: List[lp.PlanNode]) -> List[lp.PlanNode]:
        """Detach narrow nodes from their subtrees before shipping (executors
        only need the op parameters, not the whole plan)."""
        out: List[lp.PlanNode] = []
        for n in chain:
            if isinstance(n, lp.Project):
                out.append(lp.Project(None, n.columns))  # type: ignore[arg-type]
            elif isinstance(n, lp.Filter):
                out.append(lp.Filter(None, n.predicate))  # type: ignore[arg-type]
            elif isinstance(n, lp.MapBatches):
                out.append(lp.MapBatches(None, n.fn))  # type: ignore[arg-type]
            elif isinstance(n, lp.Sample):
                out.append(lp.Sample(None, n.fraction, n.seed))  # type: ignore[arg-type]
            elif isinstance(n, lp.PartitionHead):
                out.append(lp.PartitionHead(None, n.n))  # type: ignore[arg-type]
            else:
                raise TypeError(type(n).__name__)
        return out

    def _fuse_chain(self, chain: List[lp.PlanNode]) -> List[lp.PlanNode]:
        """The fusion rewrite: collapse ADJACENT Project nodes into one by
        substituting the inner projection's (name → expr) map into the outer
        expressions (shared subexpressions evaluate once via SharedExpr).
        A chain of withColumn/select steps then executes as a single
        projection per partition instead of materializing each step's full
        intermediate table. Purely a rewrite — unknown expression types
        leave the chain unfused."""
        if not getattr(self, "fuse_projects", True) or len(chain) < 2:
            return chain
        from raydp_tpu_torch.etl.expressions import CannotSubstitute, merge_projects

        fused: List[lp.PlanNode] = []
        for node in chain:
            if (
                fused
                and isinstance(node, lp.Project)
                and isinstance(fused[-1], lp.Project)
            ):
                try:
                    fused[-1] = lp.Project(
                        None,  # type: ignore[arg-type]
                        merge_projects(fused[-1].columns, node.columns),
                    )
                    continue
                except CannotSubstitute:  # user-defined Expr subclass: keep the step separate
                    pass  # user-defined Expr subclass: keep the step separate
            fused.append(node)
        return fused

    def _prepare_chain_quiet(
        self, chain: List[lp.PlanNode]
    ) -> Tuple[List[lp.PlanNode], Optional[dict]]:
        """Strip + fuse without emitting: returns (fused chain, fusion info
        or None). The compiled-plan path records the info ON the program and
        re-emits it per execution, so cache hits report the same fusion
        decisions a fresh compile does."""
        shipped = self._strip_children(chain)
        fused = self._fuse_chain(shipped)
        info = None
        if len(fused) != len(shipped):
            info = {"narrow_ops": len(shipped), "fused_ops": len(fused)}
        return fused, info

    def _prepare_chain(self, chain: List[lp.PlanNode]) -> List[lp.PlanNode]:
        """Strip + fuse the narrow chain for shipping; each fusion decision
        becomes an ``etl.fusion`` instant — visible on the trace timeline
        AND collected into last_query_stats by ``_instrumented``."""
        from raydp_tpu_torch import obs

        fused, info = self._prepare_chain_quiet(chain)
        if info is not None:
            obs.instant("etl.fusion", **info)
        return fused

    # ------------------------------------------------------------------
    # plan inspection (DataFrame.explain)
    # ------------------------------------------------------------------

    @staticmethod
    def _describe_op(node: lp.PlanNode) -> str:
        if isinstance(node, lp.Project):
            return f"Project[{', '.join(name for name, _ in node.columns)}]"
        if isinstance(node, lp.Filter):
            return f"Filter[{node.predicate.name_hint()}]"
        if isinstance(node, lp.PartitionHead):
            return f"PartitionHead[{node.n}]"
        if isinstance(node, lp.Sample):
            return f"Sample[{node.fraction}]"
        return type(node).__name__

    def explain_info(self, node: lp.PlanNode) -> dict:
        """Structural view of the physical execution: the narrow chain as
        written, the chain after fusion, the stage's base (source or wide
        op), and recursively the wide children. One dict per stage-producing
        subplan — what the fusion test asserts against."""
        base, chain = self._split_narrow(node)
        stripped = self._strip_children(chain)
        fused = self._fuse_chain(stripped)
        try:
            parts = self.partition_count(node)
        except TypeError:
            parts = None
        if isinstance(base, lp.Union):
            children = list(base.inputs)
        else:
            children = base.children()
        return {
            "base": type(base).__name__,
            "narrow_ops": [type(n).__name__ for n in stripped],
            "fused_ops": [self._describe_op(n) for n in fused],
            "output_partitions": parts,
            "children": [self.explain_info(c) for c in children],
        }

    def format_explain(self, node: lp.PlanNode) -> str:
        info = self.explain_info(node)
        lines: List[str] = []

        def _fmt(entry: dict, depth: int) -> None:
            pad = "  " * depth
            parts = entry["output_partitions"]
            head = f"{pad}* {entry['base']}"
            if parts is not None:
                head += f" → {parts} partition(s)"
            lines.append(head)
            if entry["narrow_ops"]:
                fused_note = ""
                if len(entry["fused_ops"]) != len(entry["narrow_ops"]):
                    fused_note = (
                        f"  (fused {len(entry['narrow_ops'])} narrow ops"
                        f" → {len(entry['fused_ops'])})"
                    )
                lines.append(
                    f"{pad}  chain: {' → '.join(entry['fused_ops'])}{fused_note}"
                )
            for child in entry["children"]:
                _fmt(child, depth + 1)

        _fmt(info, 0)
        return "\n".join(lines)

    def materialize(self, node: lp.PlanNode, storage: str = "auto") -> Materialized:
        """Execute to object-store blocks (one per partition). ``storage``
        selects the block tier ("disk" = persist to each executor node's
        spill dir — DISK_ONLY storage-level semantics, no driver round-trip)."""
        results = self._instrumented(
            lambda: self._execute_top(
                node, T.OutputSpec("block", owner=self.owner, storage=storage)
            )
        )
        schema = self.infer_schema(node)
        blocks = [r.blocks[0] if r.blocks else None for r in results]
        counts = [r.num_rows[0] if r.num_rows else 0 for r in results]
        return Materialized(schema, blocks, counts)

    def execute_action(self, node: lp.PlanNode, output: T.OutputSpec) -> List[T.TaskResult]:
        """Run the plan with a custom terminal output (count/inline/parquet)."""
        return self._instrumented(lambda: self._execute_top(node, output))

    def _execute_top(
        self, node: lp.PlanNode, output: T.OutputSpec
    ) -> List[T.TaskResult]:
        """Top-of-query entry: try the compiled-plan path (plan cache +
        whole-plan dispatch) first; anything it cannot express falls back to
        the recursive stage driver unchanged."""
        results = self._try_compiled(node, output)
        if results is not None:
            return results
        return self._execute(node, output)

    # span attrs copied into each last_query_stats stage entry, in schema
    # order (the schema test pins these keys)
    _STAGE_ATTRS = (
        "locality_preferred", "dispatch", "server_seconds",
        "read_s", "compute_s", "emit_s",
    )

    def _instrumented(self, run):
        """Run a query action under an ``etl.query`` span with a collector
        installed; ``last_query_stats`` is DERIVED from the collected span
        records (stage spans, fusion/retry instants) — the trace timeline
        and the stats API can never disagree because they are one record."""
        from raydp_tpu_torch import obs

        if getattr(self._tls, "query_active", False):
            return run()  # nested (e.g. sort materializing its child):
            # stages contribute to the enclosing query's stats
        self._tls.query_active = True
        self._tls.recovery_spent = 0  # fresh per-query re-execution budget
        # per-query control-plane accounting: process-wide counter deltas
        # around the query (concurrent queries on one process interleave
        # their deltas — documented; the counters themselves stay exact)
        _PC = ("hits", "misses", "unsupported")
        _RC = ("reexecuted_tasks", "recovered_blocks")
        # recovery attribution: a tenant-scoped planner deltas ITS tenant's
        # lineage counters, not the process-global ones — concurrent queries
        # from different tenants share this process, and tenant A's recovery
        # must never appear in tenant B's stats
        tenant = getattr(self, "tenant", "") or ""
        _rc_name = (
            (lambda k: f"tenant.{tenant}.lineage_{k}") if tenant
            else (lambda k: f"lineage.{k}")
        )
        before = {
            "head_rpcs": obs.metrics.counter("rpc.client.calls").value,
            "dispatches": obs.metrics.counter("etl.actor_dispatches").value,
            "bypass": obs.metrics.counter("rpc.head_bypass_hits").value,
            **{k: obs.metrics.counter(f"plan_cache.{k}").value for k in _PC},
            **{k: obs.metrics.counter(_rc_name(k)).value for k in _RC},
        }
        try:
            # tenant block namespace: every block
            # this query writes driver-side mints a tenant-prefixed id, so
            # head accounting/quota and the per-tenant GC keying hold for
            # local-mode and driver-materialized stages too (executor-side
            # writes carry the prefix via the executor's process default)
            with store.tenant_scope(getattr(self, "tenant", "") or ""):
                with obs.collect() as records, obs.span(
                    "etl.query"
                ) as query_span:
                    results = run()
        finally:
            self._tls.query_active = False
        plan_cache = {
            k: int(obs.metrics.counter(f"plan_cache.{k}").value - before[k])
            for k in _PC
        }
        plan_cache["hit"] = (
            plan_cache["hits"] > 0 and plan_cache["misses"] == 0
        )
        recovery = {
            # lineage activity this query paid for: re-executed producing
            # tasks and blocks rebound under their original ids (both 0 on
            # the happy path — the perf gate holds lineage ~free)
            k: int(obs.metrics.counter(_rc_name(k)).value - before[k])
            for k in _RC
        }
        rpc_stats = {
            # control-plane round trips this query cost: head/agent RPCs
            # (rpc.client.calls delta) and executor dispatches — the two
            # numbers the millisecond control plane exists to drive to ~0/~1
            "head_rpcs": int(
                obs.metrics.counter("rpc.client.calls").value
                - before["head_rpcs"]
            ),
            "actor_dispatches": int(
                obs.metrics.counter("etl.actor_dispatches").value
                - before["dispatches"]
            ),
            "head_bypass_hits": int(
                obs.metrics.counter("rpc.head_bypass_hits").value
                - before["bypass"]
            ),
        }
        stages = []
        fusion = []
        shuffle = []
        for record in records:
            if record["name"] == "etl.stage":
                args = record["args"]
                entry = {
                    "tasks": args.get("tasks", 0),
                    "seconds": record["dur"] / 1e6,
                }
                for key in self._STAGE_ATTRS:
                    if key in args:
                        entry[key] = args[key]
                stages.append(entry)
            elif record["name"] == "etl.fusion":
                fusion.append(dict(record["args"]))
            elif record["name"] == "etl.shuffle":
                # one entry per exchange: blocks written (M indexed vs M×R
                # legacy), bytes, reduce start lag — the shuffle data
                # plane's own evidence in query stats / etl_breakdown
                shuffle.append(dict(record["args"]))
        self.last_query_stats = {
            "seconds": query_span.duration,
            "output_partitions": len(results),
            "stages": stages,
            "fusion": fusion,
            "shuffle": shuffle,
            "plan_cache": plan_cache,
            "rpc": rpc_stats,
            "recovery": recovery,
        }
        # the raw span records behind the stats: what explain_last_query /
        # obs.analysis walks for critical-path attribution (kept by
        # reference — the list is already materialized, this is one assign)
        self.last_query_records = records
        # telemetry tick: put this query's spans + the driver registry on
        # the head so the scrape endpoint / TSDB stay live under an
        # interactive workload (throttled — a 1000-query burst pays one
        # RPC per second, not per query)
        obs.flush_throttled(1.0)
        return results

    # ------------------------------------------------------------------
    # the recursive stage driver
    # ------------------------------------------------------------------

    def _execute(
        self, node: lp.PlanNode, output: T.OutputSpec, offset: int = 0
    ) -> List[T.TaskResult]:
        """``offset`` shifts partition indices so sibling subplans (union
        inputs) never share an index — indices seed RNGs and name parquet
        parts, so collisions silently lose data."""
        base, chain = self._split_narrow(node)
        shipped = self._prepare_chain(chain)

        if isinstance(base, (lp.ArrowSource, lp.RangeSource, lp.ParquetSource, lp.CsvSource)):
            reads = self._source_reads(base)
            specs = [
                T.TaskSpec(
                    reads=[r], chain=shipped, output=output, partition_index=offset + i
                )
                for i, r in enumerate(reads)
            ]
            return self.submit(specs)

        if isinstance(base, lp.Union):
            results: List[T.TaskResult] = []
            for child in base.inputs:
                # re-root the narrow chain over each input
                sub = child
                for n in chain:
                    sub = self._reroot(n, sub)
                child_results = self._execute(sub, output, offset + len(results))
                results.extend(child_results)
            return results

        if isinstance(base, lp.GlobalLimit):
            # materialize the limited child exactly (global trim), run the
            # remaining chain over the trimmed blocks, then free intermediates
            trimmed, scratch = self._materialize_limited(base)
            schema_ipc = T.schema_ipc_bytes(trimmed.schema)
            specs = [
                T.TaskSpec(
                    reads=[T.ReadSpec("block", blocks=[b], schema_ipc=schema_ipc)],
                    chain=shipped,
                    output=output,
                    partition_index=offset + i,
                )
                for i, b in enumerate(trimmed.blocks)
            ]
            out = self.submit(specs)
            self._delete_blocks(scratch)
            return out

        if isinstance(base, lp.Repartition):
            return self._execute_repartition(offset, base, shipped, output)
        if isinstance(base, lp.GroupByAgg):
            return self._execute_groupby(offset, base, shipped, output)
        if isinstance(base, lp.Join):
            return self._execute_join(offset, base, shipped, output)
        if isinstance(base, lp.Sort):
            return self._execute_sort(offset, base, shipped, output)
        if isinstance(base, lp.Distinct):
            return self._execute_distinct(offset, base, shipped, output)
        if isinstance(base, lp.Window):
            return self._execute_window(offset, base, shipped, output)
        raise TypeError(f"cannot execute {type(base).__name__}")

    def _reroot(self, narrow: lp.PlanNode, child: lp.PlanNode) -> lp.PlanNode:
        import copy

        clone = copy.copy(narrow)
        if isinstance(clone, lp.Union):
            raise TypeError("not narrow")
        clone.child = child  # type: ignore[attr-defined]
        return clone

    def _block_reads(
        self, blocks: List[Optional[store.ObjectRef]], schema_ipc: bytes
    ) -> List[T.ReadSpec]:
        """One ReadSpec per block, each carrying any lease-stamped location
        THIS process already knows (head-bypass push: blocks the driver
        wrote — from_arrow/from_pandas sources — resolve executor-side with
        zero head RPCs)."""
        reads = []
        for b in blocks:
            metas = {}
            if b is not None and self.head_bypass:
                entry = store.local_meta(b.object_id)
                if entry is not None:
                    metas[b.object_id] = entry
            reads.append(
                T.ReadSpec(
                    "block",
                    blocks=[b] if b is not None else [],
                    schema_ipc=schema_ipc,
                    metas=metas,
                )
            )
        return reads

    def _source_reads(self, base: lp.PlanNode) -> List[T.ReadSpec]:
        if isinstance(base, lp.ArrowSource):
            return self._block_reads(
                list(base.blocks), T.schema_ipc_bytes(base.schema)
            )
        if isinstance(base, lp.RangeSource):
            total = max(0, math.ceil((base.end - base.start) / base.step))
            per = math.ceil(total / base.num_partitions) if base.num_partitions else total
            reads = []
            for i in range(base.num_partitions):
                lo = base.start + i * per * base.step
                hi = min(base.end, base.start + (i + 1) * per * base.step)
                reads.append(T.ReadSpec("range", range_args=(lo, max(lo, hi), base.step)))
            return reads
        if isinstance(base, lp.ParquetSource):
            return [
                T.ReadSpec("parquet", files=g, columns=base.columns)
                for g in base.file_groups
            ]
        if isinstance(base, lp.CsvSource):
            return [
                T.ReadSpec("csv", files=g, csv_options=base.read_options)
                for g in base.file_groups
            ]
        raise TypeError(type(base).__name__)

    def _num_partitions(self, requested: Optional[int]) -> int:
        return requested or self.default_parallelism

    def _shuffle_reads(
        self,
        map_results: List[T.TaskResult],
        num_reducers: int,
        schema: pa.Schema,
    ) -> List[T.ReadSpec]:
        """Transpose map-side split outputs into per-reducer ReadSpecs
        (delegates to the shared builder — indexed and legacy layouts)."""
        return T.build_shuffle_reads(
            map_results, num_reducers, T.schema_ipc_bytes(schema)
        )

    def _split_output(self, kind: str, **kw) -> T.OutputSpec:
        """A shuffle map-side OutputSpec carrying the session's indexed-
        block decision (ONE block per map task vs one per split)."""
        return T.OutputSpec(
            kind, indexed_splits=self.shuffle_indexed_blocks, **kw
        )

    def _cleanup_intermediate(self, results: List[Optional[T.TaskResult]]) -> None:
        self._delete_blocks(
            [
                b
                for res in results
                if res is not None
                for b in res.blocks
                if b is not None
            ]
        )

    @staticmethod
    def _delete_blocks(refs: List[store.ObjectRef]) -> None:
        if refs:
            try:
                store.delete(refs)
            except Exception:
                # best-effort (shuffle temp blocks also die with their
                # owner) — but COUNTED: silently leaked blocks were
                # invisible before; now they surface in dump_metrics and
                # as an instant on the trace timeline
                from raydp_tpu_torch import obs

                obs.metrics.counter("store.delete_failures").inc(len(refs))
                obs.instant("store.delete_failed", blocks=len(refs))

    # ------------------------------------------------------------------
    # shuffle exchange (barrier-free reduce start)
    # ------------------------------------------------------------------

    def _map_stage(
        self,
        node: lp.PlanNode,
        output: T.OutputSpec,
        launcher: "_ReduceLauncher",
        side: int,
    ) -> List[T.TaskResult]:
        """Execute a shuffle's map side, streaming completions into the
        launcher. When the plan's top is a single simple stage (source base
        + narrow chain — the common case) completions flow task-by-task out
        of the gather loop, so the reduce round starts the moment the last
        input slice is registered instead of after stage teardown. Composite
        map sides (union / limit / nested wide ops) fall back to the barrier
        path and report results after the fact."""
        specs = self._simple_map_specs(node, output)
        if specs is not None:
            launcher.begin_side(side, len(specs))
            return self.submit(specs, on_result=launcher.observer(side))
        results = self._execute(node, output)
        launcher.begin_side(side, len(results))
        observe = launcher.observer(side)
        for i, r in enumerate(results):
            observe(i, r)
        return results

    def _exchange(
        self,
        child: lp.PlanNode,
        map_out: T.OutputSpec,
        num_reducers: int,
        schema: pa.Schema,
        spec_fn,
    ) -> List[T.TaskResult]:
        """One-sided map→reduce exchange. Reduce tasks dispatch barrier-free
        (per-reducer readiness from streamed map completions); on a single-
        executor pool with a simple map side, the whole map→reduce graph
        ships to the executor in ONE dispatch (`run_shuffle`) — co-located
        partitions never pay a second driver round trip."""
        fused = self._try_fused_exchange(
            child, map_out, num_reducers, schema, spec_fn
        )
        if fused is not None:
            return fused
        launcher = _ReduceLauncher(
            self, num_reducers, lambda r, reads: spec_fn(r, reads[0])
        )
        side = launcher.add_side(schema)
        map_results = self._map_stage(child, map_out, launcher, side)
        out = launcher.gather()
        launcher.emit_stats(indexed=map_out.indexed_splits)
        self._cleanup_intermediate(map_results)
        return out

    def _simple_map_specs(
        self, child: lp.PlanNode, map_out: T.OutputSpec
    ) -> Optional[List[T.TaskSpec]]:
        """The map side as a flat spec list, when it is one simple stage."""
        base, chain = self._split_narrow(child)
        if not isinstance(
            base,
            (lp.ArrowSource, lp.RangeSource, lp.ParquetSource, lp.CsvSource),
        ):
            return None
        shipped = self._prepare_chain(chain)
        return [
            T.TaskSpec(
                reads=[r], chain=shipped, output=map_out, partition_index=i
            )
            for i, r in enumerate(self._source_reads(base))
        ]

    def _try_fused_exchange(
        self,
        child: lp.PlanNode,
        map_out: T.OutputSpec,
        num_reducers: int,
        schema: pa.Schema,
        spec_fn,
    ) -> Optional[List[T.TaskResult]]:
        """Single-executor pools skip the driver round trip between the map
        and reduce rounds entirely: the executor runs the whole graph from
        one ``run_shuffle`` dispatch (every partition is co-located by
        construction). Falls back to the two-stage path on any delivery
        failure — re-running both rounds is the same retry surface a batched
        stage has."""
        if len(self.executors) != 1:
            return None
        map_specs = self._simple_map_specs(child, map_out)
        if map_specs is None:
            return None
        hook = self.scale_hook
        if hook is not None:
            # dynamic allocation gets its pre-dispatch look at the stage
            # width exactly as submit() would give it; if the pool grows,
            # the single-executor fused path no longer applies
            try:
                hook(len(map_specs))
            except Exception:
                # local import: this function's `obs` binding happens below
                from raydp_tpu_torch.obs import metrics

                metrics.counter("etl.scale_hook_failures").inc()
            if len(self.executors) != 1:
                return None
        from raydp_tpu_torch import obs

        schema_ipc = T.schema_ipc_bytes(schema)
        protos = [
            spec_fn(r, T.ReadSpec("block", schema_ipc=schema_ipc))
            for r in range(num_reducers)
        ]
        waves = -(
            -(len(map_specs) + num_reducers) // max(1, self.executor_slots)
        )
        admission = getattr(self, "admission", None)
        ticket = (
            admission.acquire(len(map_specs) + num_reducers)
            if admission is not None
            else None
        )
        if hook is not None:
            # the inflight guard keeps dynamic deallocation from killing
            # this executor under the in-flight fused dispatch
            with self._inflight_lock:
                self._inflight += 1
        delivery_failed = False
        try:
            # with-block: the stage span closes on EVERY exit path — an
            # application error propagating out of the fused dispatch must
            # not leave the span open (it would vanish from query stats and
            # mis-parent later spans under a dead context)
            with obs.span(
                "etl.stage", tasks=len(map_specs) + num_reducers
            ) as stage_span:
                try:
                    obs.metrics.counter("etl.actor_dispatches").inc()
                    map_results, out = (
                        self.executors[0]
                        .run_shuffle.options(timeout=300.0 * waves)
                        .remote(map_specs, protos, schema_ipc, num_reducers)
                        .result()
                    )
                except (ConnectionError, EOFError, _ActorDied):
                    delivery_failed = True
                except _ClusterError as exc:
                    # lost-block read inside the fused exchange: recover,
                    # refresh the map specs' pushed metas, re-run two-stage
                    if not self._try_block_recovery(exc, specs=map_specs):
                        raise
                    delivery_failed = True
                except AttributeError as exc:
                    # ONLY the missing-method signature of an older executor
                    # falls back; a genuine AttributeError inside a task
                    # body must propagate, not silently re-run the exchange
                    if "run_shuffle" not in str(exc):
                        raise
                    delivery_failed = True
                if delivery_failed:
                    # schema-conformant failure record: consumers iterate
                    # stages expecting the phase keys to exist
                    stage_span.set(
                        dispatch="fused_failed", server_seconds=0.0,
                        read_s=0.0, compute_s=0.0, emit_s=0.0,
                    )
                else:
                    stage_span.set(
                        dispatch="fused",
                        server_seconds=round(
                            sum(r.server_seconds for r in map_results + out), 6
                        ),
                        read_s=round(
                            sum(r.read_seconds for r in map_results + out), 6
                        ),
                        compute_s=round(
                            sum(r.compute_seconds for r in map_results + out), 6
                        ),
                        emit_s=round(
                            sum(r.emit_seconds for r in map_results + out), 6
                        ),
                    )
        finally:
            if admission is not None:
                admission.release(ticket)
            if hook is not None:
                with self._inflight_lock:
                    self._inflight -= 1
        if delivery_failed:
            return None
        obs.metrics.counter("etl.stages").inc()
        obs.metrics.counter("etl.tasks_dispatched").inc(
            len(map_specs) + num_reducers
        )
        obs.metrics.counter("etl.fused_exchanges").inc()
        blocks = [
            b for res in map_results for b in res.blocks if b is not None
        ]
        # lineage: map specs were built driver-side; reduce specs are
        # rebuilt on demand from the map results (deferred — no cost here)
        self._record_lineage(map_specs, map_results)
        if self.lineage_recovery and getattr(self, "lineage", None) is not None:
            for r, res in enumerate(out):
                def _make_reduce(
                    r=r, spec_fn=spec_fn, map_results=map_results,
                    schema_ipc=schema_ipc, num_reducers=num_reducers,
                ):
                    reads = T.build_shuffle_reads(
                        map_results, num_reducers, schema_ipc
                    )
                    return spec_fn(r, reads[r])

                self.lineage.record_maker(_make_reduce, res)
        obs.instant(
            "etl.shuffle",
            map_tasks=len(map_specs),
            reducers=num_reducers,
            blocks=len(blocks),
            bytes=sum(b.size for b in blocks),
            indexed=bool(map_out.indexed_splits),
            dispatch="fused",
            reduce_start_lag_s=0.0,
        )
        self._delete_blocks(blocks)
        return out

    def _execute_repartition(
        self, offset: int, base: lp.Repartition, chain: List[lp.PlanNode], output: T.OutputSpec
    ) -> List[T.TaskResult]:
        n = self._num_partitions(base.num_partitions)
        child_schema = self.infer_schema(base.child)
        if base.by:
            map_out = self._split_output("hash_split", num_splits=n, keys=list(base.by))
        elif base.shuffle_seed is not None:
            map_out = self._split_output("random_split", num_splits=n, seed=base.shuffle_seed)
        else:
            map_out = self._split_output("round_robin_split", num_splits=n)
        shuffle_seed = base.shuffle_seed
        reduce_chain = list(chain)
        if shuffle_seed is not None:
            # shuffle rows *within* each output partition too (true random order)
            reduce_chain = [
                lp.MapBatches(None, _IntraShuffle(shuffle_seed))  # type: ignore[arg-type]
            ] + reduce_chain

        def spec_fn(i, read):
            return T.TaskSpec(
                reads=[read],
                merge=T.MergeSpec("none"),
                chain=reduce_chain,
                output=output,
                partition_index=offset + i,
            )

        return self._exchange(base.child, map_out, n, child_schema, spec_fn)

    def _execute_groupby(
        self, offset: int, base: lp.GroupByAgg, chain: List[lp.PlanNode], output: T.OutputSpec
    ) -> List[T.TaskResult]:
        n = 1 if not base.keys else self._num_partitions(base.num_partitions)
        partial = lp.MapBatches(
            base.child, _PartialAgg(base.keys, base.aggs)
        )
        if base.keys:
            map_out = self._split_output("hash_split", num_splits=n, keys=list(base.keys))
        else:
            map_out = T.OutputSpec("block")  # single reducer merges all partials
        partial_schema = T.partial_agg(
            self._empty_result(base.child), base.keys, base.aggs
        ).schema

        def spec_fn(i, read):
            return T.TaskSpec(
                reads=[read],
                merge=T.MergeSpec(
                    "final_agg", keys=list(base.keys), aggs=list(base.aggs)
                ),
                chain=chain,
                output=output,
                partition_index=offset + i,
            )

        return self._exchange(partial, map_out, n, partial_schema, spec_fn)

    # joins whose semantics survive broadcasting only the RIGHT side: each
    # left partition independently emits its complete result (right/full
    # outer would duplicate unmatched right rows per partition)
    _BROADCASTABLE_HOW = ("inner", "left outer", "left semi", "left anti")
    BROADCAST_THRESHOLD_BYTES = 10 << 20

    def _broadcast_side(self, base: lp.Join) -> Optional[str]:
        if base.how not in self._BROADCASTABLE_HOW:
            return None
        if base.broadcast == "right":
            return "right"
        if base.broadcast is not None:
            return None
        # auto: broadcast only when the right side is already materialized
        # (possibly under shrink-only narrow ops) with known total size under
        # the threshold — the Spark autoBroadcastJoinThreshold analog
        node = base.right
        while isinstance(node, (lp.Filter, lp.Sample, lp.PartitionHead, lp.GlobalLimit)):
            node = node.children()[0]
        if isinstance(node, lp.ArrowSource) and node.blocks:
            total = 0
            for b in node.blocks:
                size = getattr(b, "size", None)
                if size is None:
                    return None
                total += size
            if total <= self.BROADCAST_THRESHOLD_BYTES:
                return "right"
        return None

    def _execute_broadcast_join(
        self, offset: int, base: lp.Join, chain: List[lp.PlanNode], output: T.OutputSpec
    ) -> List[T.TaskResult]:
        """Ship the (small) right side whole to every left partition: the big
        side is never hash-partitioned — one stage to materialize the right,
        one join stage over the left's natural partitioning."""
        right_schema = self.infer_schema(base.right)
        # cached (ArrowSource) right sides — the auto-broadcast trigger —
        # are borrowed as-is; only unmaterialized plans cost a stage here
        right_mat, right_fresh = self.materialize_node_cached(base.right)
        right_read = T.ReadSpec(
            "block",
            blocks=[b for b in right_mat.blocks if b is not None],
            schema_ipc=T.schema_ipc_bytes(right_schema),
        )
        left_mat, left_fresh = self.materialize_node_cached(base.left)
        left_ipc = T.schema_ipc_bytes(left_mat.schema)
        specs = [
            T.TaskSpec(
                reads=[
                    T.ReadSpec(
                        "block",
                        blocks=[b] if b is not None else [],
                        schema_ipc=left_ipc,
                    )
                ],
                merge=T.MergeSpec(
                    "join", keys=list(base.on), right=right_read,
                    join_how=base.how,
                ),
                chain=chain,
                output=output,
                partition_index=offset + i,
            )
            for i, b in enumerate(left_mat.blocks)
        ]
        out = self.submit(specs)
        if right_fresh:
            self._delete_blocks([b for b in right_mat.blocks if b is not None])
        if left_fresh:
            self._delete_blocks([b for b in left_mat.blocks if b is not None])
        return out

    def _execute_window(
        self, offset: int, base: lp.Window, chain: List[lp.PlanNode], output: T.OutputSpec
    ) -> List[T.TaskResult]:
        """Hash-shuffle on partition_by so every group is whole on one
        reducer, then sort + append window columns there. No partition_by →
        one global reducer (the Spark warning case)."""
        child_schema = self.infer_schema(base.child)
        apply_node = lp.MapBatches(
            None,  # type: ignore[arg-type]
            T.WindowApply(
                base.partition_by, base.order_by, base.ascending, base.exprs
            ),
        )
        if base.partition_by:
            n = self._num_partitions(base.num_partitions)
            map_out = self._split_output(
                "hash_split", num_splits=n, keys=list(base.partition_by)
            )
        else:
            n = 1
            map_out = T.OutputSpec("block")

        def spec_fn(i, read):
            return T.TaskSpec(
                reads=[read],
                merge=T.MergeSpec("none"),
                chain=[apply_node] + chain,
                output=output,
                partition_index=offset + i,
            )

        return self._exchange(base.child, map_out, n, child_schema, spec_fn)

    def _execute_join(
        self, offset: int, base: lp.Join, chain: List[lp.PlanNode], output: T.OutputSpec
    ) -> List[T.TaskResult]:
        """Shuffle join: BOTH map rounds run concurrently (the reference —
        and the pre-pipelined planner — ran them serially, a full driver
        barrier between two independent stages), and each join reducer
        dispatches as soon as its left AND right input slices are all
        registered."""
        import threading

        from raydp_tpu_torch import obs

        if self._broadcast_side(base) == "right":
            return self._execute_broadcast_join(offset, base, chain, output)
        n = self._num_partitions(base.num_partitions)
        left_schema = self.infer_schema(base.left)
        right_schema = self.infer_schema(base.right)
        # infer the RIGHT schema here too: schema inference mutates plan-node
        # caches, which must not race the left side's inference on two threads

        def spec_fn(i, side_reads):
            return T.TaskSpec(
                reads=[side_reads[0]],
                merge=T.MergeSpec(
                    "join", keys=list(base.on), right=side_reads[1],
                    join_how=base.how,
                ),
                chain=chain,
                output=output,
                partition_index=offset + i,
            )

        launcher = _ReduceLauncher(self, n, spec_fn)
        left_side = launcher.add_side(left_schema)
        right_side = launcher.add_side(right_schema)
        map_out_left = self._split_output(
            "hash_split", num_splits=n, keys=list(base.on)
        )
        map_out_right = self._split_output(
            "hash_split", num_splits=n, keys=list(base.on)
        )
        right_box: dict = {}
        ctx = obs.current_context()
        sinks = obs.current_sinks()

        def run_right():
            # the worker thread adopts the query's collector sinks + trace
            # context so its stage spans land in the same last_query_stats
            with obs.use_sinks(sinks), obs.use_context(ctx):
                try:
                    right_box["results"] = self._map_stage(
                        base.right, map_out_right, launcher, right_side
                    )
                except BaseException as exc:  # noqa: BLE001 - re-raised below
                    launcher.abort()
                    right_box["error"] = exc

        thread = threading.Thread(target=run_right, daemon=True)
        thread.start()
        try:
            left_results = self._map_stage(
                base.left, map_out_left, launcher, left_side
            )
        except BaseException:
            launcher.abort()
            thread.join(timeout=300)
            raise
        thread.join()
        if "error" in right_box:
            raise right_box["error"]
        out = launcher.gather()
        launcher.emit_stats(indexed=self.shuffle_indexed_blocks)
        self._cleanup_intermediate(left_results)
        self._cleanup_intermediate(right_box.get("results", []))
        return out

    def _execute_sort(
        self, offset: int, base: lp.Sort, chain: List[lp.PlanNode], output: T.OutputSpec
    ) -> List[T.TaskResult]:
        n = self._num_partitions(base.num_partitions)
        child, child_is_fresh = self.materialize_node_cached(base.child)
        schema_ipc = T.schema_ipc_bytes(child.schema)
        key = base.keys[0]
        # 1) sample the first sort key from every partition
        sample_specs = [
            T.TaskSpec(
                reads=[T.ReadSpec("block", blocks=[b], schema_ipc=schema_ipc)],
                output=T.OutputSpec("sample", keys=[key], seed=i, sample_limit=1000),
                partition_index=i,
            )
            for i, b in enumerate(child.blocks)
        ]
        samples = [
            T.ipc_bytes_to_table(r.inline_ipc)
            for r in self.submit(sample_specs)
            if r.inline_ipc
        ]
        merged = (
            pa.concat_tables(samples)
            if samples
            else pa.table({key: pa.array([], child.schema.field(key).type)})
        )
        # nulls-last sampling: boundaries come from NON-null samples only —
        # np.sort on an object array containing None raises (the seed-era
        # sort() crash on null-bearing string keys), and null rows are
        # range-routed to the last partition regardless (see _range_indices),
        # matching the nulls-last merge placement below
        values = np.sort(
            merged.column(key).drop_null().to_numpy(zero_copy_only=False)
        )
        if len(values) == 0 or n == 1:
            boundaries = pa.table({key: pa.array([], child.schema.field(key).type)})
        else:
            quantile_idx = (np.arange(1, n) * len(values)) // n
            bounds = values[np.minimum(quantile_idx, len(values) - 1)]
            boundaries = pa.table(
                {key: pa.array(np.asarray(bounds), child.schema.field(key).type)}
            )
        # 2) range-split every partition; 3) merge + sort each range —
        # reduce tasks dispatch barrier-free as the splits complete
        map_out = self._split_output(
            "range_split",
            num_splits=n,
            keys=[key],
            boundaries_ipc=T.table_to_ipc_bytes(boundaries),
            ascending=list(base.ascending),
        )
        map_specs = [
            T.TaskSpec(
                reads=[T.ReadSpec("block", blocks=[b], schema_ipc=schema_ipc)],
                output=map_out,
                partition_index=i,
            )
            for i, b in enumerate(child.blocks)
        ]

        def spec_fn(i, side_reads):
            return T.TaskSpec(
                reads=[side_reads[0]],
                merge=T.MergeSpec(
                    "sort", keys=list(base.keys), ascending=list(base.ascending)
                ),
                chain=chain,
                output=output,
                partition_index=offset + i,
            )

        launcher = _ReduceLauncher(self, n, spec_fn)
        side = launcher.add_side(child.schema)
        launcher.begin_side(side, len(map_specs))
        map_results = self.submit(map_specs, on_result=launcher.observer(side))
        out = launcher.gather()
        launcher.emit_stats(indexed=map_out.indexed_splits)
        self._cleanup_intermediate(map_results)
        if child_is_fresh:
            self._delete_blocks([b for b in child.blocks if b is not None])
        return out

    def _execute_distinct(
        self, offset: int, base: lp.Distinct, chain: List[lp.PlanNode], output: T.OutputSpec
    ) -> List[T.TaskResult]:
        n = self._num_partitions(base.num_partitions)
        child_schema = self.infer_schema(base.child)
        keys = list(child_schema.names)
        dedup = lp.MapBatches(base.child, _LocalDistinct())

        def spec_fn(i, read):
            return T.TaskSpec(
                reads=[read],
                merge=T.MergeSpec("distinct"),
                chain=chain,
                output=output,
                partition_index=offset + i,
            )

        return self._exchange(
            dedup,
            self._split_output("hash_split", num_splits=n, keys=keys),
            n,
            child_schema,
            spec_fn,
        )

    def _materialize_limited(
        self, limit: lp.GlobalLimit
    ) -> Tuple[Materialized, List[store.ObjectRef]]:
        """Materialize a GlobalLimit's child (per-partition heads already
        applied) and trim the block list to exactly n rows. Also returns every
        intermediate ref created, for cleanup once consumed (the trimmed reads
        feed exactly one downstream stage)."""
        mat = self.materialize(limit.child)
        scratch: List[store.ObjectRef] = [b for b in mat.blocks if b is not None]
        n = limit.n
        kept: List[Optional[store.ObjectRef]] = []
        counts: List[int] = []
        total = 0
        for b, c in zip(mat.blocks, mat.counts):
            if total >= n or b is None:
                continue
            if total + c <= n:
                kept.append(b)
                counts.append(c)
            else:
                table = T.read_table_block(b).slice(0, n - total)
                ref, cnt = T.write_table_block(table, owner=self.owner)
                scratch.append(ref)
                kept.append(ref)
                counts.append(cnt)
            total += counts[-1]
        if not kept:  # keep at least one (empty) partition for schema flow
            ref, cnt = T.write_table_block(mat.schema.empty_table(), owner=self.owner)
            scratch.append(ref)
            kept, counts = [ref], [0]
        return Materialized(mat.schema, kept, counts), scratch

    # cache hook (used by Sort which needs the child twice; DataFrame.cache
    # replaces the plan with an ArrowSource so this stays trivial)
    def materialize_node_cached(self, node: lp.PlanNode) -> Tuple[Materialized, bool]:
        """Returns (materialized, fresh): fresh blocks belong to this stage and
        must be deleted once consumed; an ArrowSource's blocks are borrowed."""
        if isinstance(node, lp.ArrowSource):
            return Materialized(
                node.schema, list(node.blocks), [-1] * len(node.blocks)
            ), False
        return self.materialize(node), True

    # ------------------------------------------------------------------
    # compiled plans: plan cache + whole-plan dispatch (the millisecond
    # control plane — repeated query shapes skip planning/lowering and ship
    # as ONE run_plan per executor)
    # ------------------------------------------------------------------

    PLAN_CACHE_CAP = 64
    _UNSUPPORTED = object()  # negative-cache marker for uncompilable shapes

    def plan_cache_stats(self) -> dict:
        """Process-lifetime compiled-plan cache counters + current size."""
        from raydp_tpu_torch import obs

        with self._plan_cache_lock:
            size = sum(
                1 for v in self._plan_cache.values() if v is not self._UNSUPPORTED
            )
        return {
            "size": size,
            "hits": int(obs.metrics.counter("plan_cache.hits").value),
            "misses": int(obs.metrics.counter("plan_cache.misses").value),
            "unsupported": int(
                obs.metrics.counter("plan_cache.unsupported").value
            ),
        }

    def plan_cache_clear(self) -> None:
        """Drop every compiled program (sessions call this when a conf that
        affects lowering changes mid-session; ordinary invalidation — conf or
        schema change — happens naturally through the fingerprint)."""
        with self._plan_cache_lock:
            self._plan_cache.clear()
        self._plans_shipped.clear()

    def _try_compiled(
        self, node: lp.PlanNode, output: T.OutputSpec
    ) -> Optional[List[T.TaskResult]]:
        """Fingerprint → cache probe → (compile on miss) → run. Returns None
        for shapes the compiler doesn't express (join/sort/limit/union —
        the recursive driver handles them exactly as before)."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.etl import program as P

        if not self.plan_cache and not self.compiled_dispatch:
            return None
        key = P.fingerprint_plan(
            node,
            (
                output.kind, output.storage, output.path, tuple(output.keys),
                output.seed, output.sample_limit, output.max_records,
            ),
            (
                self.fuse_projects, self.shuffle_indexed_blocks,
                self.default_parallelism,
            ),
        )
        if key is None:
            obs.metrics.counter("plan_cache.unsupported").inc()
            return None
        program = None
        if self.plan_cache:
            with self._plan_cache_lock:
                entry = self._plan_cache.get(key.fingerprint)
                if entry is not None:
                    self._plan_cache.move_to_end(key.fingerprint)
        else:
            entry = None
        if entry is self._UNSUPPORTED:
            obs.metrics.counter("plan_cache.unsupported").inc()
            return None
        if entry is not None:
            if entry.template_literals is not None and [
                lit.value for lit in key.literals
            ] != entry.template_literals:
                entry = None  # unmappable literal changed: recompile
            else:
                obs.metrics.counter("plan_cache.hits").inc()
                program = entry
        if (
            program is None
            and self.plan_cache
            and getattr(self, "shared_plan_cache", False)
        ):
            # cross-tenant shared cache (tenancy): another planner in this
            # driver may have lowered this exact fingerprint already —
            # adopt its program (counted as a hit; cross-tenant adoption
            # additionally counts plan_cache.cross_tenant_hits, AFTER the
            # template check so a rejected probe never fakes sharing) and
            # seed the local LRU so the next probe is one dict hit
            my_tenant = getattr(self, "tenant", "") or ""
            entry2 = P.shared_plan_get(key.fingerprint, my_tenant)
            if entry2 is not None:
                shared, compiled_by = entry2
                if not (
                    shared.template_literals is not None
                    and [lit.value for lit in key.literals]
                    != shared.template_literals
                ):
                    obs.metrics.counter("plan_cache.hits").inc()
                    if compiled_by != my_tenant:
                        P.note_cross_tenant_hit(my_tenant)
                    with self._plan_cache_lock:
                        self._plan_cache[key.fingerprint] = shared
                        self._plan_cache.move_to_end(key.fingerprint)
                        while len(self._plan_cache) > self.PLAN_CACHE_CAP:
                            self._plan_cache.popitem(last=False)
                    program = shared
        if program is None:
            program = self._compile_plan(node, output, key)
            if self.plan_cache:
                with self._plan_cache_lock:
                    self._plan_cache[key.fingerprint] = (
                        program if program is not None else self._UNSUPPORTED
                    )
                    self._plan_cache.move_to_end(key.fingerprint)
                    while len(self._plan_cache) > self.PLAN_CACHE_CAP:
                        self._plan_cache.popitem(last=False)
            if program is None:
                obs.metrics.counter("plan_cache.unsupported").inc()
                return None
            obs.metrics.counter("plan_cache.misses").inc()
            if self.plan_cache and getattr(self, "shared_plan_cache", False):
                P.shared_plan_put(
                    key.fingerprint, program,
                    getattr(self, "tenant", "") or "",
                )
        return self._run_program(program, key, output)

    def _compile_plan(self, node: lp.PlanNode, output: T.OutputSpec, key):
        """Lower a plan into a CompiledProgram, or None when the shape is
        out of the compiler's dialect (handled by the staged driver)."""
        import dataclasses

        from raydp_tpu_torch.etl import program as P

        base, chain = self._split_narrow(node)
        out_template = dataclasses.replace(output, owner=None)
        if isinstance(
            base,
            (lp.ArrowSource, lp.RangeSource, lp.ParquetSource, lp.CsvSource),
        ):
            is_arrow = isinstance(base, lp.ArrowSource)
            if len(key.block_slots) != (1 if is_arrow else 0):
                return None  # fingerprint/plan shape disagreement: bail
            shipped, fusion = self._prepare_chain_quiet(chain)
            maps = P.slot_map_for([shipped], key)
            return P.SimpleProgram(
                program_id=key.fingerprint,
                chain=shipped,
                slot_map=maps[0] if maps is not None else [],
                template_literals=(
                    None if maps is not None
                    else [lit.value for lit in key.literals]
                ),
                source_reads=None if is_arrow else self._source_reads(base),
                schema_ipc=(
                    T.schema_ipc_bytes(base.schema) if is_arrow else None
                ),
                output=out_template,
                fusion=[fusion] if fusion else [],
            )
        if isinstance(
            base, (lp.Repartition, lp.GroupByAgg, lp.Distinct, lp.Window)
        ):
            return self._compile_exchange(base, chain, out_template, key)
        return None

    def _compile_exchange(self, base, chain, out_template, key):
        """Lower a single-exchange plan (simple map side) to an
        ExchangeProgram mirroring exactly what the corresponding
        ``_execute_*`` method builds — the A/B parity tests hold the two
        paths byte-identical."""
        from raydp_tpu_torch.etl import program as P

        reduce_chain, fusion_r = self._prepare_chain_quiet(chain)
        if isinstance(base, lp.Repartition):
            n = self._num_partitions(base.num_partitions)
            map_child = base.child
            child_schema = self.infer_schema(base.child)
            if base.by:
                map_out = self._split_output(
                    "hash_split", num_splits=n, keys=list(base.by)
                )
            elif base.shuffle_seed is not None:
                map_out = self._split_output(
                    "random_split", num_splits=n, seed=base.shuffle_seed
                )
            else:
                map_out = self._split_output("round_robin_split", num_splits=n)
            if base.shuffle_seed is not None:
                reduce_chain = [
                    lp.MapBatches(None, _IntraShuffle(base.shuffle_seed))  # type: ignore[arg-type]
                ] + reduce_chain
            merge = T.MergeSpec("none")
        elif isinstance(base, lp.GroupByAgg):
            n = 1 if not base.keys else self._num_partitions(base.num_partitions)
            map_child = lp.MapBatches(
                base.child, _PartialAgg(base.keys, base.aggs)
            )
            child_schema = T.partial_agg(
                self._empty_result(base.child), base.keys, base.aggs
            ).schema
            if base.keys:
                map_out = self._split_output(
                    "hash_split", num_splits=n, keys=list(base.keys)
                )
            else:
                map_out = T.OutputSpec("block")
            merge = T.MergeSpec(
                "final_agg", keys=list(base.keys), aggs=list(base.aggs)
            )
        elif isinstance(base, lp.Distinct):
            n = self._num_partitions(base.num_partitions)
            child_schema = self.infer_schema(base.child)
            map_child = lp.MapBatches(base.child, _LocalDistinct())
            map_out = self._split_output(
                "hash_split", num_splits=n, keys=list(child_schema.names)
            )
            merge = T.MergeSpec("distinct")
        else:  # Window
            child_schema = self.infer_schema(base.child)
            apply_node = lp.MapBatches(
                None,  # type: ignore[arg-type]
                T.WindowApply(
                    base.partition_by, base.order_by, base.ascending,
                    base.exprs,
                ),
            )
            if base.partition_by:
                n = self._num_partitions(base.num_partitions)
                map_out = self._split_output(
                    "hash_split", num_splits=n, keys=list(base.partition_by)
                )
            else:
                n = 1
                map_out = T.OutputSpec("block")
            map_child = base.child
            reduce_chain = [apply_node] + reduce_chain
            merge = T.MergeSpec("none")
        m_base, m_chain = self._split_narrow(map_child)
        if not isinstance(
            m_base,
            (lp.ArrowSource, lp.RangeSource, lp.ParquetSource, lp.CsvSource),
        ):
            return None  # composite map side: staged legacy path
        is_arrow = isinstance(m_base, lp.ArrowSource)
        if len(key.block_slots) != (1 if is_arrow else 0):
            return None
        map_shipped, fusion_m = self._prepare_chain_quiet(m_chain)
        maps = P.slot_map_for([map_shipped, reduce_chain], key)
        return P.ExchangeProgram(
            program_id=key.fingerprint,
            map_chain=map_shipped,
            map_slot_map=maps[0] if maps is not None else [],
            reduce_chain=reduce_chain,
            reduce_slot_map=maps[1] if maps is not None else [],
            template_literals=(
                None if maps is not None
                else [lit.value for lit in key.literals]
            ),
            source_reads=None if is_arrow else self._source_reads(m_base),
            schema_ipc=(
                T.schema_ipc_bytes(m_base.schema) if is_arrow else None
            ),
            map_out=map_out,
            merge=merge,
            child_schema_ipc=T.schema_ipc_bytes(child_schema),
            num_reducers=n,
            output=out_template,
            fusion=[f for f in (fusion_m, fusion_r) if f],
        )

    def _run_program(
        self, program, key, output: T.OutputSpec
    ) -> List[T.TaskResult]:
        from raydp_tpu_torch import obs

        for info in program.fusion:
            obs.instant("etl.fusion", **info)
        binding = {
            "literals": [lit.value for lit in key.literals],
            "owner": output.owner,
            "storage": output.storage,
            "indexed": self.shuffle_indexed_blocks,
        }
        if program.source_reads is not None:
            reads = program.source_reads
        else:
            blocks = key.block_slots[0] if key.block_slots else []
            reads = self._block_reads(list(blocks), program.schema_ipc)
        if program.kind == "simple":
            return self._run_simple_program(program, reads, binding)
        return self._run_exchange_program(program, reads, binding)

    def _send_plan(self, idx: int, program, binding, with_blob: bool = False):
        """One run_plan dispatch. The program body ships only on the FIRST
        delivery to an actor (or on a ProgramCacheMiss retry after an
        executor restart/eviction): warm dispatches carry just the
        fingerprint + binding."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.etl import program as P

        handle = self.executors[idx]
        shipped_key = (handle._actor_id, program.program_id)
        blob = None
        if with_blob or shipped_key not in self._plans_shipped:
            blob = P.wire_blob(program)
        tasks = len(binding["indices"]) + (
            program.num_reducers if program.kind == "exchange" else 0
        )
        waves = -(-tasks // max(1, self.executor_slots))
        future = handle.run_plan.options(
            timeout=300.0 * max(1, waves)
        ).remote(program.program_id, binding, blob)
        self._plans_shipped.add(shipped_key)
        obs.metrics.counter("etl.actor_dispatches").inc()
        return future

    def _await_plan(self, future, idx: int, program, binding):
        """Gather one run_plan reply: a ProgramCacheMiss re-dispatches once
        WITH the program body; delivery failure returns None (the caller
        falls back to the staged retry ladder — the same surface a batched
        stage has). Application errors propagate."""
        from raydp_tpu_torch.etl import program as P

        try:
            try:
                return future.result()
            except P.ProgramCacheMiss:
                return self._send_plan(
                    idx, program, binding, with_blob=True
                ).result()
        except (ConnectionError, EOFError, _ActorDied):
            return None
        except _ClusterError as exc:
            # a lost-block read inside the compiled program (head-bypass
            # stale location / dead owner): lineage-recover, refresh the
            # binding's pushed metas IN PLACE (the staged fallback reuses
            # these ReadSpec objects), and fall back
            if not self._try_block_recovery(exc):
                raise
            from raydp_tpu_torch.etl import lineage as L

            L.refresh_reads(
                binding.get("reads") or [], L.missing_ids(exc)
            )
            return None
        except AttributeError as exc:
            # only the missing-method signature of an older executor falls
            # back; a genuine AttributeError in a task body must propagate
            if "run_plan" not in str(exc):
                raise
            return None

    def _plan_groups(self, reads: List[T.ReadSpec]) -> Tuple[List[List[int]], int]:
        """Partition→executor grouping for whole-plan dispatch. Locality
        comes from the pushed/cached location records first (zero RPCs for
        driver-written sources — the warm interactive path); blocks the
        driver has never seen (executor/agent-written) fall back to ONE
        batched head ``object_locations`` lookup, exactly like the staged
        path."""
        n = len(self.executors)
        nodes = self._executor_nodes()
        groups: List[List[int]] = [[] for _ in range(n)]
        npref = 0
        unplaced: List[int] = []

        def _known_node(read: T.ReadSpec, b) -> Optional[str]:
            entry = read.metas.get(b.object_id)
            meta = entry[0] if entry else store.cached_location(b.object_id)
            return meta.get("node_id") if meta else None

        locations: dict = {}
        if n >= 2:
            unknown = list(
                {
                    b.object_id
                    for read in reads
                    for b in read.blocks
                    if b is not None and _known_node(read, b) is None
                }
            )
            if unknown:
                from raydp_tpu_torch.cluster import api as cluster_api

                try:
                    locations = cluster_api.head_rpc(
                        "object_locations", object_ids=unknown
                    )
                except Exception:  # locality is advisory; placement degrades to round-robin
                    locations = {}
        for i, read in enumerate(reads):
            weight: dict = {}
            for b in read.blocks:
                if b is None:
                    continue
                node = _known_node(read, b) or locations.get(b.object_id)
                if node is not None:
                    weight[node] = weight.get(node, 0) + max(1, b.size)
            best = max(weight, key=weight.get) if weight else None
            candidates = (
                [j for j, nd in enumerate(nodes) if nd == best] if best else []
            )
            if candidates:
                groups[candidates[i % len(candidates)]].append(i)
                npref += 1
            else:
                unplaced.append(i)
        for i in unplaced:
            groups[min(range(n), key=lambda g: len(groups[g]))].append(i)
        return groups, npref

    def _run_simple_program(
        self, program, reads: List[T.ReadSpec], binding
    ) -> List[T.TaskResult]:
        """A simple program over the pool: ONE run_plan dispatch per
        executor (its whole partition group), with submit()'s side-effect
        surface — scale hook, inflight guard, stage span, metrics — and a
        per-task retry-ladder fallback for failed deliveries."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.etl import program as P

        indices = list(range(len(reads)))
        if not self.executors or not self.compiled_dispatch:
            specs = P.build_simple_specs(
                program, {**binding, "reads": reads, "indices": indices}
            )
            return self.submit(specs)
        admission = getattr(self, "admission", None)
        ticket = admission.acquire(len(reads)) if admission is not None else None
        hook = self.scale_hook
        if hook is not None:
            with self._inflight_lock:
                self._inflight += 1
            try:
                hook(len(reads))
            except Exception:
                obs.metrics.counter("etl.scale_hook_failures").inc()
        try:
            with obs.span("etl.stage", tasks=len(reads)) as stage_span:
                groups, npref = self._plan_groups(reads)
                futures = []
                for idx, group in enumerate(groups):
                    if not group:
                        continue
                    b = {
                        **binding,
                        "reads": [reads[i] for i in group],
                        "indices": group,
                    }
                    try:
                        futures.append(
                            (self._send_plan(idx, program, b), idx, group, b)
                        )
                    except _ActorDied:
                        futures.append((None, idx, group, b))
                results: List[Optional[T.TaskResult]] = [None] * len(reads)
                fallback: List[int] = []
                for future, idx, group, b in futures:
                    batch = (
                        self._await_plan(future, idx, program, b)
                        if future is not None
                        else None
                    )
                    if batch is None:
                        fallback.extend(group)
                        continue
                    for i, r in zip(group, batch):
                        results[i] = r
                if fallback:
                    fallback.sort()
                    obs.instant(
                        "etl.batch_retry", tasks=len(fallback), attempt=1
                    )
                    obs.metrics.counter("etl.task_retries").inc(len(fallback))
                    dense = P.build_simple_specs(
                        program,
                        {
                            **binding,
                            "reads": [reads[i] for i in fallback],
                            "indices": fallback,
                        },
                    )
                    retry = [
                        (self._dispatch(dense[j], fallback[j], 1), dense[j], j)
                        for j in range(len(dense))
                    ]
                    for j, r in enumerate(self._gather(retry, dense)):
                        results[fallback[j]] = r
                # lineage: one DEFERRED maker per partition — the concrete
                # TaskSpec is only built if recovery ever needs it
                if self.lineage_recovery and getattr(self, "lineage", None) is not None:
                    for i2, read in enumerate(reads):
                        def _make_simple(
                            read=read, i2=i2, program=program, binding=binding
                        ):
                            from raydp_tpu_torch.etl import program as _P

                            return _P.build_simple_specs(
                                program,
                                {**binding, "reads": [read], "indices": [i2]},
                            )[0]

                        self.lineage.record_maker(_make_simple, results[i2])
                stage_span.set(
                    dispatch="compiled",
                    locality_preferred=npref,
                    server_seconds=round(
                        sum(r.server_seconds for r in results), 6
                    ),
                    read_s=round(sum(r.read_seconds for r in results), 6),
                    compute_s=round(
                        sum(r.compute_seconds for r in results), 6
                    ),
                    emit_s=round(sum(r.emit_seconds for r in results), 6),
                )
            obs.metrics.counter("etl.stages").inc()
            obs.metrics.counter("etl.tasks_dispatched").inc(len(reads))
            obs.metrics.counter("etl.compiled_dispatches").inc()
            return results  # type: ignore[return-value]
        finally:
            if admission is not None:
                admission.release(ticket)
            if hook is not None:
                with self._inflight_lock:
                    self._inflight -= 1

    def _run_exchange_program(
        self, program, reads: List[T.ReadSpec], binding
    ) -> List[T.TaskResult]:
        if len(self.executors) == 1 and self.compiled_dispatch:
            out = self._dispatch_plan_exchange(program, reads, binding)
            if out is not None:
                return out
        return self._run_exchange_staged(program, reads, binding)

    def _dispatch_plan_exchange(
        self, program, reads: List[T.ReadSpec], binding
    ) -> Optional[List[T.TaskResult]]:
        """Single-executor pools run the whole map→reduce graph from ONE
        run_plan dispatch (the generalization of run_shuffle to compiled
        programs). Falls back to the staged path on any delivery
        failure. Side-effect parity with submit(): scale hook consulted
        pre-dispatch, inflight guard held across the dispatch."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.etl import program as P  # noqa: F401 - via _await_plan

        hook = self.scale_hook
        if hook is not None:
            try:
                hook(len(reads))
            except Exception:
                from raydp_tpu_torch.obs import metrics

                metrics.counter("etl.scale_hook_failures").inc()
            if len(self.executors) != 1:
                return None  # pool grew: fused single-dispatch no longer applies
        b = {**binding, "reads": reads, "indices": list(range(len(reads)))}
        admission = getattr(self, "admission", None)
        ticket = (
            admission.acquire(len(reads) + program.num_reducers)
            if admission is not None
            else None
        )
        if hook is not None:
            with self._inflight_lock:
                self._inflight += 1
        batch = None
        try:
            with obs.span(
                "etl.stage", tasks=len(reads) + program.num_reducers
            ) as stage_span:
                try:
                    batch = self._await_plan(
                        self._send_plan(0, program, b), 0, program, b
                    )
                except _ActorDied:
                    batch = None
                if batch is None:
                    stage_span.set(
                        dispatch="compiled_failed", server_seconds=0.0,
                        read_s=0.0, compute_s=0.0, emit_s=0.0,
                    )
                else:
                    map_results, out = batch
                    stage_span.set(
                        dispatch="compiled_fused",
                        server_seconds=round(
                            sum(r.server_seconds for r in map_results + out), 6
                        ),
                        read_s=round(
                            sum(r.read_seconds for r in map_results + out), 6
                        ),
                        compute_s=round(
                            sum(r.compute_seconds for r in map_results + out),
                            6,
                        ),
                        emit_s=round(
                            sum(r.emit_seconds for r in map_results + out), 6
                        ),
                    )
        finally:
            if admission is not None:
                admission.release(ticket)
            if hook is not None:
                with self._inflight_lock:
                    self._inflight -= 1
        if batch is None:
            return None
        map_results, out = batch
        obs.metrics.counter("etl.stages").inc()
        obs.metrics.counter("etl.tasks_dispatched").inc(
            len(reads) + program.num_reducers
        )
        obs.metrics.counter("etl.fused_exchanges").inc()
        obs.metrics.counter("etl.compiled_dispatches").inc()
        # lineage: deferred makers for both rounds (zero happy-path bind)
        if self.lineage_recovery and getattr(self, "lineage", None) is not None:
            for j, res in enumerate(map_results):
                def _make_map(j=j, program=program, b=b):
                    from raydp_tpu_torch.etl import program as _P

                    return _P.build_exchange_stages(program, b)[0][j]

                self.lineage.record_maker(_make_map, res)
            for r, res in enumerate(out):
                def _make_red(r=r, program=program, b=b, map_results=map_results):
                    from raydp_tpu_torch.etl import program as _P

                    _, reduce_spec = _P.build_exchange_stages(program, b)
                    reads2 = T.build_shuffle_reads(
                        map_results, program.num_reducers,
                        program.child_schema_ipc,
                    )
                    return reduce_spec(r, reads2[r])

                self.lineage.record_maker(_make_red, res)
        blocks = [
            blk for res in map_results for blk in res.blocks if blk is not None
        ]
        obs.instant(
            "etl.shuffle",
            map_tasks=len(reads),
            reducers=program.num_reducers,
            blocks=len(blocks),
            bytes=sum(blk.size for blk in blocks),
            indexed=bool(
                program.map_out.kind.endswith("_split")
                and binding.get("indexed", True)
            ),
            dispatch="compiled",
            reduce_start_lag_s=0.0,
        )
        self._delete_blocks(blocks)
        return out

    def _run_exchange_staged(
        self, program, reads: List[T.ReadSpec], binding
    ) -> List[T.TaskResult]:
        """Multi-executor (or fallback) execution of a compiled exchange:
        the barrier-free launcher, with every piece — map specs, reduce
        prototypes, schemas — prebuilt by the compiler instead of re-lowered
        per query."""
        from raydp_tpu_torch.etl import program as P

        b = {**binding, "reads": reads, "indices": list(range(len(reads)))}
        map_specs, reduce_spec = P.build_exchange_stages(program, b)
        launcher = _ReduceLauncher(
            self,
            program.num_reducers,
            lambda r, side_reads: reduce_spec(r, side_reads[0]),
        )
        side = launcher.add_side_ipc(program.child_schema_ipc)
        launcher.begin_side(side, len(map_specs))
        map_results = self.submit(map_specs, on_result=launcher.observer(side))
        out = launcher.gather()
        launcher.emit_stats(indexed=bool(map_specs[0].output.indexed_splits))
        self._cleanup_intermediate(map_results)
        return out


class _ReduceLauncher:
    """Barrier-free reduce start: per-reducer readiness tracked from
    streamed map-completion notifications (``planner.submit``'s
    ``on_result`` feed). The reduce round's tasks are DISPATCHED from inside
    the map stage's gather loop the instant the last input slice is
    registered — the driver never runs a post-stage barrier (transpose
    reads → locality lookup → dispatch) between the rounds. Multi-side
    exchanges (join) share one launcher: a reducer launches only when EVERY
    side's inputs are complete, and the sides' map stages may stream in
    from concurrent threads."""

    def __init__(self, planner: Planner, num_reducers: int, spec_fn):
        from raydp_tpu_torch.sanitize import named_lock

        self.planner = planner
        self.n = num_reducers
        self.spec_fn = spec_fn  # (r, [ReadSpec per side]) -> TaskSpec
        # class-wide lockdep key: every launcher instance shares one node
        self._lock = named_lock("planner.reduce_launcher")
        self._sides: List[dict] = []
        self._launched = False
        self._aborted = False
        self.specs: Optional[List[T.TaskSpec]] = None
        self.futures: Optional[List[Optional[Any]]] = None
        self.last_map_t: Optional[float] = None
        self.dispatch_t: Optional[float] = None

    def add_side(self, schema: pa.Schema) -> int:
        return self.add_side_ipc(T.schema_ipc_bytes(schema))

    def add_side_ipc(self, schema_ipc: bytes) -> int:
        """Register a side by its already-serialized schema (compiled
        programs carry schema IPC bytes; no re-serialization per query)."""
        self._sides.append(
            {
                "schema_ipc": schema_ipc,
                "results": None,  # per-map slot list, filled in map order
                "seen": 0,
            }
        )
        return len(self._sides) - 1

    def begin_side(self, side: int, num_maps: int) -> None:
        with self._lock:
            if self._sides[side]["results"] is None:
                self._sides[side]["results"] = [None] * num_maps

    def observer(self, side: int):
        def on_result(i: int, result: T.TaskResult) -> None:
            self._observe(side, i, result)

        return on_result

    def _observe(self, side: int, i: int, result: T.TaskResult) -> None:
        import time

        with self._lock:
            state = self._sides[side]
            if state["results"][i] is None:
                state["seen"] += 1
            state["results"][i] = result
            if self._aborted or self._launched:
                return
            if all(
                s["results"] is not None and s["seen"] == len(s["results"])
                for s in self._sides
            ):
                self.last_map_t = time.perf_counter()
                self._launch()

    def abort(self) -> None:
        """A failing map side must not let a concurrent sibling trigger the
        reduce round over partial inputs."""
        with self._lock:
            self._aborted = True

    def _launch(self) -> None:
        """Build every reducer's reads and dispatch (lock held). All input
        slices are registered by construction — a map task's result only
        arrives after its blocks did."""
        import time

        side_reads = [
            T.build_shuffle_reads(
                s["results"] or [], self.n, s["schema_ipc"]
            )
            for s in self._sides
        ]
        self.specs = [
            self.spec_fn(r, [reads[r] for reads in side_reads])
            for r in range(self.n)
        ]
        self.futures = [None] * self.n
        self._launched = True
        if not self.planner.executors:
            return  # local mode: gather() runs the specs inline
        # host-axis locality: put each reducer where the most
        # input bytes live. One batched head RPC; None (no preference)
        # whenever the pool is single-host or the map is unavailable.
        try:
            prefs = self.planner._reduce_prefs(self.specs)
        except Exception:
            prefs = None
        self.dispatch_t = time.perf_counter()
        for r, spec in enumerate(self.specs):
            try:
                self.futures[r] = self.planner._dispatch(
                    spec, r, 0,
                    prefs[r] if prefs is not None else None,
                )
            except Exception:
                # eager dispatch is best-effort; gather()'s retry ladder
                # re-dispatches a None slot through the normal failover
                self.futures[r] = None

    def gather(self) -> List[T.TaskResult]:
        with self._lock:
            if not self._launched:
                # zero-map-task sides never stream a completion; launch with
                # whatever (empty) inputs exist so reducers still run
                self._launch()
        if not self.planner.executors:
            return self.planner.submit(self.specs)
        return self.planner.gather_predispatched(self.futures, self.specs)

    def emit_stats(self, indexed: bool) -> None:
        """One ``etl.shuffle`` instant per exchange: block count (M for
        indexed, up to M×R legacy), bytes, and the reduce start lag (time
        from the last map completion to the reduce dispatch) — collected
        into ``last_query_stats['shuffle']`` and the trace timeline."""
        from raydp_tpu_torch import obs

        results = [
            r
            for s in self._sides
            for r in (s["results"] or [])
            if r is not None
        ]
        blocks = [
            b for res in results for b in res.blocks if b is not None
        ]
        lag = (
            self.dispatch_t - self.last_map_t
            if self.dispatch_t is not None and self.last_map_t is not None
            else 0.0
        )
        obs.instant(
            "etl.shuffle",
            map_tasks=len(results),
            reducers=self.n,
            blocks=len(blocks),
            bytes=sum(b.size for b in blocks),
            indexed=bool(indexed),
            dispatch="pipelined",
            reduce_start_lag_s=round(lag, 6),
        )


class _PartialAgg:
    """Picklable map-side aggregation closure."""

    def __init__(self, keys: List[str], aggs: List[Any]):
        self.keys = keys
        self.aggs = aggs

    def __call__(self, table: pa.Table) -> pa.Table:
        return T.partial_agg(table, self.keys, self.aggs)


class _LocalDistinct:
    def __call__(self, table: pa.Table) -> pa.Table:
        return table.group_by(table.column_names, use_threads=T.arrow_threads()).aggregate([])


class _IntraShuffle:
    """Shuffle rows within a partition (random_shuffle reduce side)."""

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self, table: pa.Table) -> pa.Table:
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(table.num_rows)
        return table.take(pa.array(order))
