"""ETL executor actor.

The analog of the reference's RayDPExecutor (a Ray actor hosting a Spark
executor, RayDPExecutor.scala:194-253): a restartable actor on the cluster
runtime that runs partition tasks (tasks.py) and serves data-plane reads
concurrently (max_concurrency > 1, mirroring setMaxConcurrency(2) at
RayExecutorUtils.java:65). Blocks it produces are owned by it in the object
store, so data dies with the ETL session unless ownership was transferred —
the reference's exact GC semantics .
"""

from __future__ import annotations

import os
from typing import List, Optional

from raydp_tpu_torch.etl import tasks as T


class EtlExecutor:
    # executor-resident compiled programs (plans cached by fingerprint):
    # warm run_plan dispatches carry only the binding, not the plan
    PROGRAM_CACHE_CAP = 32

    def __init__(self, executor_id: int, app_name: str, configs: Optional[dict] = None):
        self.executor_id = executor_id
        self.app_name = app_name
        self.configs = dict(configs or {})
        self.cores = max(1, int(self.configs.get("etl.executor.cores", 1)))
        self._task_pool = None
        import collections

        from raydp_tpu_torch.sanitize import named_lock

        self._programs: "collections.OrderedDict" = collections.OrderedDict()  # guarded-by: self._programs_lock
        self._programs_lock = named_lock("etl.executor.programs")
        # keep BLAS/arrow thread pools from oversubscribing the host: each
        # executor is sized by its CPU resource, not the whole machine
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        os.environ.setdefault("ARROW_DEFAULT_THREADS", "1")
        # planner.arrow_threads: multi-core deployments opt in to arrow's
        # kernel threading on the group_by/join hot paths (default off — the
        # pools above are sized for resource-isolated executors)
        T.set_arrow_threads(
            str(self.configs.get("planner.arrow_threads", "false")).lower()
            in ("1", "true", "yes")
        )
        # head-bypass parity: a session that turns the location cache off
        # (A/B tests) must turn it off in the EXECUTOR processes too, or
        # writer-side caching would still skip the head on the reduce path
        from raydp_tpu_torch.store import object_store as _store

        _store.set_location_cache(
            str(self.configs.get("planner.head_bypass", "true")).lower()
            in ("1", "true", "yes")
        )
        # block-service handoff (store/block_service.py): THIS process's
        # registrations flag completed blocks for per-host service ownership
        # — executor death then loses zero blocks. Conf-off (the A/B arm)
        # must reach executors too, or their writes would still hand off.
        _store.set_block_service(
            str(self.configs.get("store.block_service", "true")).lower()
            in ("1", "true", "yes")
        )
        # tenant block namespace (raydp_tpu_torch.tenancy): an executor belongs to
        # exactly one session, so every block this PROCESS writes mints a
        # tenant-prefixed object id — head-side accounting/quota and the
        # per-tenant GC/block-service keying follow from the id alone.
        # Empty (tenancy off / pre-tenancy session) = unprefixed ids,
        # byte-identical to the old behavior.
        _store.set_tenant_namespace(
            str(self.configs.get("tenancy.namespace", "") or "")
        )
        self._warm_up()

    def _pool(self):
        if self._task_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._task_pool = ThreadPoolExecutor(max_workers=self.cores)
        return self._task_pool

    def _warm_up(self) -> None:
        """Pay the one-time costs at SPAWN (overlapped across the pool,
        outside any query's clock) instead of inside the first task: arrow's
        compute-kernel and IPC machinery init and the native store library
        load cost tens of ms cold — measured ~40ms of the first task's
        chain and ~30ms of its first block write. The store round trip runs
        on a run_tasks pool thread so the pooled head connection it opens
        is the one batched dispatches reuse (RPC pools are thread-local; a
        connection warmed on this constructor thread would idle forever).
        Best-effort: a warm-up failure must never fail spawn."""
        try:
            import numpy as np
            import pyarrow as pa
            import pyarrow.compute as pc

            ts = pa.array(
                np.arange(4, dtype="int64"), pa.int64()
            ).cast(pa.timestamp("s"))
            col = pa.array(np.arange(4, dtype=np.float64))
            pc.hour(ts)
            pc.day_of_week(ts)
            pc.sqrt(pc.add(pc.multiply(col, col), col))
            pc.cast(col, pa.float32(), safe=False)
            table = pa.table({"x": col})

            def _store_round_trip():
                # loads the native store lib, touches the spill probe, opens
                # the pool thread's persistent head connection, and
                # initializes the IPC stream writer/reader paths
                from raydp_tpu_torch.store import object_store as store

                ref, _ = T.write_table_block(table)
                T.read_table_block(ref)
                store.delete([ref])

            self._pool().submit(_store_round_trip).result(timeout=30)
        except Exception:  # warm-up is opportunistic; cost returns to the first task
            pass  # cold-start costs return to the first task, nothing else

    def ping(self) -> int:
        return self.executor_id

    def _run_one(self, spec: T.TaskSpec) -> T.TaskResult:
        from raydp_tpu_torch import obs

        # the executor.task span both feeds server_seconds (query stats) and
        # lands on this executor's trace track, parented under the driver's
        # stage span (the context rode in on the RPC frame)
        with obs.collect():
            with obs.span(
                "executor.task", executor=self.executor_id,
                partition=spec.partition_index,
            ) as s:
                result = T.run_task(spec)
        result.server_seconds = s.duration
        return result

    @staticmethod
    def _ship_telemetry() -> None:
        """End-of-dispatch ship point. Unthrottled when tracing is on:
        executors die by SIGKILL at session stop, so a throttled-away tail
        flush would lose the final dispatch's spans for good. Metrics-only
        pushes (tracing off) stay throttled."""
        from raydp_tpu_torch import obs

        if obs.enabled():
            obs.flush()
        else:
            obs.flush_throttled()

    def run_task(self, spec: T.TaskSpec) -> T.TaskResult:
        result = self._run_one(spec)
        self._ship_telemetry()
        return result

    def run_tasks(self, specs: List[T.TaskSpec]) -> List[T.TaskResult]:
        """One-dispatch batch entry point: the whole stage slice for this
        executor arrives in a single RPC and fans out over ``cores``
        threads here (arrow kernels release the GIL), replacing one actor
        round trip per task."""
        from raydp_tpu_torch import obs

        if len(specs) <= 1 or self.cores <= 1:
            results = [self._run_one(s) for s in specs]
        else:
            # trace context is thread-local: hand the dispatch RPC's context
            # to the pool threads so their task spans link under the stage
            ctx = obs.current_context()
            results = list(
                self._pool().map(
                    lambda s: obs.with_context(ctx, self._run_one, s), specs
                )
            )
        self._ship_telemetry()
        return results

    def _fanout(self, specs: List[T.TaskSpec]) -> List[T.TaskResult]:
        """Run a spec list over the task pool (arrow kernels release the
        GIL), propagating the dispatch RPC's trace context to pool threads
        so task spans link under the driver's stage span."""
        from raydp_tpu_torch import obs

        if len(specs) <= 1 or self.cores <= 1:
            return [self._run_one(s) for s in specs]
        ctx = obs.current_context()
        return list(
            self._pool().map(
                lambda s: obs.with_context(ctx, self._run_one, s), specs
            )
        )

    def run_shuffle(
        self,
        map_specs: List[T.TaskSpec],
        reduce_protos: List[T.TaskSpec],
        schema_ipc: bytes,
        num_reducers: int,
    ):
        """Fused map→reduce exchange in ONE dispatch: when every partition
        of a shuffle is co-located on this executor (single-executor pools),
        the driver round trip between the rounds buys nothing — run the map
        tasks, transpose their outputs into per-reducer reads LOCALLY, and
        run the reduce tasks, all inside this one RPC. ``reduce_protos`` are
        complete reduce TaskSpecs except for their (placeholder) primary
        read, filled here from the map results. Returns
        ``(map_results, reduce_results)`` — the driver still owns cleanup
        of the intermediate blocks."""
        map_results = self._fanout(map_specs)
        reads = T.build_shuffle_reads(map_results, num_reducers, schema_ipc)
        for r, proto in enumerate(reduce_protos):
            proto.reads = [reads[r]]
        reduce_results = self._fanout(reduce_protos)
        self._ship_telemetry()
        return map_results, reduce_results

    def run_plan(self, program_id: str, binding: dict, program_blob=None):
        """Whole-plan compiled dispatch: run a CompiledProgram — narrow
        stage, or a full map→shuffle→reduce exchange — in ONE RPC. The
        program body (``program_blob``, pre-pickled by the driver at
        compile) ships only on first delivery; afterwards it is EXECUTOR-
        RESIDENT, keyed by its plan fingerprint, and warm dispatches carry
        just the binding (block refs, literal values, output owner).
        Raises ``ProgramCacheMiss`` when asked to run an id this executor
        no longer holds (LRU eviction / restart) — the driver re-sends the
        body once."""
        from raydp_tpu_torch.etl import program as P

        with self._programs_lock:
            program = self._programs.get(program_id)
            if program is not None:
                self._programs.move_to_end(program_id)
        if program is None:
            if program_blob is None:
                raise P.ProgramCacheMiss(program_id)
            import cloudpickle

            program = cloudpickle.loads(program_blob)
            with self._programs_lock:
                self._programs[program_id] = program
                self._programs.move_to_end(program_id)
                while len(self._programs) > self.PROGRAM_CACHE_CAP:
                    self._programs.popitem(last=False)
        result = P.execute_program(program, binding, self._fanout)
        self._ship_telemetry()
        return result

    def decode_segment(
        self, ref, start: int, stop: int, feature_groups, label_column,
        label_dtype,
    ):
        """Streaming-ingest segment decode (Arrow → numpy) in THIS process:
        the training driver's block-stream iterator dispatches the per-span
        decode here so its consumer thread only sequences uploads (the
        executor reads the block shm-local; the decoded arrays ride the RPC
        reply). See ``tasks.decode_segment``."""
        from raydp_tpu_torch import obs

        with obs.collect():
            with obs.span(
                "executor.decode", executor=self.executor_id,
                rows=max(0, int(stop) - int(start)),
            ):
                out = T.decode_segment(
                    ref, start, stop, feature_groups, label_column,
                    label_dtype,
                )
        obs.metrics.counter("etl.decode_tasks").inc()
        self._ship_telemetry()
        return out

    # -- data plane (exchange layer reads) --

    def get_block_ipc(self, ref) -> bytes:
        """Materialize a block as IPC bytes (for cross-node pulls; local
        readers map shared memory directly instead)."""
        return T.table_to_ipc_bytes(T.read_table_block(ref))

    def recompute_block(self, spec: T.TaskSpec) -> T.TaskResult:
        """Recoverable-conversion hook: re-run the producing task (parity:
        RecacheRDD re-materialization, reference RayDPDriverAgent.scala:59-71)."""
        return T.run_task(spec)
