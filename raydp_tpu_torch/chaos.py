"""Chaos harness of the port: its copy of the repository's
``tools/chaos.py``, making executor, block-service, replica and host failure
boring.

Each scenario SIGKILLs something mid-work (an intentional kill: the head
unregisters the victim's blocks, so the loss is real, unlike a restartable
crash whose shared memory survives) and asserts that the query, fit or
request stream completes with a result bitwise an unkilled run's:

- the lineage tier (``LINEAGE_ARM``, ``store.block_service=false``:
  executor-owned blocks, recovery re-executes): ``scenario_mid_shuffle``,
  ``scenario_mid_compiled`` and ``scenario_mid_fit`` (the streamed fit of
  ``MLPRegressor``, its fitted ``state_dict()`` compared with
  ``torch.equal`` on the device it was fitted on), each with at least one
  re-executed task, within its bound;
- the block-service tier: ``scenario_executor_kill_with_service`` (the
  service owns every block, so an executor's death re-executes nothing)
  and ``scenario_service_kill_lineage_fallback`` (the service itself
  killed: real loss, recovered through lineage);
- ``scenario_elasticity``: scale-out timed (``scale_out_warm`` reported,
  not gated), then scale-in of a block-holding executor losing no data;
- ``scenario_tenant_kill_isolation``: two tenants on one cluster; tenant
  A's block holder killed while B's query runs, B's result bitwise its
  clean run with nothing re-executed for it;
- the serving tier: ``scenario_replica_kill_during_load`` and
  ``scenario_replica_kill_during_decode`` (zero dropped requests, bitwise
  responses and tokens, the pool healed);
- ``scenario_host_death``: a node agent with its own shared-memory
  namespace stands in for a second host; every actor on it is killed
  mid-query; its executor-owned blocks come back through lineage while the
  surviving host's service-owned blocks re-execute nothing. The agent is
  stopped and gone when the scenario returns.

The runner (``run``) arms the sanitizers
(``RAYDP_TPU_SANITIZE=donation,lockdep,leaks-strict`` by default) and gates
on them: no stranded thread after any scenario, and a clean strict leak
audit at the final ``cluster.shutdown()``. The scenario names, their
arguments, the report keys, the gates and the bounds are the chaos tool's,
so the two verdicts compare key for key; a scenario that runs a model also
takes ``device`` (None = the card, ``"cpu"`` in tests). Run it::

    python -m raydp_tpu_torch.chaos --quick --seed 7 --json chaos_report.json
    python -m raydp_tpu_torch.chaos --quick --device cpu   # no card

``--quick`` runs the CI slice (mid-shuffle and mid-fit, both block-service
tiers, the tenant kill, both replica kills and the host death); without it
all ten run (adding the compiled-dispatch kill and the elasticity round
trip). ``--device`` places the models: the card by default, which raises
before any session starts when there is none; ``--device cpu`` runs them
on the CPU. The exit code is non-zero when any query went
unrecovered or any sanitizer finding surfaced.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import random
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional

# --seed of the chaos tool: deterministic victim and timing selection.
# Unseeded (None) keeps the fixed choices (index 0, exact delays).
RNG: Optional[random.Random] = None


def set_seed(seed: Optional[int]) -> None:
    global RNG
    RNG = None if seed is None else random.Random(seed)


def pick_index(n: int) -> int:
    """Seeded victim index over an n-member pool (0 when unseeded)."""
    if RNG is None or n <= 1:
        return 0
    return RNG.randrange(n)


def jittered(delay_s: float) -> float:
    """Seeded timing jitter for delayed kills (the exact delay when
    unseeded): the kill lands in a different window per seed."""
    if RNG is None:
        return delay_s
    return delay_s * (0.5 + RNG.random())


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def kill_executor(session, handle=None, index: int = 0):
    """SIGKILL one executor with NO restart, the real-loss primitive: the
    head unregisters its blocks and unlinks their segments, so a surviving
    reference comes back only through lineage recovery. The dead owner is
    noted in the store, so stale cached locations fail fast. Returns the
    victim's handle."""
    from raydp_tpu_torch.store import object_store as store

    victim = handle if handle is not None else session.executors[index]
    victim.kill(no_restart=True)
    store.note_owner_dead(victim._actor_id)
    return victim


def delayed_kill(session, delay_s: float,
                 index: Optional[int] = 0) -> threading.Thread:
    """A timer thread that SIGKILLs an executor mid-whatever-is-running
    (``index=None``: a seeded pick when it fires; the delay is jittered
    either way). Join it after the workload."""

    def _fire():
        time.sleep(jittered(delay_s))
        try:
            victim = index
            if victim is None:
                victim = pick_index(len(session.executors))
            kill_executor(session, index=victim)
        except Exception:  # the victim may already be gone, racing teardown
            pass

    thread = threading.Thread(target=_fire, name="chaos-killer", daemon=True)
    thread.start()
    return thread


def kill_service(session):
    """SIGKILL the session's block service with NO restart: the head
    unregisters and unlinks every block it owns, so surviving references
    come back through lineage. Returns the dead service's handle."""
    from raydp_tpu_torch.store import object_store as store

    victim = session.block_service
    if victim is None:
        raise RuntimeError("session has no block service (conf off?)")
    victim.kill(no_restart=True)
    store.note_owner_dead(victim._actor_id)
    return victim


def block_owner_executor(session, ds):
    """An executor that owns at least one of the dataset's blocks (killing
    it makes the loss real), or None."""
    from raydp_tpu_torch.store import object_store as store

    owners = {store.owner_of(b) for b in ds.blocks}
    for handle in session.executors:
        if handle._actor_id in owners:
            return handle
    return None


def lineage_counters() -> dict:
    """The port's lineage counters in this process's obs registry."""
    from raydp_tpu_torch.obs.metrics import metrics

    return {
        "reexecuted_tasks": int(
            metrics.counter("lineage.reexecuted_tasks").value),
        "recovered_blocks": int(
            metrics.counter("lineage.recovered_blocks").value),
    }


def sanitizer_report() -> dict:
    """This process's leak inventory from the port's sanitizer (the
    cluster-wide audit runs at shutdown)."""
    from raydp_tpu_torch import sanitize

    if not sanitize.leaks_enabled():
        return {"enabled": False}
    report = sanitize.leak_report()
    return {
        "enabled": True,
        "shm": len(report["shm"]),
        "spill": len(report["spill"]),
        "fds": report["fds"],
        "threads": report["threads"],
    }


def _fresh_session(name: str, executors: int = 2, configs: Optional[dict] = None):
    from raydp_tpu_torch.etl.session import init_etl

    return init_etl(name, num_executors=executors, executor_cores=1,
                    executor_memory="300M", configs=configs)



# the stream scenarios' LM (tools/chaos.py's): f32, attn_impl="flash", so
# its prefill and decode run the f32 kernels at head dim 32 / 2 = 16
DECODE_LM = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
                 max_len=256)


# executor-OWNED blocks, so an executor's SIGKILL is real loss and lineage
# recovery is the only way back: the lineage scenarios pin it, since the
# block service (on by default) makes executor death lose nothing
LINEAGE_ARM = {"store.block_service": "false"}


def _etl():
    from raydp_tpu_torch.etl import functions as F
    from raydp_tpu_torch.etl.session import stop_etl
    from raydp_tpu_torch.exchange.dataset import (
        dataframe_to_dataset, dataset_to_dataframe,
    )

    return F, stop_etl, dataframe_to_dataset, dataset_to_dataframe


def _counts(df):
    return df.group_by("k").count().sort("k").collect()


def scenario_mid_shuffle(rows: int = 120_000) -> dict:
    """Kill a block-holding executor between a shuffle's rounds (the map
    outputs exist, the reduce has not read them) and while a whole query is
    in flight (a timed kill)."""
    F, stop_etl, to_dataset, to_frame = _etl()
    session = _fresh_session("chaos-shuffle", configs=LINEAGE_ARM)
    try:
        # deterministic half: the shuffle's executor-owned SOURCE blocks
        # are lost, and its map round recovers them through lineage
        src = session.range(rows, num_partitions=8).with_column(
            "k", F.col("id") % 13)
        ds = to_dataset(src)
        df = to_frame(session, ds)
        clean = _counts(df)
        before = lineage_counters()
        kill_executor(session, handle=block_owner_executor(session, ds))
        time.sleep(0.3)
        chaos = _counts(df)
        session.request_total_executors(2)  # restore the pool

        # racing half: the kill lands wherever it lands; seeded runs sweep
        # the window (victim and delay)
        killer = delayed_kill(session, 0.05, index=None)
        chaos2 = _counts(df)
        killer.join()
        session.request_total_executors(2)

        after = lineage_counters()
        reexecuted = after["reexecuted_tasks"] - before["reexecuted_tasks"]
        identical = chaos == clean and chaos2 == clean
        # at most one map round (8 tasks) per production level (the lost
        # blocks' sources too: two levels) per kill (two)
        bound = 32
        return {
            "name": "mid_shuffle_kill",
            "ok": bool(identical and reexecuted >= 1),
            "byte_identical": bool(identical),
            "reexecuted_tasks": reexecuted,
            "reexecution_bound": bound,
            "within_bound": reexecuted <= bound,
        }
    finally:
        stop_etl()


def scenario_mid_compiled(rows: int = 50_000) -> dict:
    """Kill the owner of a materialized dataset's blocks, then run a
    compiled (plan-cache) query over it: the compiled dispatch's lost-block
    fallback recovers through lineage and runs again."""
    F, stop_etl, to_dataset, to_frame = _etl()
    session = _fresh_session("chaos-compiled", configs=LINEAGE_ARM)
    try:
        src = session.range(rows, num_partitions=4).with_column(
            "x", F.col("id") * 3)
        ds = to_dataset(src)
        df = to_frame(session, ds)
        clean = df.filter(F.col("x") % 2 == 0).count()
        before = lineage_counters()

        victim = block_owner_executor(session, ds)
        assert victim is not None
        kill_executor(session, handle=victim)
        time.sleep(0.5)
        chaos = df.filter(F.col("x") % 2 == 0).count()
        session.request_total_executors(2)

        after = lineage_counters()
        reexecuted = after["reexecuted_tasks"] - before["reexecuted_tasks"]
        return {
            "name": "mid_compiled_dispatch_kill",
            "ok": chaos == clean and reexecuted >= 1,
            "byte_identical": chaos == clean,
            "reexecuted_tasks": reexecuted,
            "reexecution_bound": 4,
            "within_bound": reexecuted <= 4,
        }
    finally:
        stop_etl()


def scenario_mid_fit(rows: int = 2048, device=None,
                     fits: Optional[list] = None) -> dict:
    """SIGKILL the executor owning the training blocks before a streamed fit
    of ``MLPRegressor`` (its published widths) reads them: the fit's block
    reads recover through lineage while it runs, and its fitted
    ``state_dict()`` must be bitwise an unkilled fit's (``torch.equal`` on
    the device they were fitted on). ``fits``, where given, receives both
    fits' ``state_dict()``s, the clean one first."""
    import numpy as np
    import pandas as pd
    import torch

    F, stop_etl, to_dataset, _ = _etl()

    def _fit(session, ds, kill: bool) -> dict:
        from raydp_tpu_torch.estimator import Estimator
        from raydp_tpu_torch.models.mlp import MLPRegressor

        est = Estimator(
            model=functools.partial(MLPRegressor, 2), optimizer="adam",
            loss="mse", feature_columns=["a", "b"], label_column="y",
            batch_size=256, num_epochs=2, learning_rate=1e-3, shuffle=True,
            seed=0, streaming=True, device=device,
        )
        if kill:
            # lose the blocks FOR REAL before the stream starts: its block
            # reads then recover WHILE it runs (a timed kill on data this
            # small usually lands after the last read and proves nothing)
            victim = block_owner_executor(session, ds)
            if victim is not None:
                kill_executor(session, handle=victim)
                time.sleep(0.3)
        est.fit(ds)
        return {k: v.detach().clone()
                for k, v in est.get_model().state_dict().items()}

    session = _fresh_session("chaos-fit", configs=LINEAGE_ARM)
    try:
        rng = np.random.default_rng(3)
        pdf = pd.DataFrame({
            "a": rng.random(rows).astype(np.float32),
            "b": rng.random(rows).astype(np.float32),
        })
        pdf["y"] = 2 * pdf["a"] + 3 * pdf["b"]
        df = session.from_pandas(pdf, num_partitions=4)
        # materialized through the EXECUTORS, so the blocks are
        # executor-owned (a from_pandas source is the driver's: killing an
        # executor would lose nothing); the repartition keeps the rows
        ds = to_dataset(df.repartition(4))
        clean = _fit(session, ds, kill=False)
        before = lineage_counters()
        chaos = _fit(session, ds, kill=True)
        session.request_total_executors(2)
        after = lineage_counters()
        if fits is not None:
            fits.extend([clean, chaos])
        identical = clean.keys() == chaos.keys() and all(
            torch.equal(clean[k], chaos[k]) for k in clean)
        reexecuted = after["reexecuted_tasks"] - before["reexecuted_tasks"]
        return {
            "name": "mid_streaming_fit_kill",
            "ok": bool(identical and reexecuted >= 1),
            "byte_identical": bool(identical),
            "reexecuted_tasks": reexecuted,
            "reexecution_bound": 8,
            "within_bound": reexecuted <= 8,
        }
    finally:
        stop_etl()


def scenario_elasticity() -> dict:
    """Scale-out (a warm zygote fork, timed), then scale-in of a
    block-holding executor: no query may lose data."""
    F, stop_etl, to_dataset, _ = _etl()
    session = _fresh_session("chaos-elastic", executors=1)
    try:
        t0 = time.perf_counter()
        session.request_total_executors(2)
        scale_out_s = time.perf_counter() - t0
        # materialized AFTER the scale-out so both executors produce
        # blocks; kill_executors takes the pool's tail (the new executor),
        # and with the block service on the data survives: the victim
        # never owned it
        df = session.range(20_000, num_partitions=4).with_column(
            "v", F.col("id") + 1)
        ds = to_dataset(df)
        expected = ds.count()
        session.kill_executors(1, min_keep=1)
        survived = ds.to_arrow().num_rows == expected
        ok = survived and len(session.executors) >= 1
        return {
            "name": "elastic_round_trip",
            "ok": bool(ok),
            "scale_out_s": round(scale_out_s, 3),
            "scale_out_warm": scale_out_s < 1.0,  # reported, not gated
            "data_survived_scale_in": bool(survived),
        }
    finally:
        stop_etl()


def scenario_executor_kill_with_service(rows: int = 120_000) -> dict:
    """The block-service tier's contract: with ``store.block_service`` on
    (the default), an executor SIGKILL mid-shuffle loses ZERO blocks (the
    per-host service owns every completed block) and the query completes
    bitwise with ``lineage.reexecuted_tasks == 0`` (tasks in flight on the
    victim go again through the retry ladder, which is not lineage
    re-execution). A kill between queries and a timed kill mid-query."""
    F, stop_etl, to_dataset, to_frame = _etl()
    session = _fresh_session("chaos-exec-svc")
    try:
        src = session.range(rows, num_partitions=8).with_column(
            "k", F.col("id") % 13)
        ds = to_dataset(src)
        # the blocks belong to the SERVICE, not to an executor: else this
        # scenario would test the lineage arm
        service_owned = block_owner_executor(session, ds) is None
        df = to_frame(session, ds)
        clean = _counts(df)
        before = lineage_counters()

        kill_executor(session, index=pick_index(len(session.executors)))
        time.sleep(0.3)
        chaos = _counts(df)
        session.request_total_executors(2)

        killer = delayed_kill(session, 0.05, index=None)
        chaos2 = _counts(df)
        killer.join()
        session.request_total_executors(2)

        after = lineage_counters()
        reexecuted = after["reexecuted_tasks"] - before["reexecuted_tasks"]
        identical = chaos == clean and chaos2 == clean
        return {
            "name": "executor_kill_with_service",
            "ok": bool(identical and service_owned and reexecuted == 0),
            "byte_identical": bool(identical),
            "service_owned": bool(service_owned),
            # THE gate: executor death costs zero re-executed tasks
            "reexecuted_tasks": reexecuted,
            "reexecution_bound": 0,
            "within_bound": reexecuted == 0,
        }
    finally:
        stop_etl()


def scenario_service_kill_lineage_fallback(rows: int = 60_000) -> dict:
    """The fallback tier: SIGKILL the block SERVICE itself (no restart: the
    head unregisters and unlinks every block it owns, real loss) between
    queries and mid-query; lineage brings the results back bitwise."""
    F, stop_etl, to_dataset, to_frame = _etl()
    session = _fresh_session("chaos-svc-kill")
    try:
        src = session.range(rows, num_partitions=8).with_column(
            "k", F.col("id") % 13)
        ds = to_dataset(src)
        df = to_frame(session, ds)
        clean = _counts(df)
        before = lineage_counters()

        # deterministic half: the service and its blocks die between
        # queries; the next query's reads raise OwnerDiedError and lineage
        # re-executes the producing tasks on the live executors
        kill_service(session)
        time.sleep(0.3)
        chaos = _counts(df)

        # racing half: a fresh session (the dead service released its
        # name), the service killed WHILE a query is in flight
        stop_etl()
        session = _fresh_session("chaos-svc-kill-2")
        src2 = session.range(rows, num_partitions=8).with_column(
            "k", F.col("id") % 13)
        ds2 = to_dataset(src2)
        df2 = to_frame(session, ds2)
        clean2 = _counts(df2)

        def _fire():
            time.sleep(jittered(0.05))
            try:
                kill_service(session)
            except Exception:  # racing the scenario's teardown
                pass

        killer = threading.Thread(target=_fire, daemon=True)
        killer.start()
        chaos2 = _counts(df2)
        killer.join()

        after = lineage_counters()
        reexecuted = after["reexecuted_tasks"] - before["reexecuted_tasks"]
        identical = chaos == clean and chaos2 == clean2
        # the deterministic half re-executes at most one map round and one
        # source level (8 x 2); the racing half may lose blocks or not,
        # as the kill lands: the same allowance
        bound = 32
        return {
            "name": "service_kill_lineage_fallback",
            "ok": bool(identical and reexecuted >= 1),
            "byte_identical": bool(identical),
            "reexecuted_tasks": reexecuted,
            "reexecution_bound": bound,
            "within_bound": reexecuted <= bound,
        }
    finally:
        stop_etl()


def scenario_tenant_kill_isolation(rows: int = 60_000) -> dict:
    """The multi-tenant blast radius: two tenants share ONE cluster;
    tenant A's block-holding executor is SIGKILLed (A runs the lineage arm,
    so the loss is real) while tenant B's query runs concurrently. Gates:
    B's result bitwise its clean run with ``reexecuted_tasks == 0`` in its
    own query's ``last_query_stats['recovery']``, and A recovered bitwise
    through lineage with at least one re-executed task."""
    from raydp_tpu_torch import tenancy
    from raydp_tpu_torch.etl.session import init_etl

    F, _, to_dataset, to_frame = _etl()
    session_a = _fresh_session("chaos-ten-a", configs=dict(LINEAGE_ARM))
    session_b = None
    try:
        session_b = init_etl("chaos-ten-b", num_executors=1,
                             executor_cores=1, executor_memory="300M")
        src_a = session_a.range(rows, num_partitions=8).with_column(
            "k", F.col("id") % 13)
        ds_a = to_dataset(src_a)
        df_a = to_frame(session_a, ds_a)
        src_b = session_b.range(rows // 2, num_partitions=4).with_column(
            "k", F.col("id") % 7)
        ds_b = to_dataset(src_b)
        df_b = to_frame(session_b, ds_b)
        with tenancy.use_session(session_a):
            clean_a = _counts(df_a)
        with tenancy.use_session(session_b):
            clean_b = _counts(df_b)

        kill_executor(session_a, handle=block_owner_executor(session_a, ds_a))
        time.sleep(0.3)

        b_out: dict = {}

        def run_b():
            with tenancy.use_session(session_b):
                try:
                    b_out["result"] = _counts(df_b)
                    b_out["recovery"] = dict(
                        session_b.last_query_stats.get("recovery", {}))
                except Exception as exc:  # noqa: BLE001 - the gate reports it
                    b_out["error"] = repr(exc)[:300]

        thread_b = threading.Thread(target=run_b, name="tenant-b-query")
        thread_b.start()
        before = lineage_counters()
        with tenancy.use_session(session_a):
            chaos_a = _counts(df_a)
        after = lineage_counters()
        thread_b.join(timeout=120)
        session_a.request_total_executors(2)

        a_reexecuted = after["reexecuted_tasks"] - before["reexecuted_tasks"]
        a_identical = chaos_a == clean_a
        b_identical = b_out.get("result") == clean_b
        b_reexecuted = int(b_out.get("recovery", {}).get("reexecuted_tasks", -1))
        ok = bool(a_identical and a_reexecuted >= 1 and b_identical
                  and b_reexecuted == 0 and "error" not in b_out)
        entry = {
            "name": "tenant_kill_isolation",
            "ok": ok,
            "victim_tenant_byte_identical": bool(a_identical),
            "victim_tenant_reexecuted_tasks": a_reexecuted,
            "other_tenant_byte_identical": bool(b_identical),
            # THE gate: the co-tenant's concurrent query pays ZERO recovery
            "other_tenant_reexecuted_tasks": b_reexecuted,
        }
        if "error" in b_out:
            entry["other_tenant_error"] = b_out["error"]
        return entry
    finally:
        if session_b is not None:
            session_b.stop()
        session_a.stop()


def _stop_agent(info: dict) -> None:
    """Retire a node agent this process started: the head forgets the node
    and kills its actors, the agent stops, and its process is reaped."""
    from raydp_tpu_torch.cluster import api as cluster_api
    from raydp_tpu_torch.cluster.common import rpc

    try:
        cluster_api.remove_node(info["node_id"])
    except Exception:  # the node may already be gone
        pass
    try:
        rpc(info["addr"], ("stop", {}), timeout=5)
    except Exception:  # an agent already exiting closes its socket
        pass
    for proc in list(cluster_api._agent_procs):
        if proc.pid == info["pid"]:
            try:
                proc.wait(timeout=30)
            except Exception:  # past its grace: no agent may outlive this
                proc.kill()
                proc.wait(timeout=10)
            cluster_api._agent_procs.remove(proc)


def scenario_host_death(rows: int = 60_000) -> dict:
    """SIGKILL every actor sharing one SIMULATED host mid-query (the
    cross-host plane's whole-box failure). A node agent with its own shared
    memory namespace stands in for the second host: its executors' blocks
    live where nobody else can map them, so its death is real loss and
    recovery comes through lineage on the surviving host, whose blocks the
    block service owns and which must come back without a re-executed
    task. Gate: the queries after the deaths bitwise, re-execution >= 1
    and bounded, the service's ownership intact. The agent and its actors
    are gone when the scenario returns."""
    from raydp_tpu_torch.cluster import api as cluster_api
    from raydp_tpu_torch.etl.session import init_etl
    from raydp_tpu_torch.store import object_store as store

    F, stop_etl, to_dataset, to_frame = _etl()
    if not cluster_api.is_initialized():
        cluster_api.init(num_cpus=4, memory=4 << 30)
    # executors sized from the head's LIVE free CPUs, so the second cannot
    # fit on the head node and lands on the simulated host
    head_node = next(
        n for n in cluster_api.nodes() if n.agent_addr is None and n.alive)
    head_free = cluster_api.available_resources()[head_node.node_id].get(
        "CPU", 0.0)
    cores = int(head_free // 2 + 1)
    info = cluster_api.start_node_agent(
        {"CPU": float(cores), "memory": float(1 << 30)}, shm_ns="chd")
    agent_node_id = info["node_id"]
    try:
        session = init_etl("chaos-host-death", num_executors=2,
                           executor_cores=cores, executor_memory="300M")
        victims = [h for h in session.executors
                   if h._record().node_id == agent_node_id]
        spans_hosts = 0 < len(victims) < len(session.executors)
        src = session.range(rows, num_partitions=8).with_column(
            "k", F.col("id") % 13)
        ds = to_dataset(src)
        svc_id = (session.block_service._actor_id
                  if session.block_service is not None else None)
        svc_owned = [b for b in ds.blocks if store.owner_of(b) == svc_id]
        victim_ids = {h._actor_id for h in victims}
        host_owned = [b for b in ds.blocks if store.owner_of(b) in victim_ids]
        df = to_frame(session, ds)
        clean = _counts(df)
        before = lineage_counters()

        # deterministic half: the whole simulated host dies between
        # queries (its executors; the namespace hosts no block service)
        for victim in victims:
            kill_executor(session, handle=victim)
        time.sleep(0.3)
        chaos = _counts(df)
        session.request_total_executors(2)

        # racing half: the host dies again while a query is in flight (the
        # respawned executor cannot fit on the head, so it is back there)
        victims2 = [h for h in session.executors
                    if h._record().node_id == agent_node_id]

        def _fire():
            time.sleep(jittered(0.05))
            for victim in victims2:
                try:
                    kill_executor(session, handle=victim)
                except Exception:  # racing the scenario's teardown
                    pass

        killer = threading.Thread(target=_fire, name="chaos-host-killer",
                                  daemon=True)
        killer.start()
        chaos2 = _counts(df)
        killer.join()
        session.request_total_executors(2)

        # the surviving host's service-owned blocks never left the service
        service_intact = all(store.owner_of(b) == svc_id for b in svc_owned)

        after = lineage_counters()
        reexecuted = after["reexecuted_tasks"] - before["reexecuted_tasks"]
        identical = chaos == clean and chaos2 == clean
        # one 8-task map round and one source level per host death (two);
        # the surviving host's service-owned blocks contribute zero
        bound = 32
        return {
            "name": "host_death",
            "ok": bool(identical and spans_hosts and reexecuted >= 1
                       and service_intact and len(svc_owned) >= 1
                       and len(host_owned) >= 1),
            "byte_identical": bool(identical),
            "spans_hosts": bool(spans_hosts),
            "dead_host_blocks": len(host_owned),
            "surviving_service_blocks": len(svc_owned),
            "surviving_service_intact": bool(service_intact),
            "reexecuted_tasks": reexecuted,
            "reexecution_bound": bound,
            "within_bound": reexecuted <= bound,
        }
    finally:
        stop_etl()
        _stop_agent(info)


def serve_request_stream(dep, x, n_requests: int, n_clients: int = 4):
    """Drive a FIXED single-row request list through a deployment from
    ``n_clients`` closed-loop client threads. Returns (results, errors),
    results positionally stable, so two runs of the same stream compare
    row for row."""
    results = [None] * n_requests
    errors: List[str] = []
    rows = len(x)

    def client(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            try:
                results[i] = dep.predict(x[i % rows: i % rows + 1])
            except Exception as exc:  # noqa: BLE001 - the gate counts these
                errors.append(repr(exc)[:200])

    share = max(1, n_requests // n_clients)
    workers = [
        threading.Thread(target=client,
                         args=(k * share, min(n_requests, (k + 1) * share)))
        for k in range(n_clients)
    ]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return results, errors


def serve_kill_probe(
    dep,
    x,
    n_requests: int = 160,
    kill_delay_s: float = 0.05,
    pick_victim: Optional[Callable[[], int]] = None,
    heal_timeout_s: float = 20.0,
) -> dict:
    """The serving zero-drop contract as one probe: run a fixed request
    stream clean, again with a replica SIGKILLed mid-stream
    (``pick_victim`` chooses its index when the kill fires), and gate ZERO
    dropped requests, responses bitwise the clean run's and the pool
    healed back to target."""
    import numpy as np

    from raydp_tpu_torch.obs.metrics import metrics

    target = dep.replica_count()
    clean, clean_errors = serve_request_stream(dep, x, n_requests)
    dropped_before = metrics.counter("serve.dropped_requests").value

    def _fire():
        time.sleep(jittered(kill_delay_s))
        try:
            idx = pick_victim() if pick_victim is not None else 0
            dep._handles[idx].kill(no_restart=True)
        except Exception:  # the replica may already be gone, racing teardown
            pass

    killer = threading.Thread(target=_fire, daemon=True)
    killer.start()
    killed, killed_errors = serve_request_stream(dep, x, n_requests)
    killer.join()
    dropped = int(metrics.counter("serve.dropped_requests").value - dropped_before)
    identical = (
        not clean_errors
        and not killed_errors
        and all(r is not None for r in clean)
        and all(r is not None for r in killed)
        and all(np.array_equal(a, b) for a, b in zip(clean, killed))
    )
    deadline = time.monotonic() + heal_timeout_s
    while dep.replica_count() < target and time.monotonic() < deadline:
        time.sleep(0.05)
    healed = dep.replica_count() == target
    return {
        "requests": n_requests,
        "dropped": dropped,
        "byte_identical": bool(identical),
        "pool_healed": bool(healed),
        "ok": bool(identical and dropped == 0 and healed),
        "errors": (clean_errors + killed_errors)[:3],
    }


def scenario_replica_kill_during_load(n_requests: int = 240, device=None) -> dict:
    """The serving plane's zero-drop contract: SIGKILL a model replica
    MID-REQUEST-STREAM and gate on ZERO dropped requests (in-flight batches
    on the dead replica are re-admitted and served again, inference being
    idempotent) and responses bitwise an unkilled run's (one batch bucket,
    so every dispatch is one shape), with the pool healed back to target.
    The model is fitted through ``fit_on_etl`` from an ETL session first."""
    import numpy as np
    import pandas as pd
    import torch

    from raydp_tpu_torch import serve
    from raydp_tpu_torch.estimator import Estimator
    from raydp_tpu_torch.etl.session import stop_etl
    from raydp_tpu_torch.models.mlp import MLPRegressor
    from raydp_tpu_torch.obs.metrics import metrics

    ckpt_dir = tempfile.mkdtemp(prefix="chaos-serve-ckpt-")
    rng = np.random.default_rng(5)
    rows = 1024
    pdf = pd.DataFrame({
        "a": rng.random(rows).astype(np.float32),
        "b": rng.random(rows).astype(np.float32),
    })
    pdf["y"] = 2 * pdf["a"] + 3 * pdf["b"]
    session = _fresh_session("chaos-serve")
    dep = None
    try:
        est = Estimator(
            model=functools.partial(MLPRegressor, 2, (8,), dtype=torch.float32),
            optimizer="adam", loss="mse", feature_columns=["a", "b"],
            label_column="y", batch_size=64, num_epochs=1, seed=0,
            checkpoint_dir=ckpt_dir, device=device,
        )
        est.fit_on_etl(session.from_pandas(pdf, num_partitions=2))
        x = pdf[["a", "b"]].to_numpy(np.float32)
        dep = serve.deploy(
            est, replicas=2, example=x[0],
            conf={
                "serve.max_batch_size": 16,
                "serve.batch_buckets": [16],  # deterministic shapes
                "serve.autoscale.tick_s": 0.1,
            },
        )
        probe = serve_kill_probe(
            dep, x, n_requests=n_requests,
            pick_victim=lambda: pick_index(dep.replica_count()),
        )
        return {
            "name": "replica_kill_during_load",
            "ok": probe["ok"],
            "byte_identical": probe["byte_identical"],
            "dropped_requests": probe["dropped"],
            "requeued_requests": int(
                metrics.counter("serve.requeued_requests").value),
            "replica_replacements": int(
                metrics.counter("serve.replica_replacements").value),
            "pool_healed": probe["pool_healed"],
            "errors": probe["errors"],
        }
    finally:
        if dep is not None:
            dep.close()
        stop_etl()


def _dossier_decode_section(dossier_dir: str, since: float) -> bool:
    """Whether a dossier written after ``since`` carries a decode section
    (the head writes it as the victim's death is handled: polled)."""
    from raydp_tpu_torch.obs.recorder import list_dossiers

    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        for path in reversed(list_dossiers(dossier_dir)):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):  # mid-write: the next poll reads it
                continue
            if float(doc.get("ts") or 0) >= since and doc.get("decode"):
                return True
        time.sleep(0.25)
    return False


def scenario_replica_kill_during_decode(n_streams: int = 4, max_new: int = 12,
                                        device=None) -> dict:
    """The streaming edition of the zero-drop contract: SIGKILL a replica
    while decode streams are in flight on its continuous-batching engine.
    The deployment heals, and each interrupted stream re-prefills prompt +
    emitted tokens on a survivor. Gates: every stream completes its whole
    token budget with no error; tokens identical to a clean run of the same
    prompts (greedy argmax over f32 logits, and decode == f32 prefill bit
    for bit, make the re-prefilled continuation exact); at least one
    failover; the pool healed; a dossier with a decode section where a
    dossier directory is set."""
    import numpy as np
    import torch

    from raydp_tpu_torch import serve
    from raydp_tpu_torch.estimator import checkpoint as ckpt
    from raydp_tpu_torch.etl.session import stop_etl
    from raydp_tpu_torch.models.transformer import TransformerLM
    from raydp_tpu_torch.obs.metrics import metrics

    vocab = DECODE_LM["vocab_size"]
    model = functools.partial(TransformerLM, **DECODE_LM, attn_impl="flash",
                              dtype=torch.float32)
    ckpt_dir = tempfile.mkdtemp(prefix="chaos-decode-ckpt-")
    weights = model(device="cpu")
    ckpt.save_checkpoint(ckpt_dir, 0, None, weights,
                         torch.optim.Adam(weights.parameters()))

    session = _fresh_session("chaos-decode")
    dep = None
    scenario_t0 = time.time()
    try:
        dep = serve.deploy(
            model=model, checkpoint_dir=ckpt_dir, replicas=2, device=device,
            conf={
                "serve.decode.enabled": True,
                "serve.decode.capacity_tokens": 128,
                "serve.decode.page_tokens": 32,
                "serve.decode.max_seqs": n_streams,
                "serve.decode.max_new_tokens": max_new,
            },
        )
        target = dep.replica_count()
        rng = np.random.default_rng(29)
        prompts = [
            [int(t) for t in rng.integers(0, vocab, rng.integers(3, 10))]
            for _ in range(n_streams)
        ]
        # a stream's tokens depend only on its own prompt, so a sequential
        # clean run is the reference for the concurrent killed run
        clean = [dep.generate(p, max_new, timeout=180) for p in prompts]

        failovers_before = metrics.counter("serve.decode.failovers").value
        partial: List[list] = [[] for _ in range(n_streams)]
        results: List[Optional[list]] = [None] * n_streams
        errors: List[str] = []

        def client(i: int):
            try:
                for tok in dep.stream(prompts[i], max_new, timeout=180):
                    partial[i].append(int(tok))
                results[i] = list(partial[i])
            except Exception as exc:  # noqa: BLE001 - the gate reports it
                errors.append(repr(exc)[:200])

        threads = [threading.Thread(target=client, args=(i,), name=f"decode-{i}")
                   for i in range(n_streams)]
        for t in threads:
            t.start()

        def _fire():
            # MID-stream: once every stream has ~2 tokens out (far from its
            # budget), so the kill cannot land after the streams finish
            deadline = time.monotonic() + 120
            while (sum(len(p) for p in partial) < 2 * n_streams
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            try:
                dep._handles[pick_index(dep.replica_count())].kill(no_restart=True)
            except Exception:  # the replica may already be gone, racing teardown
                pass

        killer = threading.Thread(target=_fire, daemon=True)
        killer.start()
        for t in threads:
            t.join(timeout=240)
        killer.join()

        failovers = int(metrics.counter("serve.decode.failovers").value
                        - failovers_before)
        complete = all(r is not None and len(r) == max_new for r in results)
        identical = complete and not errors and all(
            r == c for r, c in zip(results, clean))
        deadline = time.monotonic() + 20.0
        while dep.replica_count() < target and time.monotonic() < deadline:
            time.sleep(0.05)
        healed = dep.replica_count() == target
        dossier_dir = os.environ.get("RAYDP_TPU_DOSSIER_DIR", "")
        dossier_decode = (_dossier_decode_section(dossier_dir, scenario_t0)
                          if dossier_dir else None)
        return {
            "name": "replica_kill_during_decode",
            # failovers >= 1: the kill provably interrupted live streams
            "ok": bool(identical and healed and failovers >= 1
                       and dossier_decode is not False),
            "streams": n_streams,
            "tokens_per_stream": max_new,
            "token_identical": bool(identical),
            "streams_complete": bool(complete),
            "failovers": failovers,
            "pool_healed": bool(healed),
            "dossier_decode_section": dossier_decode,
            "errors": errors[:3],
        }
    finally:
        if dep is not None:
            dep.close()
        stop_etl()


SERVING = (scenario_replica_kill_during_load, scenario_replica_kill_during_decode)

QUICK = (
    scenario_mid_shuffle,
    scenario_mid_fit,
    scenario_executor_kill_with_service,
    scenario_service_kill_lineage_fallback,
    scenario_tenant_kill_isolation,
    scenario_replica_kill_during_load,
    scenario_replica_kill_during_decode,
    scenario_host_death,
)
FULL = (
    scenario_mid_shuffle,
    scenario_mid_compiled,
    scenario_mid_fit,
    scenario_executor_kill_with_service,
    scenario_service_kill_lineage_fallback,
    scenario_tenant_kill_isolation,
    scenario_elasticity,
    scenario_replica_kill_during_load,
    scenario_replica_kill_during_decode,
    scenario_host_death,
)


def _call(scenario, device):
    """A scenario with ``device`` where it takes one."""
    if "device" in inspect.signature(scenario).parameters:
        return scenario(device=device)
    return scenario()


def run(scenarios, device=None) -> dict:
    """Each scenario in turn, then the cluster's shutdown under the strict
    leak audit. A scenario fails on its own gate, on an exception, or on a
    thread it stranded in this process; the run fails on any failed
    scenario or sanitizer finding."""
    from raydp_tpu_torch import sanitize
    from raydp_tpu_torch.cluster import api as cluster_api

    results: List[dict] = []
    for scenario in scenarios:
        name = scenario.__name__
        t0 = time.perf_counter()
        try:
            entry = _call(scenario, device)
        except Exception as exc:  # one scenario must not hide the rest
            entry = {"name": name, "ok": False, "error": repr(exc)[:500]}
        entry["seconds"] = round(time.perf_counter() - t0, 2)
        # the leak inventory AFTER the scenario's session stopped. Gated:
        # stranded threads (a recovery that leaks a producer or reaper
        # thread shows at once). Reported only: fds (library internals open
        # them unpredictably) and shm/spill (driver-owned blocks live until
        # the cluster's shutdown, whose strict audit below is exact)
        entry["sanitizer"] = sanitizer_report()
        if entry["sanitizer"].get("threads"):
            entry["ok"] = False
            entry["sanitizer_fail"] = (
                f"{entry['sanitizer']['threads']} stranded thread(s)")
        results.append(entry)
        print(f"[chaos] {entry.get('name', name)}: "
              f"{'OK' if entry.get('ok') else 'FAILED'} "
              f"({entry['seconds']}s)", flush=True)
    # the final teardown audit: leaks-strict raises on any leaked segment
    sanitizer_findings = 0
    try:
        cluster_api.shutdown()
    except sanitize.LeakError as exc:
        sanitizer_findings += 1
        results.append({"name": "shutdown_leak_audit", "ok": False,
                        "error": str(exc)[:500]})
    except Exception as exc:  # any other teardown failure lands in the report
        results.append({"name": "cluster_shutdown", "ok": False,
                        "error": repr(exc)[:500]})
    unrecovered = sum(1 for r in results if not r.get("ok"))
    # every SIGKILL made the head write a crash dossier: the inventory rides
    # the report, so a failed run's artifact carries the victims' last
    # spans and logs
    dossier_dir = os.environ.get("RAYDP_TPU_DOSSIER_DIR", "")
    dossiers: List[str] = []
    if dossier_dir:
        from raydp_tpu_torch.obs.recorder import list_dossiers

        dossiers = list_dossiers(dossier_dir)
    return {
        "sanitize_modes": os.environ.get("RAYDP_TPU_SANITIZE", ""),
        "scenarios": results,
        "unrecovered_queries": unrecovered,
        "sanitizer_findings": sanitizer_findings,
        "dossier_dir": dossier_dir or None,
        "dossiers": dossiers,
        "ok": unrecovered == 0 and sanitizer_findings == 0,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="CI slice: mid-shuffle and mid-fit lineage "
                             "kills, both block-service tiers, the tenant "
                             "kill, both replica kills and the host death")
    parser.add_argument("--seed", type=int, default=None,
                        help="deterministic victim and timing selection "
                             "(unseeded keeps the fixed choices)")
    parser.add_argument("--json", default="chaos_report.json",
                        help="report artifact path")
    parser.add_argument("--device", default=None,
                        help="where the models run: the card (the default; "
                             "raises when there is none) or cpu")
    args = parser.parse_args(argv)
    from raydp_tpu_torch._device import resolve_device

    # the card unless the CPU is asked for: with no card and no --device
    # this raises before any session or process starts
    resolve_device(args.device)
    set_seed(args.seed)
    device = args.device
    os.environ.setdefault("RAYDP_TPU_SANITIZE", "donation,lockdep,leaks-strict")
    # sessions fork from a zygote of their own, which the shutdown stops (a
    # machine-wide one would outlive the run)
    os.environ.setdefault("RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE", "1")
    # crash dossiers land in one directory (the heads inherit the env)
    os.environ.setdefault("RAYDP_TPU_DOSSIER_DIR",
                          os.path.abspath("chaos_dossiers"))
    report = run(QUICK if args.quick else FULL, device=device)
    report["seed"] = args.seed
    with open(args.json, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(json.dumps({k: v for k, v in report.items() if k != "scenarios"}))
    if not report["ok"]:
        print("CHAOS FAIL", file=sys.stderr)
        return 1
    print("CHAOS OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
