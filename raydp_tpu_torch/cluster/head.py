"""The head process: cluster control plane, the port's own copy of
``raydp_tpu/cluster/head.py``.

One small service per session holding the mutable cluster state: virtual
nodes and resources, the actor lifecycle (spawn / crash-detect /
restart-with-same-identity), placement groups, and the telemetry plane
every process ships its spans, metrics and log ring to (the time-series
store behind the scrape endpoint and ``query_metrics``, and the flight
recorder behind a crash dossier on each terminal actor death).

It also holds the object-ownership table of the port's store
(``raydp_tpu_torch.store``: every block's owner, location and size, the
owner-death GC and its tombstones), the per-host block-service registry
and the tenant table, as the JAX head does. The head imports neither torch
nor pyarrow: the one store helper it calls (hosting a proxied put) is
imported where it is used and loads neither.

Runs as its own OS process (see head_main) so the driver's work on the card
can never starve the control plane.
"""

from __future__ import annotations

import difflib
import itertools as _itertools
import os
import signal
import socket
import socketserver
import subprocess
import threading
import time
import uuid
from typing import Dict, List, Optional

from raydp_tpu_torch.cluster.common import (
    HEAD_TCP_FILE,
    SESSION_ENV,
    ActorRecord,
    ActorSpec,
    ActorState,
    ClusterError,
    NodeRecord,
    OwnerDiedError,
    TenantQuotaError,
    bind_listening,
    head_sock_path,
    host_id as common_host_id,
    recv_frame,
    rpc,
    send_frame,
    tenant_of_object,
    unwrap_traced,
)
from raydp_tpu_torch import sanitize
from raydp_tpu_torch.obs import instant as obs_instant
from raydp_tpu_torch.obs import log as obs_log
from raydp_tpu_torch.obs import metrics as obs_metrics
from raydp_tpu_torch.obs import span as obs_span
from raydp_tpu_torch.obs import use_context as obs_use_context

_EPS = 1e-9


class _Bundle:
    def __init__(self, index: int, resources: Dict[str, float]):
        self.index = index
        self.resources = dict(resources)
        self.remaining = dict(resources)
        self.node_id: Optional[str] = None


class _PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]], strategy: str):
        self.pg_id = pg_id
        self.strategy = strategy
        self.bundles = [_Bundle(i, b) for i, b in enumerate(bundles)]
        self.next_bundle = 0  # round-robin cursor (parity: RayAppMaster.getNextBundleIndex, scala:315-323)


class _Actor:
    def __init__(self, spec: ActorSpec):
        self.spec = spec
        self.state = ActorState.PENDING
        self.incarnation = 0
        self.sock_path: Optional[str] = None
        self.node_id: Optional[str] = None
        self.scheduled_bundle: int = -1  # bundle actually charged at schedule time
        self.restarts_used = 0
        self.proc: Optional[subprocess.Popen] = None
        self.intentional_exit = False
        self.error: Optional[str] = None
        self.pending_respawn = False

    def record(self, node_ip: Optional[str]) -> ActorRecord:
        return ActorRecord(
            actor_id=self.spec.actor_id,
            name=self.spec.name,
            state=self.state,
            incarnation=self.incarnation,
            sock_path=self.sock_path,
            node_id=self.node_id,
            node_ip=node_ip,
            restarts_used=self.restarts_used,
            error=self.error,
            resources=dict(self.spec.resources),
        )


class _ObjectMeta:
    """Ownership record for one object-store entry (the payload lives in
    /dev/shm or a spill file, managed by ``raydp_tpu_torch.store``)."""

    def __init__(
        self, object_id: str, owner: str, shm_name: str, size: int,
        node_id: str, shm_ns: str = "",
    ):
        self.object_id = object_id
        self.owner = owner
        self.shm_name = shm_name
        self.size = size
        self.node_id = node_id
        self.shm_ns = shm_ns
        self.owner_died = False


class Head:
    def __init__(self, session_dir: str, driver_pid: int, default_resources: Dict[str, float]):
        self.session_dir = session_dir
        self.driver_pid = driver_pid
        self.lock = sanitize.named_lock("head.lock", threading.RLock())
        # woken whenever an actor reaches ALIVE or DEAD — lets clients block
        # in handle_wait_actor_ready instead of sleep-polling get_actor
        # (polling put its sleeps on session startup's critical path).
        # Wrapping the lockdep proxy keeps cond and lock ONE lockdep node —
        # they are the same mutex.
        self.actor_state_cond = threading.Condition(self.lock)
        # shared cluster state, mutated by handler threads AND the monitor
        # loop — every access must hold self.lock (the condition below wraps
        # the same lock).
        self.nodes: Dict[str, NodeRecord] = {}  # guarded-by: self.lock|self.actor_state_cond
        self.node_available: Dict[str, Dict[str, float]] = {}  # guarded-by: self.lock|self.actor_state_cond
        self.actors: Dict[str, _Actor] = {}  # guarded-by: self.lock|self.actor_state_cond
        self.named: Dict[str, str] = {}  # name -> actor_id; guarded-by: self.lock|self.actor_state_cond
        self.pgs: Dict[str, _PlacementGroup] = {}  # guarded-by: self.lock|self.actor_state_cond
        self.objects: Dict[str, _ObjectMeta] = {}  # guarded-by: self.lock|self.actor_state_cond
        # owner-kind metadata: (shm namespace, tenant) -> block-service
        # actor id (one per host per TENANT — every virtual node on a
        # machine shares /dev/shm, so the namespace is the host key; the
        # tenant key is what keeps one session's stop from tombstoning
        # blocks another session's handoffs adopted, the multi-tenant
        # isolation contract). Registrations flagged ``handoff`` are
        # recorded under the writing tenant's LIVE service instead of the
        # writing executor, which is what makes executor death lose zero
        # blocks (store/block_service.py). A
        # tenant-less registration (key ("", "") — the pre-tenancy shape)
        # serves as the fallback for any tenant in its namespace.
        self.block_services: Dict[tuple, str] = {}  # guarded-by: self.lock|self.actor_state_cond
        # tenant table: one record
        # per named tenant — active flag, fair-share weight, block-bytes
        # quota, and live bytes/blocks accounting charged from the object
        # table by id prefix. Passive records (active=False) accumulate for
        # unregistered tenants so accounting never silently drops bytes.
        self.tenants: Dict[str, dict] = {}  # guarded-by: self.lock|self.actor_state_cond
        # owner-death tombstones: object_id -> dead owner. When an owner
        # dies, its metas are POPPED (proactive unregister — they used to
        # linger as owner_died records until a reader tripped over them)
        # and tombstoned so reads still raise OwnerDiedError (the parity
        # semantics) instead of a clean not-found. Bounded FIFO; a lineage
        # rebind or a delete clears the tombstone.
        import collections as _tomb_collections

        self.owner_tombstones: "_tomb_collections.OrderedDict" = (
            _tomb_collections.OrderedDict()
        )  # guarded-by: self.lock|self.actor_state_cond
        # staged chunks of in-flight proxied puts + per-object last-activity
        # stamps (the TTL sweep in monitor_loop GCs abandoned uploads)
        self._proxy_staging: Dict[str, Dict[int, bytes]] = {}  # guarded-by: self.lock|self.actor_state_cond
        self._proxy_staging_ts: Dict[str, float] = {}  # guarded-by: self.lock|self.actor_state_cond
        self.shutting_down = False
        self._next_ip = 2
        self.tcp_addr: Optional[str] = None  # set by run_head once bound
        # observability aggregation point: every process ships its span ring
        # buffer + metrics snapshot here (obs_ingest); export_trace /
        # dump_metrics read them back (obs_dump). Bounded: the oldest spans
        # drop first, with the drop counted, so a chatty run degrades to a
        # truncated trace instead of unbounded head memory.
        import collections as _collections

        # capacity: ``obs.head_ring_spans`` session conf (obs_configure op)
        # with the legacy env var as the pre-conf fallback
        self.obs_spans: "_collections.deque" = _collections.deque(
            maxlen=int(os.environ.get("RAYDP_TPU_TRACE_HEAD_CAP", "200000"))
        )
        self.obs_dropped = 0
        self.obs_metrics: Dict[str, dict] = {}
        # telemetry plane v2 (docs/observability.md): the ring TSDB behind
        # the Prometheus scrape endpoint + query_metrics, and the flight
        # recorder behind crash dossiers. Both have their own LEAF locks —
        # fed after obs_ingest releases self.lock, read by the scrape
        # thread / dossier writers without ever touching self.lock.
        from raydp_tpu_torch.obs.recorder import DOSSIER_DIR_ENV, FlightRecorder
        from raydp_tpu_torch.obs.timeseries import SeriesStore

        self.tsdb = SeriesStore()
        self.flight = FlightRecorder()
        self.dossier_dir = os.environ.get(DOSSIER_DIR_ENV) or os.path.join(
            session_dir, "dossiers"
        )
        self.scrape_server = None  # guarded-by: self._scrape_lock
        self._scrape_lock = sanitize.named_lock(
            "head.scrape", threading.Lock()
        )
        if default_resources:
            self._add_node(default_resources)

    # ---------- nodes ----------

    def _add_node(  # guarded-by: self.lock|self.actor_state_cond held
        self,
        resources: Dict[str, float],
        node_ip: Optional[str] = None,
        agent_addr: Optional[str] = None,
        shm_ns: str = "",
        host: str = "",
    ) -> str:
        node_id = f"node-{uuid.uuid4().hex[:8]}"
        if node_ip is None:
            node_ip = f"127.0.0.{self._next_ip}"
            self._next_ip += 1
        res = dict(resources)
        res.setdefault("CPU", 1.0)
        res.setdefault("memory", float(4 << 30))
        res[f"node:{node_ip}"] = 1.0
        # host axis: agent-backed nodes report theirs (real box or simulated
        # namespace); head-local virtual nodes share the head's own host
        if not host and not agent_addr:
            host = common_host_id()
        self.nodes[node_id] = NodeRecord(
            node_id, node_ip, res, agent_addr=agent_addr, shm_ns=shm_ns,
            host=host or shm_ns,
        )
        self.node_available[node_id] = dict(res)
        return node_id

    def handle_add_node(self, resources: Dict[str, float], node_ip: Optional[str] = None):
        with self.lock:
            return self._add_node(resources, node_ip)

    def handle_register_agent(
        self,
        resources: Dict[str, float],
        node_ip: str,
        agent_addr: str,
        shm_ns: str,
        host: str = "",
    ):
        """A node agent (another host, or a separate-shm process standing in
        for one) joins the cluster: its actors spawn through the agent and
        its blocks are served by the agent's block server — the multi-host
        parity of the reference's Ray nodes (SURVEY.md L1). ``host`` is the
        agent's position on the host axis (``RAYDP_TPU_TORCH_HOST_ID``, falling
        back to its shm namespace — docs/cluster.md "Multi-host topology")."""
        with self.lock:
            return self._add_node(
                resources, node_ip, agent_addr=agent_addr, shm_ns=shm_ns,
                host=host,
            )

    def handle_remove_node(self, node_id: str, only_if_empty: bool = False):
        """Kill a virtual node and every actor process on it (elasticity testing,
        parity: ray.cluster_utils.Cluster.remove_node used at reference
        test_spark_cluster.py:166-196). ``only_if_empty`` makes it a safe
        RETIREMENT instead: if any non-DEAD actor sits on the node, return
        False and touch nothing — the tenancy attach-node cleanup path,
        where a co-tenant's actor may have been scheduled onto the capacity
        this tenant added and must never be collateral."""
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                raise ClusterError(f"unknown or dead node {node_id}")
            if only_if_empty and any(
                a.node_id == node_id and a.state != ActorState.DEAD
                for a in self.actors.values()
            ):
                return False
            node.alive = False
            obs_log.warning(
                "node removed", node_id=node_id, node_ip=node.node_ip,
                agent=bool(node.agent_addr),
            )
            obs_instant("cluster.node_removed", node_id=node_id)
            self.node_available[node_id] = {}
            for actor in self.actors.values():
                if actor.node_id == node_id and actor.state in (
                    ActorState.ALIVE,
                    ActorState.PENDING,
                ):
                    self._kill_proc(actor)
                    if actor.proc is None:
                        # agent-hosted actor: there is no local proc for the
                        # monitor to observe (and a dead agent will never
                        # report) — recycle it here
                        self._on_actor_death(actor)
            # the monitor observes local-proc deaths and handles restart/cleanup
        return True

    def handle_nodes(self):
        with self.lock:
            return [n for n in self.nodes.values()]

    def handle_total_resources(self):
        with self.lock:
            return {n.node_id: dict(n.resources) for n in self.nodes.values() if n.alive}

    def handle_available_resources(self):
        with self.lock:
            return {
                n_id: dict(avail)
                for n_id, avail in self.node_available.items()
                if self.nodes[n_id].alive
            }

    # ---------- resource math ----------

    @staticmethod
    def _fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
        return all(avail.get(k, 0.0) + _EPS >= v for k, v in req.items())

    @staticmethod
    def _sub(avail: Dict[str, float], req: Dict[str, float]) -> None:
        for k, v in req.items():
            avail[k] = avail.get(k, 0.0) - v

    @staticmethod
    def _add(avail: Dict[str, float], req: Dict[str, float]) -> None:
        for k, v in req.items():
            avail[k] = avail.get(k, 0.0) + v

    def _alive_nodes(self) -> List[str]:  # guarded-by: self.lock|self.actor_state_cond held
        return [n_id for n_id, n in self.nodes.items() if n.alive]

    # ---------- placement groups ----------

    def handle_create_placement_group(
        self, bundles: List[Dict[str, float]], strategy: str
    ) -> str:
        """Reserve bundle resources per strategy. Parity: Ray placement groups as
        used by the reference (context.py:94-113, mpi_job.py:192-222)."""
        strategy = strategy.upper()
        if strategy not in ("PACK", "STRICT_PACK", "SPREAD", "STRICT_SPREAD"):
            raise ClusterError(f"unknown placement strategy {strategy}")
        with self.lock:
            pg = _PlacementGroup(f"pg-{uuid.uuid4().hex[:8]}", bundles, strategy)
            placed: List[tuple] = []  # (bundle, node_id) for rollback

            def place(bundle: _Bundle, node_id: str) -> None:  # guarded-by: self.lock|self.actor_state_cond held
                self._sub(self.node_available[node_id], bundle.resources)
                bundle.node_id = node_id
                placed.append((bundle, node_id))

            def rollback() -> None:  # guarded-by: self.lock|self.actor_state_cond held
                for bundle, node_id in placed:
                    self._add(self.node_available[node_id], bundle.resources)

            try:
                if strategy == "STRICT_PACK":
                    for node_id in self._alive_nodes():
                        avail = dict(self.node_available[node_id])
                        ok = True
                        for b in pg.bundles:
                            if not self._fits(avail, b.resources):
                                ok = False
                                break
                            self._sub(avail, b.resources)
                        if ok:
                            for b in pg.bundles:
                                place(b, node_id)
                            break
                    else:
                        raise ClusterError("STRICT_PACK: no single node fits all bundles")
                elif strategy == "STRICT_SPREAD":
                    used: set = set()
                    for b in pg.bundles:
                        for node_id in self._alive_nodes():
                            if node_id not in used and self._fits(
                                self.node_available[node_id], b.resources
                            ):
                                place(b, node_id)
                                used.add(node_id)
                                break
                        else:
                            raise ClusterError(
                                "STRICT_SPREAD: not enough distinct nodes with capacity"
                            )
                else:  # PACK / SPREAD: best effort orderings
                    node_order = self._alive_nodes()
                    for b in pg.bundles:
                        candidates = [
                            n for n in node_order if self._fits(self.node_available[n], b.resources)
                        ]
                        if not candidates:
                            raise ClusterError("placement group does not fit cluster")
                        if strategy == "SPREAD":
                            counts = {n: 0 for n in node_order}
                            for pb, pn in placed:
                                if pn in counts:
                                    counts[pn] += 1
                            candidates.sort(key=lambda n: counts[n])
                        place(b, candidates[0])
            except Exception:
                rollback()
                raise
            self.pgs[pg.pg_id] = pg
            return pg.pg_id

    def handle_remove_placement_group(self, pg_id: str):
        with self.lock:
            pg = self.pgs.pop(pg_id, None)
            if pg is None:
                return False
            for b in pg.bundles:
                if b.node_id is not None and self.nodes[b.node_id].alive:
                    # return whatever of the reservation is still unconsumed
                    self._add(self.node_available[b.node_id], b.remaining)
            return True

    def handle_placement_group_table(self):
        with self.lock:
            return {
                pg_id: {
                    "strategy": pg.strategy,
                    "bundles": [
                        {"index": b.index, "node_id": b.node_id, "resources": b.resources}
                        for b in pg.bundles
                    ],
                }
                for pg_id, pg in self.pgs.items()
            }

    # round-robin bundle cursor: public PG scheduling surface for Ray-parity
    # callers; no in-tree call site
    def handle_pg_next_bundle(self, pg_id: str) -> int:
        with self.lock:
            pg = self.pgs[pg_id]
            index = pg.next_bundle % len(pg.bundles)
            pg.next_bundle += 1
            return index

    # ---------- actors ----------

    def _schedule(self, actor: _Actor) -> str:  # guarded-by: self.lock|self.actor_state_cond held
        """Pick a node for the actor and charge resources; raises if nothing fits.
        Records which bundle was charged so death can credit the same bundle."""
        spec = actor.spec
        if spec.placement_group is not None:
            pg = self.pgs.get(spec.placement_group)
            if pg is None:
                raise ClusterError(f"placement group {spec.placement_group} not found")
            index = spec.bundle_index
            if index < 0:
                index = pg.next_bundle % len(pg.bundles)
            bundle = pg.bundles[index]
            if bundle.node_id is None or not self.nodes[bundle.node_id].alive:
                raise ClusterError("placement bundle's node is gone")
            if not self._fits(bundle.remaining, spec.resources):
                raise ClusterError(
                    f"bundle {index} of {pg.pg_id} lacks {spec.resources}, has {bundle.remaining}"
                )
            self._sub(bundle.remaining, spec.resources)
            if spec.bundle_index < 0:
                pg.next_bundle += 1  # advance round-robin only on success
            actor.scheduled_bundle = index
            return bundle.node_id
        for node_id in self._alive_nodes():
            if self._fits(self.node_available[node_id], spec.resources):
                self._sub(self.node_available[node_id], spec.resources)
                actor.scheduled_bundle = -1
                return node_id
        raise ClusterError(
            f"no node can host actor {spec.name or spec.actor_id} "
            f"requiring {spec.resources}; available={self.handle_available_resources()}"
        )

    def _spawn(self, actor: _Actor) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        spec = actor.spec
        node = self.nodes[actor.node_id]
        if node.agent_addr is not None:
            # remote node: the agent forks the worker on its host. The RPC
            # runs on a thread — _spawn is called under the head lock, and a
            # slow/dead agent must not freeze the whole control plane. A
            # failed delivery flips the actor back to pending_respawn, which
            # the monitor retries (and the agent watchdog will kill the node
            # if it stays unreachable).
            agent_addr = node.agent_addr
            incarnation = actor.incarnation
            head_addr = self.tcp_addr

            def _remote_spawn():
                try:
                    rpc(
                        agent_addr,
                        (
                            "spawn_actor",
                            {
                                "spec": spec,
                                "incarnation": incarnation,
                                "head_addr": head_addr,
                            },
                        ),
                        timeout=15,
                    )
                except Exception:
                    fenced = False
                    with self.lock:
                        # ALIVE proves the spawn WAS delivered and the worker
                        # registered — only the RPC reply was lost; fencing
                        # would kill a healthy serving actor
                        if actor.incarnation == incarnation and actor.state not in (
                            ActorState.DEAD,
                            ActorState.ALIVE,
                        ):
                            # credit back what _schedule charged: the retry
                            # path re-schedules (and re-charges) from scratch
                            self._release_actor_resources(actor)
                            # The RPC may have been DELIVERED despite the
                            # timeout: a twin worker could be coming up on the
                            # agent. Fence it out by bumping the incarnation
                            # before the retry respawns — handle_actor_ready /
                            # handle_actor_exited guards then reject the stale
                            # twin, which cannot route calls or recycle the
                            # replacement.
                            actor.incarnation += 1
                            actor.pending_respawn = True
                            fenced = True
                    # Best-effort reap of the possible twin (outside the
                    # lock), keyed by the STALE incarnation: the monitor may
                    # respawn onto this same agent before the kill lands, and
                    # an id-only kill would hit the healthy replacement.
                    if fenced:
                        try:
                            rpc(
                                agent_addr,
                                (
                                    "kill_actor",
                                    {
                                        "actor_id": spec.actor_id,
                                        "incarnation": incarnation,
                                    },
                                ),
                                timeout=3,
                            )
                        except Exception:  # best-effort kill of a spawn that lost the incarnation race
                            pass

            threading.Thread(target=_remote_spawn, daemon=True).start()
            actor.proc = None
            return
        env = dict(os.environ)
        env.update(spec.env)
        env[SESSION_ENV] = self.session_dir
        env["RAYDP_TPU_TORCH_ACTOR_ID"] = spec.actor_id
        env["RAYDP_TPU_TORCH_NODE_ID"] = actor.node_id
        env["RAYDP_TPU_TORCH_NODE_IP"] = node.node_ip
        from raydp_tpu_torch.cluster.common import HEAD_ADDR_ENV, launch_worker

        # head-local workers resolve the head from the env too: a handle
        # pickled by a tcp:// client embeds the CLIENT's local dir, which
        # has no head socket (and on another machine doesn't exist at all)
        env.setdefault(HEAD_ADDR_ENV, head_sock_path(self.session_dir))

        # the fork itself runs OFF the head lock on a thread: a zygote fork
        # of a warmed template is not free (page-table copy), and paying it synchronously under the lock serialized every
        # create_actor behind it — the dominant term of session boot. The
        # same deferred-proc discipline as agent spawns applies: proc lands
        # under the lock when the fork completes, and a kill that raced the
        # spawn reaps the fresh process the moment it is recorded.
        incarnation = actor.incarnation

        def _local_spawn():
            try:
                proc = launch_worker(spec, incarnation, self.session_dir, env)
            except OSError:
                with self.lock:
                    if actor.incarnation == incarnation and actor.state not in (
                        ActorState.DEAD,
                        ActorState.ALIVE,
                    ):
                        self._release_actor_resources(actor)
                        actor.pending_respawn = True
                return
            stale = False
            with self.lock:
                if (
                    actor.incarnation != incarnation
                    or actor.intentional_exit
                    or actor.state == ActorState.DEAD
                ):
                    stale = True  # killed/fenced while forking
                else:
                    actor.proc = proc
            if stale:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except OSError:  # kill of an already-dead raced spawn is idempotent
                    pass

        threading.Thread(target=_local_spawn, daemon=True).start()
        actor.proc = None

    def handle_create_actor(self, spec: ActorSpec) -> str:
        with self.lock:
            if spec.name is not None and spec.name in self.named:
                # a DEAD holder releases its name (Ray semantics: names are
                # reusable after the actor dies; get_actor keeps reporting the
                # dead record only until someone takes the name again). An
                # actor with a no-restart kill in flight counts as dead too —
                # its name can never serve requests again.
                existing = self.actors.get(self.named[spec.name])
                if (
                    existing is None
                    or existing.state == ActorState.DEAD
                    or existing.intentional_exit
                ):
                    del self.named[spec.name]
                else:
                    raise ClusterError(f"actor name {spec.name!r} already taken")
            actor = _Actor(spec)
            actor.node_id = self._schedule(actor)
            try:
                spec_path = os.path.join(self.session_dir, f"a-{spec.actor_id}.spec")
                with open(spec_path, "wb") as f:
                    import cloudpickle

                    cloudpickle.dump(spec, f)
                self.actors[spec.actor_id] = actor
                if spec.name is not None:
                    self.named[spec.name] = spec.actor_id
                self._spawn(actor)
            except BaseException:
                # roll back so a failed spawn doesn't leak resources or the name
                self._release_actor_resources(actor)
                self.actors.pop(spec.actor_id, None)
                if spec.name is not None and self.named.get(spec.name) == spec.actor_id:
                    del self.named[spec.name]
                raise
            return spec.actor_id

    def handle_actor_ready(self, actor_id: str, incarnation: int, sock_path: str):
        with self.lock:
            actor = self.actors[actor_id]
            if incarnation != actor.incarnation:
                return False  # stale incarnation raced with a respawn
            actor.sock_path = sock_path
            actor.state = ActorState.ALIVE
            self.actor_state_cond.notify_all()
            return True

    def handle_wait_actor_ready(self, actor_id: str, timeout: float = 30.0):
        """Block until the actor is ALIVE or DEAD (or the timeout lapses) and
        return its record — the event-driven replacement for clients polling
        get_actor in a sleep loop. Runs on the connection's handler thread;
        the condition wait releases the head lock. The short re-check period
        guards against any state transition that forgets to notify."""
        deadline = time.monotonic() + timeout
        with self.lock:
            while True:
                actor = self.actors.get(actor_id)
                if actor is not None and actor.state in (
                    ActorState.ALIVE,
                    ActorState.DEAD,
                ):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.actor_state_cond.wait(min(remaining, 0.25))
            if actor is None:
                return None
            ip = self.nodes[actor.node_id].node_ip if actor.node_id else None
            return actor.record(ip)

    def handle_actor_init_failed(self, actor_id: str, incarnation: int, error: str):
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is not None and incarnation == actor.incarnation:
                actor.error = error
                actor.intentional_exit = True  # init failure: don't retry-loop
            return True

    def handle_get_actor(self, actor_id: Optional[str] = None, name: Optional[str] = None):
        with self.lock:
            if actor_id is None:
                if name is None or name not in self.named:
                    return None
                actor_id = self.named[name]
            actor = self.actors.get(actor_id)
            if actor is None:
                return None
            ip = self.nodes[actor.node_id].node_ip if actor.node_id else None
            return actor.record(ip)

    def handle_list_actors(self):
        with self.lock:
            return [
                a.record(self.nodes[a.node_id].node_ip if a.node_id else None)
                for a in self.actors.values()
            ]

    def handle_actor_exited(self, actor_id: str, incarnation: int):
        """Agent-reported death of a remote actor (local actors are observed
        directly via proc.poll in the monitor loop)."""
        with self.lock:
            actor = self.actors.get(actor_id)
            if (
                actor is not None
                and actor.incarnation == incarnation
                and actor.state not in (ActorState.DEAD,)
                and not actor.pending_respawn
            ):
                self._on_actor_death(actor)
            return True

    def handle_mark_intentional_exit(self, actor_id: str):
        """Called by an actor about to exit on purpose so the monitor does not
        restart it (parity: Ray.exitActor used precisely for this,
        reference ApplicationInfo.scala:119-124)."""
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is not None:
                actor.intentional_exit = True
            return True

    def _kill_proc(self, actor: _Actor) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        if actor.proc is not None and actor.proc.poll() is None:
            try:
                os.killpg(actor.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):  # kill of an already-dead process is idempotent
                pass
            return
        if actor.proc is None and actor.node_id:
            node = self.nodes.get(actor.node_id)
            if node is not None and node.agent_addr is not None:
                agent_addr = node.agent_addr
                actor_id = actor.spec.actor_id

                def _remote_kill():  # off-lock: agents can be slow/dead
                    try:
                        rpc(
                            agent_addr,
                            ("kill_actor", {"actor_id": actor_id}),
                            timeout=10,
                        )
                    except Exception:  # agent gone: the node is dead anyway
                        pass  # agent gone: the node is dead anyway

                threading.Thread(target=_remote_kill, daemon=True).start()

    def handle_kill_actor(self, actor_id: str, no_restart: bool = True):
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                return False
            if no_restart:
                actor.intentional_exit = True
            self._kill_proc(actor)
            if actor.proc is not None:
                # fast-path reap: an intentional kill is otherwise only
                # noticed by the 50ms monitor cadence — session stop drains
                # on DEAD state, so observe the SIGKILL promptly off-lock
                threading.Thread(
                    target=self._reap_after_kill, args=(actor, actor.proc),
                    daemon=True,
                ).start()
            else:
                node = self.nodes.get(actor.node_id) if actor.node_id else None
                if node is None or node.agent_addr is None:
                    # local actor whose async fork hasn't landed yet: there
                    # is no process to reap (the spawn thread SIGKILLs the
                    # raced fork when it records the kill) — run the death
                    # bookkeeping now so state() drains to DEAD promptly
                    if actor.state != ActorState.DEAD and not actor.pending_respawn:
                        self._on_actor_death(actor)
            return True

    def _reap_after_kill(self, actor: "_Actor", killed) -> None:
        """Wait (bounded) for the just-SIGKILLed process ``killed`` of a
        local actor to exit, then run the death bookkeeping immediately
        instead of on the next monitor poll. Racing the monitor is safe:
        both transition under the lock, and this reaper acts only while
        ``killed`` is still the actor's process. Once the monitor has seen
        the death and started a respawn, ``actor.proc`` is None (the fork
        not landed yet) or the next incarnation's, and a second death
        would burn a restart and kill the respawn (the JAX head's reaper
        takes a None ``proc`` for a death)."""
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if killed.poll() is not None:
                with self.lock:
                    if (
                        actor.proc is killed
                        and actor.state != ActorState.DEAD
                        and not actor.pending_respawn
                    ):
                        self._on_actor_death(actor)
                return
            time.sleep(0.005)

    def _release_actor_resources(self, actor: _Actor) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        spec = actor.spec
        if spec.placement_group is not None:
            pg = self.pgs.get(spec.placement_group)
            if pg is not None and 0 <= actor.scheduled_bundle < len(pg.bundles):
                self._add(pg.bundles[actor.scheduled_bundle].remaining, spec.resources)
            actor.scheduled_bundle = -1
            return
        if actor.node_id is not None and self.nodes[actor.node_id].alive:
            self._add(self.node_available[actor.node_id], spec.resources)

    def _on_actor_death(self, actor: _Actor) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        """Monitor-thread callback when an actor process has exited."""
        self._release_actor_resources(actor)
        old_sock = actor.sock_path
        actor.sock_path = None
        if old_sock and not old_sock.startswith("tcp://"):
            try:
                os.unlink(old_sock)
            except OSError:  # actor socket may already be unlinked
                pass
        if actor.intentional_exit or actor.restarts_used >= actor.spec.max_restarts:
            actor.state = ActorState.DEAD
            if not actor.intentional_exit:
                # a crash past max_restarts is a real loss — attributable in
                # the head log AND visible in the trace timeline
                obs_log.error(
                    "actor dead (restarts exhausted)",
                    actor_id=actor.spec.actor_id, name=actor.spec.name,
                    restarts_used=actor.restarts_used, error=actor.error,
                )
            obs_instant(
                "cluster.actor_dead",
                actor_id=actor.spec.actor_id,
                intentional=actor.intentional_exit,
            )
            obs_metrics.counter("cluster.actor_deaths").inc()
            if not self.shutting_down:
                # flight recorder: every terminal actor death (executor,
                # replica, block service — SIGKILLed or crashed) gets a
                # crash dossier with the victim's last shipped rings.
                # Teardown kills are excluded by the shutting_down guard;
                # the write runs on a detached thread (file I/O never under
                # self.lock).
                self._write_crash_dossier(
                    reason=(
                        "actor_killed" if actor.intentional_exit
                        else "actor_crashed"
                    ),
                    victim={
                        "actor_id": actor.spec.actor_id,
                        "name": actor.spec.name,
                        "pid": actor.proc.pid if actor.proc is not None else None,
                        "intentional": actor.intentional_exit,
                        "restarts_used": actor.restarts_used,
                        "error": str(actor.error)[:300] if actor.error else None,
                    },
                    needle=actor.spec.actor_id,
                )
            self.actor_state_cond.notify_all()
            self._on_owner_dead(actor.spec.actor_id)
            # a DEAD block service must not keep adopting registrations —
            # drop its owner-kind entries so handoffs fall back to the
            # writer's own ownership
            for key in [
                key
                for key, a in self.block_services.items()
                if a == actor.spec.actor_id
            ]:
                del self.block_services[key]
            # the name -> id mapping stays, so get_actor(name) reports DEAD
            return
        actor.restarts_used += 1
        actor.incarnation += 1
        actor.state = ActorState.RESTARTING
        actor.pending_respawn = True
        obs_log.warning(
            "actor crashed; restarting",
            actor_id=actor.spec.actor_id, name=actor.spec.name,
            incarnation=actor.incarnation, restarts_used=actor.restarts_used,
        )
        obs_instant(
            "cluster.actor_restart",
            actor_id=actor.spec.actor_id, incarnation=actor.incarnation,
        )
        obs_metrics.counter("cluster.actor_restarts").inc()
        self._try_respawn(actor)

    def _try_respawn(self, actor: _Actor) -> None:
        try:
            actor.node_id = self._schedule(actor)
        except ClusterError:
            return  # stays pending; retried by the monitor when capacity returns
        actor.pending_respawn = False
        try:
            self._spawn(actor)
        except OSError:
            self._release_actor_resources(actor)
            actor.pending_respawn = True

    # ---------- block services (per-host owner-of-record actors) ----------

    def handle_block_service_register(self, actor_id: str, tenant: str = ""):
        """Adopt a spawned BlockService actor as the owner of record for its
        node's shared-memory namespace (scoped to ``tenant`` when given —
        the multi-tenant shape; a tenant-less registration is the namespace
        fallback any tenant's handoffs may adopt, the pre-tenancy behavior).
        Returns the namespace it serves."""
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                raise ClusterError(f"unknown block-service actor {actor_id}")
            node = self.nodes.get(actor.node_id) if actor.node_id else None
            ns = node.shm_ns if node is not None else ""
            self.block_services[(ns, tenant or "")] = actor_id
        obs_instant(
            "block_service.registered", actor_id=actor_id, shm_ns=ns,
            tenant=tenant or "",
        )
        return ns

    def handle_block_service_unregister(self, actor_id: str):
        """Drop a service from the owner-kind table (A/B toggle; its already-
        owned blocks keep their owner — only FUTURE handoffs fall back)."""
        with self.lock:
            for key in [
                key for key, a in self.block_services.items() if a == actor_id
            ]:
                del self.block_services[key]
        return True

    def handle_block_service_lookup(self, shm_ns: str = "", tenant: str = ""):
        with self.lock:
            return self._service_for(shm_ns, tenant)

    def handle_block_service_peers(self):
        """Every LIVE, tcp-reachable block service with its host-axis row —
        the spill-to-remote tier's target list (store._remote_spill_peer).
        Only ALIVE services with a tcp socket qualify: a remote writer must
        be able to dial the address it gets back right now."""
        with self.lock:
            rows = []
            for (ns, tenant), actor_id in self.block_services.items():
                actor = self.actors.get(actor_id)
                if (
                    actor is None
                    or actor.state != ActorState.ALIVE
                    or not actor.sock_path
                    or not actor.sock_path.startswith("tcp://")
                ):
                    continue
                node = self.nodes.get(actor.node_id) if actor.node_id else None
                rows.append({
                    "actor_id": actor_id,
                    "shm_ns": ns,
                    "tenant": tenant,
                    "host": node.host if node is not None else ns,
                    "service_addr": actor.sock_path,
                })
            return rows

    def _service_for(self, shm_ns: str, tenant: str) -> Optional[str]:  # guarded-by: self.lock|self.actor_state_cond held
        """The block service serving (namespace, tenant): the tenant-scoped
        entry first, then the namespace's tenant-less fallback. A tenant-
        scoped service NEVER serves another tenant — that is what keeps
        tenant A's session stop (which kills A's service and tombstones its
        blocks) from ever owning B's blocks."""
        service = self.block_services.get((shm_ns, tenant or ""))
        if service is None and tenant:
            service = self.block_services.get((shm_ns, ""))
        return service

    def _effective_owner(  # guarded-by: self.lock|self.actor_state_cond held
        self, owner: str, shm_ns: str, handoff: bool, tenant: str = ""
    ) -> str:
        """The owner of record for a new registration: the (namespace,
        tenant)'s LIVE block service when the writer flagged the entry for
        handoff, else the writer itself. Deciding HERE (the head knows actor
        liveness authoritatively) means a dead/bouncing service degrades
        registrations to executor ownership instead of parking blocks on a
        corpse owner that no death event will ever GC."""
        if not handoff:
            return owner
        service = self._service_for(shm_ns, tenant)
        if service is None or service == owner:
            return owner
        actor = self.actors.get(service)
        if (
            actor is None
            or actor.state == ActorState.DEAD
            or actor.intentional_exit
        ):
            return owner
        obs_metrics.counter("block_service.adopted_blocks").inc()
        return service

    # ---------- tenant table ----------

    def handle_tenant_register(
        self, name: str, weight: float = 1.0, max_block_bytes: int = 0,
    ):
        """Admit a named tenant (one ``init_etl(app_name=...)`` attach).
        Rejects a duplicate ACTIVE registration — the cross-driver half of
        the session-singleton guard; re-registering a stopped tenant keeps
        its accumulated byte accounting (blocks can outlive a session via
        ownership transfer)."""
        with self.lock:
            record = self.tenants.get(name)
            if record is not None and record.get("active"):
                raise ClusterError(
                    f"tenant {name!r} is already running on this cluster; "
                    "stop it (or pick another app_name) first"
                )
            if record is None:
                record = {"name": name, "bytes_stored": 0, "blocks": 0}
                self.tenants[name] = record
            record.update(
                active=True,
                weight=float(weight),
                max_block_bytes=int(max_block_bytes),
            )
            # the gauge exists from registration on, so dump_metrics carries
            # the per-tenant key even before the first block lands (pinned-
            # schema tests and dashboards rely on the keys existing)
            self._tenant_gauge(record).set(record["bytes_stored"])
        obs_instant("tenant.registered", tenant=name)
        obs_metrics.counter("tenant.registrations").inc()
        return name

    def handle_tenant_unregister(self, name: str):
        """Mark a tenant inactive (its session stopped). The record — and
        its byte accounting — survives: transferred blocks may outlive the
        session, and a later re-attach under the same name resumes it."""
        with self.lock:
            record = self.tenants.get(name)
            if record is not None:
                record["active"] = False
        obs_instant("tenant.unregistered", tenant=name)
        return record is not None

    def handle_tenant_list(self):
        with self.lock:
            return {
                name: {k: v for k, v in r.items() if not k.startswith("_")}
                for name, r in self.tenants.items()
            }

    @staticmethod
    def _tenant_gauge(record: dict):  # guarded-by: self.lock|self.actor_state_cond held
        """The tenant's bytes_stored gauge, cached ON the record: the
        charge/credit paths run per block under the head lock (a wide
        shuffle batch registers thousands of entries in one hold) and must
        not pay an f-string build + registry-locked lookup each time."""
        gauge = record.get("_gauge")
        if gauge is None:
            gauge = record["_gauge"] = obs_metrics.gauge(
                f"tenant.{record['name']}.bytes_stored"
            )
        return gauge

    def _tenant_record(self, tenant: str) -> Optional[dict]:  # guarded-by: self.lock|self.actor_state_cond held
        if not tenant:
            return None
        record = self.tenants.get(tenant)
        if record is None:
            # unregistered writer (transferred survivors, out-of-band
            # tools): account passively, enforce nothing
            record = {
                "name": tenant, "bytes_stored": 0, "blocks": 0,
                "active": False, "weight": 1.0, "max_block_bytes": 0,
            }
            self.tenants[tenant] = record
        return record

    def _tenant_charge(  # guarded-by: self.lock|self.actor_state_cond held
        self, object_id: str, size: int, enforce: bool = True
    ) -> None:
        """Charge a registration against its tenant's block-bytes quota
        BEFORE inserting the meta; raises the typed quota error instead of
        admitting the block (the writer's registration fails cleanly and
        its segment is unlinked by the seal/batch failure paths).
        ``enforce=False`` moves accounting without the quota check — the
        rebind path, which re-registers bytes that were ALREADY admitted
        (a quota raise there would drop the popped meta mid-recovery)."""
        record = self._tenant_record(tenant_of_object(object_id))
        if record is None:
            return
        limit = int(record.get("max_block_bytes") or 0) if enforce else 0
        if limit and record["bytes_stored"] + size > limit:
            obs_metrics.counter(
                f"tenant.{record['name']}.quota_rejections"
            ).inc()
            err = TenantQuotaError(
                f"tenant {record['name']!r} block-bytes quota exceeded: "
                f"{record['bytes_stored']} stored + {size} new > {limit}"
            )
            err.tenant = record["name"]
            raise err
        record["bytes_stored"] += size
        record["blocks"] += 1
        self._tenant_gauge(record).set(record["bytes_stored"])

    def _tenant_credit(self, meta: "_ObjectMeta") -> None:  # guarded-by: self.lock|self.actor_state_cond held
        record = self.tenants.get(tenant_of_object(meta.object_id))
        if record is None:
            return
        record["bytes_stored"] = max(0, record["bytes_stored"] - meta.size)
        record["blocks"] = max(0, record["blocks"] - 1)
        self._tenant_gauge(record).set(record["bytes_stored"])

    # ---------- object ownership table ----------

    def handle_object_put(
        self, object_id: str, owner: str, shm_name: str, size: int,
        node_id: str, shm_ns: str = "", handoff: bool = False,
    ):
        """Register one block. Returns the EFFECTIVE owner (the writing
        tenant's block service for handoff entries) so the writer can
        correct its location cache and the metas it pushes to peers."""
        with self.lock:
            self._tenant_charge(object_id, size)
            owner = self._effective_owner(
                owner, shm_ns, handoff, tenant_of_object(object_id)
            )
            self.objects[object_id] = _ObjectMeta(
                object_id, owner, shm_name, size, node_id, shm_ns
            )
            return owner

    # a proxied put whose client died between chunk RPCs and commit would
    # otherwise pin up to the full object size in head memory forever; the
    # monitor GCs staging entries idle longer than this (each arriving chunk
    # refreshes the stamp, so slow-but-live uploads are never collected)
    PROXY_STAGING_TTL_S = 300.0

    def handle_object_put_proxy_chunk(self, object_id: str, seq: int, payload: bytes):
        """One chunk of a large proxied put (the client chunks to stay under
        the frame cap); staged until commit."""
        with self.lock:
            self._proxy_staging.setdefault(object_id, {})[seq] = payload
            self._proxy_staging_ts[object_id] = time.monotonic()
        return True

    def _gc_proxy_staging(self, now: float) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        """Drop staged proxied-put chunks whose client went silent (lock held)."""
        for object_id in [
            o
            for o, t in self._proxy_staging_ts.items()
            if now - t > self.PROXY_STAGING_TTL_S
        ]:
            self._proxy_staging_ts.pop(object_id, None)
            self._proxy_staging.pop(object_id, None)

    def handle_object_put_proxy_abort(self, object_id: str):
        """Client-initiated cleanup of a partially staged proxied put."""
        with self.lock:
            self._proxy_staging.pop(object_id, None)
            self._proxy_staging_ts.pop(object_id, None)
        return True

    def handle_object_put_proxy_commit(
        self, object_id: str, owner: str, total_chunks: int,
        storage: str = "auto",
    ):
        with self.lock:
            chunks = self._proxy_staging.pop(object_id, {})
            self._proxy_staging_ts.pop(object_id, None)
        if len(chunks) != total_chunks:
            raise ClusterError(
                f"proxied put {object_id}: {len(chunks)}/{total_chunks} "
                "chunks arrived"
            )
        payload = b"".join(chunks[i] for i in range(total_chunks))
        return self.handle_object_put_proxy(object_id, payload, owner, storage)

    def handle_object_put_proxy(
        self, object_id: str, payload: bytes, owner: str, storage: str = "auto"
    ):
        """Host a tcp:// client's block on the HEAD node. The client has no
        block server, so the head writes the
        bytes into its own shm (or disk tier) and serves every read; the
        metadata registers under the head's node for locality."""
        from raydp_tpu_torch.store.object_store import host_block_locally

        shm_name = host_block_locally(
            object_id, payload,
            spill_dir=os.path.join(self.session_dir, "spill"),
            storage=storage,
        )
        try:
            with self.lock:
                self._tenant_charge(object_id, len(payload))
                # registered as a DRIVER block, exactly like a put from a
                # local driver: readable everywhere (object_lookup's
                # fetch_addr falls back to the head, which holds the bytes),
                # and invisible to locality-aware dispatch — proxied source
                # blocks must not pin every consumer task onto the head node
                self.objects[object_id] = _ObjectMeta(
                    object_id, owner, shm_name, len(payload), "driver", ""
                )
        except TenantQuotaError:
            # the bytes were already hosted: an over-quota rejection must
            # not leak the just-written segment on the head node
            self._unlink_shm(shm_name)
            raise
        return True

    def _meta_view(self, object_id: str, meta: "_ObjectMeta") -> dict:  # guarded-by: self.lock|self.actor_state_cond held
        """Client-facing lookup record for one object (lock held). Where a
        non-local reader can pull the bytes: the owning node's agent, or the
        head itself for head-node objects. The WRITER-recorded
        namespace is authoritative — a tcp client's blocks carry its
        namespace even though its "node" is the driver."""
        if meta.owner_died:
            self._raise_owner_died(object_id, meta.owner)
        node = self.nodes.get(meta.node_id)
        if node is not None and node.agent_addr is not None:
            fetch_addr = node.agent_addr
        else:
            fetch_addr = self.tcp_addr
        view = {
            "shm_name": meta.shm_name,
            "size": meta.size,
            "owner": meta.owner,
            "node_id": meta.node_id,
            "shm_ns": meta.shm_ns,
            # host axis: readers attribute bytes-over-wire per host edge
            # and the planner scores placement against it
            "host": node.host if node is not None else meta.shm_ns,
            "fetch_addr": fetch_addr,
        }
        # service-owned block: advertise the owner's own socket so remote
        # readers can pull from the first-class owner (TCP only — same-host
        # readers map shm directly and never fetch). fetch_addr stays the
        # agent/head fallback for the service's restart window.
        if meta.owner == self._service_for(
            meta.shm_ns, tenant_of_object(meta.object_id)
        ):
            actor = self.actors.get(meta.owner)
            if (
                actor is not None
                and actor.state == ActorState.ALIVE
                and actor.sock_path
                and actor.sock_path.startswith("tcp://")
            ):
                view["service_addr"] = actor.sock_path
        return view

    def handle_object_lookup(self, object_id: str):
        with self.lock:
            meta = self.objects.get(object_id)
            if meta is None:
                owner = self.owner_tombstones.get(object_id)
                if owner is not None:
                    self._raise_owner_died(object_id, owner)
                return None
            return self._meta_view(object_id, meta)

    def handle_object_put_batch(self, entries: List[dict]):
        """Vectorized registration: one RPC frame registers every block a
        task batch produced (the per-block object_put is the hot metadata
        call of the shuffle map side — M×R frames collapse to one per
        task). Returns ``{object_id: effective_owner}`` for the entries the
        block-service handoff reassigned (empty on the non-handoff path),
        so the writer's cache stays truthful in the same round trip."""
        reassigned: Dict[str, str] = {}
        with self.lock:
            for e in entries:
                # quota check first: a mid-batch rejection leaves earlier
                # entries registered — the writer's batched_registration
                # failure path deletes the whole batch through the head,
                # which credits them back
                self._tenant_charge(e["object_id"], e["size"])
                owner = self._effective_owner(
                    e["owner"], e.get("shm_ns", ""), bool(e.get("handoff")),
                    tenant_of_object(e["object_id"]),
                )
                if owner != e["owner"]:
                    reassigned[e["object_id"]] = owner
                self.objects[e["object_id"]] = _ObjectMeta(
                    e["object_id"], owner, e["shm_name"], e["size"],
                    e["node_id"], e.get("shm_ns", ""),
                )
        return reassigned

    def _batch_meta(self, oid: str, lease: bool):  # guarded-by: self.lock|self.actor_state_cond held
        """One batch entry. Tombstones were already handled: both callers
        pre-raise via _raise_tombstoned_batch (which names EVERY tombstoned
        id of the batch), so an absent id here is a plain None."""
        meta = self.objects.get(oid)
        if meta is None:
            return None
        view = self._meta_view(oid, meta)
        if lease:
            view["lease_s"] = self.LOCATION_LEASE_S
        return view

    def handle_object_lookup_batch(self, object_ids: List[str]):
        """Vectorized lookup: {object_id: meta-or-None} in one frame (the
        reduce side resolves every input slice's block with a single RPC).
        An owner-died object raises, exactly like the single lookup — with
        EVERY tombstoned id of the batch named in the error."""
        with self.lock:
            self._raise_tombstoned_batch(object_ids)
            return {
                oid: self._batch_meta(oid, lease=False) for oid in object_ids
            }

    # how long a client may act on a served location without re-asking: the
    # head-bypass contract (store.cached_location honors it; expired entries
    # take the miss path back here)
    LOCATION_LEASE_S = 120.0

    def handle_object_lookup_lease(self, object_ids: List[str]):
        """Vectorized lookup returning lease-stamped location records:
        ``{object_id: meta-or-None}`` where each meta carries ``lease_s`` —
        the head's promise that acting on the location for that long without
        re-asking is safe (blocks never move; deletion/owner-death makes a
        stale read FAIL, and the reader's fallback re-asks the head, which
        is authoritative). The miss path of the executors' peer-to-peer
        block resolution (store.lookup_many)."""
        with self.lock:
            self._raise_tombstoned_batch(object_ids)
            return {
                oid: self._batch_meta(oid, lease=True) for oid in object_ids
            }

    def handle_object_locations(self, object_ids: List[str]):
        """Batch block→node lookup for locality-aware task dispatch."""
        with self.lock:
            return {
                oid: self.objects[oid].node_id
                for oid in object_ids
                if oid in self.objects and not self.objects[oid].owner_died
            }

    def handle_object_hosts(self, object_ids: List[str]):
        """Batch block→(host, size) lookup — the host-axis twin of
        ``object_locations`` the planner's reduce/exchange placement scorer
        consumes (obs/costmodel.exchange_placement): it needs BYTES per
        host, not just node ids, to put a reducer where its input lives."""
        with self.lock:
            out: Dict[str, tuple] = {}
            for oid in object_ids:
                meta = self.objects.get(oid)
                if meta is None or meta.owner_died:
                    continue
                node = self.nodes.get(meta.node_id)
                host = node.host if node is not None else meta.shm_ns
                out[oid] = (host, meta.size)
            return out

    def handle_block_fetch(self, shm_name: str, offset: int = 0, length: int = -1):
        """Serve a head-node block's bytes to a remote reader (the head plays
        block server for namespace-'' objects; agents serve their own).
        ``offset``/``length`` let readers pull huge blocks in chunks under
        the frame-size cap."""
        from raydp_tpu_torch.cluster.common import serve_block_bytes

        return serve_block_bytes(shm_name, offset, length)

    def handle_object_transfer_owner(self, object_ids: List[str], new_owner: str):
        """Ownership transfer: data outlives the engine that produced it."""
        with self.lock:
            for object_id in object_ids:
                meta = self.objects.get(object_id)
                if meta is not None and not meta.owner_died:
                    meta.owner = new_owner
            return True

    def handle_object_delete(self, object_ids: List[str]):
        with self.lock:
            metas = [
                meta
                for object_id in object_ids
                if (meta := self.objects.pop(object_id, None)) is not None
            ]
            for meta in metas:
                self._tenant_credit(meta)
            for object_id in object_ids:
                # deleting a tombstoned id makes later reads a clean
                # not-found (deliberate deletion), not OwnerDiedError
                self.owner_tombstones.pop(object_id, None)
        self._unlink_objects(metas)
        return True

    def handle_object_rebind(self, mapping: Dict[str, str]):
        """Lineage-recovery rebind: re-register each freshly regenerated
        block (``new_id``, just written + registered by a surviving
        executor) under its ORIGINAL object id, clearing the owner-death
        tombstone — in-flight readers holding the old refs re-resolve and
        find live bytes. Returns how many ids were rebound; a missing
        new-id entry (racing deletion) is skipped and reflected in the
        count so the recovery driver can fail loudly instead of serving a
        half-rebound exchange."""
        rebound = 0
        duplicates: List[_ObjectMeta] = []
        with self.lock:
            for old_id, new_id in mapping.items():
                meta = self.objects.pop(new_id, None)
                if meta is None:
                    continue
                # accounting moves with the id: credit the regenerated id,
                # charge the original UNENFORCED (these bytes were already
                # admitted at registration; a re-attach that shrank the
                # quota below live bytes must not make recovery drop the
                # popped meta mid-loop)
                self._tenant_credit(meta)
                live = self.objects.get(old_id)
                if live is not None and not live.owner_died:
                    # duplicate recovery: another recoverer already rebound
                    # this id — the old ref is LIVE. Keep the winner's meta
                    # and unlink THIS duplicate's freshly written segment
                    # (overwriting would orphan one segment either way);
                    # counted as rebound because the caller's goal — the
                    # old id resolves to live bytes — holds.
                    duplicates.append(meta)
                    rebound += 1
                    continue
                self._tenant_charge(old_id, meta.size, enforce=False)
                meta.object_id = old_id
                self.objects[old_id] = meta
                self.owner_tombstones.pop(old_id, None)
                rebound += 1
        if duplicates:
            # off-lock like every unlink path (agent RPCs can be slow)
            self._unlink_objects(duplicates)
        if rebound:
            obs_metrics.counter("head.objects_rebound").inc(rebound)
            obs_instant("lineage.rebound", blocks=rebound)
        return rebound

    def _unlink_objects(self, metas: List["_ObjectMeta"], wait: bool = False) -> None:
        """Release segments, routing remote-node objects through their agent.
        Never called under the lock (agent RPCs can be slow). ``wait=True``
        (shutdown path) performs the agent RPCs synchronously — fire-and-
        forget threads would race the agents' own teardown and leak
        /dev/shm segments."""
        by_agent: Dict[str, List[str]] = {}
        with self.lock:  # snapshot: the routing loop itself stays off-lock
            nodes = dict(self.nodes)
        for meta in metas:
            node = nodes.get(meta.node_id)
            if node is not None and node.agent_addr is not None:
                by_agent.setdefault(node.agent_addr, []).append(meta.shm_name)
            else:
                self._unlink_shm(meta.shm_name)
        for agent_addr, names in by_agent.items():
            def _fire(addr=agent_addr, shm_names=names):
                try:
                    rpc(addr, ("unlink_shm", {"shm_names": shm_names}), timeout=10)
                except Exception:
                    # agent gone: its /dev/shm died with the node — but a
                    # LIVE node failing unlinks would leak segments, so
                    # count it (the store.delete_failures lesson)
                    obs_metrics.counter("head.unlink_shm_failures").inc(
                        len(shm_names)
                    )

            if wait:
                _fire()
            else:
                threading.Thread(target=_fire, daemon=True).start()

    def handle_object_reown_all(self, old_owner: str, new_owner: str) -> int:
        """Transfer EVERY live object owned by ``old_owner`` to ``new_owner``
        — the graceful-scale-down primitive: executors killed by dynamic
        allocation (or kill_executors) must not take still-referenced blocks
        with them (their shm segments/spill files survive the process; only
        owner-death GC would destroy them)."""
        moved = 0
        with self.lock:
            for meta in self.objects.values():
                if meta.owner == old_owner and not meta.owner_died:
                    meta.owner = new_owner
                    moved += 1
        return moved

    def handle_object_owner_of(self, object_id: str):
        with self.lock:
            meta = self.objects.get(object_id)
            return None if meta is None else meta.owner

    @staticmethod
    def _unlink_shm(shm_name: str) -> None:
        from raydp_tpu_torch.cluster.common import unlink_block

        unlink_block(shm_name)

    TOMBSTONE_CAP = 16384

    def _tombstone(self, object_id: str, owner: str) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        self.owner_tombstones[object_id] = owner
        self.owner_tombstones.move_to_end(object_id)
        while len(self.owner_tombstones) > self.TOMBSTONE_CAP:
            self.owner_tombstones.popitem(last=False)

    def _raise_owner_died(self, object_id: str, owner: str) -> None:
        """OwnerDiedError carrying structured fields: the client's lineage
        recovery reads ``object_ids`` and its dead-owner fast path reads
        ``owner`` (BaseException pickling preserves the instance dict)."""
        err = OwnerDiedError(
            f"object {object_id}: owner {owner!r} died and the object was "
            "not transferred before the owner exited"
        )
        err.object_ids = [object_id]
        err.owner = owner
        raise err

    def _raise_tombstoned_batch(self, object_ids: List[str]) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        """Raise for a batch naming EVERY tombstoned id in it, not just the
        first: the client's lineage recovery re-executes the whole named set
        in one round — one-id-at-a-time errors would burn one retry attempt
        per lost block and exhaust the task ladder on wide losses."""
        dead = {
            oid: owner
            for oid in object_ids
            if oid not in self.objects
            and (owner := self.owner_tombstones.get(oid)) is not None
        }
        if not dead:
            return
        err = OwnerDiedError(
            f"object(s) {list(dead)[:3]}{'…' if len(dead) > 3 else ''}: "
            f"owner(s) died and the objects were not transferred "
            f"({len(dead)} of {len(object_ids)} requested)"
        )
        err.object_ids = list(dead)
        err.owner = next(iter(dead.values()))
        raise err

    def _on_owner_dead(self, owner: str) -> None:  # guarded-by: self.lock|self.actor_state_cond held
        dead = []
        for meta in list(self.objects.values()):
            if meta.owner == owner and not meta.owner_died:
                meta.owner_died = True
                dead.append(meta)
                # proactive unregister: pop the record NOW (an intentional
                # kill_executors/stop used to leave owner-died metas in the
                # table forever) and tombstone the id so reads keep raising
                # OwnerDiedError until a lineage rebind revives it
                del self.objects[meta.object_id]
                self._tenant_credit(meta)
                self._tombstone(meta.object_id, owner)
        if dead:
            obs_metrics.counter("head.objects_unregistered").inc(len(dead))
            # called under the lock (monitor/death paths): release segments
            # from a thread so a slow/dead agent can't stall the head
            threading.Thread(
                target=self._unlink_objects, args=(dead,), daemon=True
            ).start()

    # ---------- observability (obs layer aggregation) ----------

    # ---------- observability (obs layer aggregation) ----------

    def handle_obs_ingest(
        self, proc: dict, spans: List[dict], metrics_snapshot: dict,
        logs: Optional[List[dict]] = None,
    ):
        """A process flushed its span ring buffer + metrics registry (+ its
        flight-recorder log ring) here. Metrics snapshots are cumulative per
        process — replace, keyed by (role, pid); spans append into the
        bounded deque, with evictions counted PER ROLE
        (``obs.ingest_evictions.<role>``) so a chatty role squeezing the
        others out of the trace ring is visible in ``dump_metrics``."""
        role = proc.get("role", "proc")
        key = f"{role}:{proc.get('pid', 0)}"
        with self.lock:
            if spans:
                overflow = (
                    len(self.obs_spans) + len(spans) - (self.obs_spans.maxlen or 0)
                )
                if overflow > 0:
                    self.obs_dropped += overflow
                    # the evicted spans are the OLDEST resident entries (or,
                    # past capacity, the head of the incoming batch): count
                    # each against its own role so the victim is named
                    evicted = list(
                        _itertools.islice(self.obs_spans, 0, overflow)
                    )
                    if overflow > len(self.obs_spans):
                        evicted.extend(spans[: overflow - len(evicted)])
                    by_role: Dict[str, int] = {}
                    for record in evicted:
                        victim_role = str(
                            record.get("proc", "proc")
                        ).split(":", 1)[0]
                        by_role[victim_role] = by_role.get(victim_role, 0) + 1
                    for victim_role, count in by_role.items():
                        obs_metrics.counter(
                            f"obs.ingest_evictions.{victim_role}"
                        ).inc(count)
                self.obs_spans.extend(spans)
            if metrics_snapshot:
                metrics_snapshot = dict(metrics_snapshot)
                if proc.get("dropped"):
                    metrics_snapshot["trace.spans_dropped"] = {
                        "type": "counter", "value": proc["dropped"],
                    }
                self.obs_metrics[key] = metrics_snapshot
        # TSDB + flight recorder rides OUTSIDE self.lock: both have their
        # own leaf locks, and neither belongs on the actor-table critical
        # section (a scrape-sized ingest must not stall spawns)
        if metrics_snapshot:
            self.tsdb.ingest(key, role, metrics_snapshot)
        self.flight.note_ingest(key, role, spans or [], metrics_snapshot, logs)
        return True

    def handle_obs_configure(
        self,
        head_ring_spans: Optional[int] = None,
        dossier_dir: Optional[str] = None,
        scrape_port: Optional[int] = None,
    ):
        """Session-boot configuration of the telemetry plane (``obs.*``
        confs, docs/observability.md): resize the head span ring, point the
        dossier dir, and/or start the Prometheus scrape endpoint (idempotent
        — a second session reuses the running server). Returns the live
        settings including the bound scrape address."""
        import collections as _collections

        with self.lock:
            if head_ring_spans is not None and int(head_ring_spans) > 0:
                cap = int(head_ring_spans)
                if cap != (self.obs_spans.maxlen or 0):
                    self.obs_spans = _collections.deque(
                        self.obs_spans, maxlen=cap
                    )
            if dossier_dir:
                self.dossier_dir = str(dossier_dir)
            ring_cap = self.obs_spans.maxlen
            out_dir = self.dossier_dir
        if scrape_port is not None:
            addr = self._ensure_scrape_server(int(scrape_port))
        else:
            addr = self.handle_obs_scrape_addr()
        return {
            "head_ring_spans": ring_cap,
            "dossier_dir": out_dir,
            "scrape_addr": addr,
        }

    def _ensure_scrape_server(self, port: int):
        """Start (or return) the scrape endpoint. Serialized by its own
        LEAF lock (never self.lock — the bind is I/O), so two sessions
        configuring at once cannot race a second live server into
        existence: one server serves, every caller gets its address."""
        with self._scrape_lock:
            server = self.scrape_server
            if server is None:
                from raydp_tpu_torch.obs.timeseries import ScrapeServer

                server = self.scrape_server = ScrapeServer(
                    self.tsdb, port=port
                )
                obs_log.info(
                    "scrape endpoint up", host=server.host, port=server.port
                )
            return (server.host, server.port)

    def handle_obs_scrape_addr(self):
        with self._scrape_lock:
            server = self.scrape_server
            return (server.host, server.port) if server is not None else None

    def close_scrape_server(self) -> None:
        with self._scrape_lock:
            server = self.scrape_server
            self.scrape_server = None
        if server is not None:
            server.close()

    def handle_obs_query_series(
        self,
        name,
        window_s: float = 60.0,
        labels: Optional[dict] = None,
        aggregate: bool = False,
    ):
        """``cluster.query_metrics`` read side: matching series from the
        head TSDB (or the windowed aggregate). ``name`` may be a LIST of
        metric names — one round trip answers a whole signal group
        (``tenancy.fair_share_series`` reads five in one RPC), returned as
        ``{name: result}``."""
        if isinstance(name, (list, tuple)):
            return {
                n: (
                    self.tsdb.windowed(n, window_s, labels) if aggregate
                    else self.tsdb.query(n, window_s, labels)
                )
                for n in name
            }
        if aggregate:
            return self.tsdb.windowed(name, window_s, labels)
        return self.tsdb.query(name, window_s, labels)

    def handle_obs_dossier(
        self, reason: str, victim: Optional[dict] = None,
        needle: Optional[str] = None,
    ):
        """Driver-triggered dossier (unrecovered query, sanitizer finding):
        assemble + write synchronously and return the path."""
        head_state = self._dossier_head_state()
        victim_keys = (
            self.flight.find_victim_keys(needle) if needle
            else self.flight.proc_keys()
        )
        dossier = self.flight.assemble(
            reason, victim_keys=victim_keys, victim=victim,
            head_state=head_state,
        )
        path = self.flight.write(dossier, self.dossier_dir)
        if path:
            obs_metrics.counter("obs.dossiers_written").inc()
        return path

    def _dossier_head_state(self) -> dict:
        """Snapshot of the head's authoritative tables for a dossier —
        cheap dict building only."""
        with self.lock:
            actors = [
                {
                    "actor_id": a.spec.actor_id,
                    "name": a.spec.name,
                    "state": str(a.state),
                    "pid": a.proc.pid if a.proc is not None else None,
                    "node": a.node_id,
                    "incarnation": a.incarnation,
                    "restarts_used": a.restarts_used,
                    "intentional_exit": a.intentional_exit,
                    "error": str(a.error)[:300] if a.error else None,
                }
                for a in self.actors.values()
            ]
            tenants = {
                name: {
                    k: v for k, v in record.items()
                    if isinstance(v, (int, float, str, bool))
                }
                for name, record in self.tenants.items()
            }
            # memory watermark plane (obs/profiler.py): every process's
            # newest mem.* gauges (live value + high watermark) from its
            # shipped registry snapshot — the dossier's memory section
            memory = {}
            for proc_key, snapshot in self.obs_metrics.items():
                mem = {
                    name: {
                        "value": snap.get("value"),
                        "max": snap.get("max"),
                    }
                    for name, snap in snapshot.items()
                    if name.startswith("mem.") and isinstance(snap, dict)
                }
                if mem:
                    memory[proc_key] = mem
            return {
                "actors": actors,
                "tenants": tenants,
                "memory": memory,
                "objects": len(self.objects),
                "block_services": {
                    f"{ns or '-'}::{tenant or '-'}": actor_id
                    for (ns, tenant), actor_id in self.block_services.items()
                },
                "nodes": len(self.nodes),
                "obs_ring": {
                    "spans": len(self.obs_spans),
                    "cap": self.obs_spans.maxlen,
                    "dropped": self.obs_dropped,
                },
            }

    def _write_crash_dossier(self, reason: str, victim: dict,
                             needle: str) -> None:
        """Assemble + write a dossier for one actor death on a DETACHED
        thread: the caller holds self.lock (monitor/death paths) and the
        write is file I/O."""
        head_state = self._dossier_head_state()

        def _write():
            try:
                dossier = self.flight.assemble(
                    reason,
                    victim_keys=self.flight.find_victim_keys(needle),
                    victim=victim, head_state=head_state,
                )
                if self.flight.write(dossier, self.dossier_dir):
                    obs_metrics.counter("obs.dossiers_written").inc()
            except Exception:  # dossiers are evidence, never a new failure mode: a full disk must not take the death path down
                pass

        threading.Thread(target=_write, name="dossier-writer",
                         daemon=True).start()

    def handle_obs_dump(self, clear: bool = False):
        """Everything collected so far (export_trace / dump_metrics read
        side). The head contributes its own local buffer and registry too —
        it never RPCs itself."""
        from raydp_tpu_torch.obs.metrics import metrics as local_metrics
        from raydp_tpu_torch.obs.tracing import drain_local, process_role

        own = drain_local()
        with self.lock:
            if own:
                self.obs_spans.extend(own)
            snapshot = local_metrics.snapshot()
            if snapshot:
                self.obs_metrics[f"{process_role()}:{os.getpid()}"] = snapshot
            out = {
                "spans": list(self.obs_spans),
                "metrics": dict(self.obs_metrics),
                "dropped": self.obs_dropped,
            }
            if clear:
                self.obs_spans.clear()
                self.obs_metrics.clear()
                self.obs_dropped = 0
        return out

    # ---------- lifecycle ----------

    def handle_ping(self):
        return "pong"

    def handle_shutdown(self):
        with self.lock:
            self.shutting_down = True
            for actor in self.actors.values():
                actor.intentional_exit = True
                self._kill_proc(actor)
            metas = list(self.objects.values())
            self.objects.clear()
            agents = [
                n.agent_addr for n in self.nodes.values() if n.agent_addr
            ]
        self._unlink_objects(metas, wait=True)
        for agent_addr in agents:
            try:
                rpc(agent_addr, ("stop", {}), timeout=5)
            except Exception:  # advisory stop; the agent's head-liveness watchdog exits it
                pass  # the agent's own head-liveness watchdog will exit it
        return True

    def monitor_loop(self) -> None:
        last_zygote_check = 0.0
        last_self_ingest = 0.0
        while not self.shutting_down:
            time.sleep(0.05)
            with self.lock:
                for actor in list(self.actors.values()):
                    if actor.state == ActorState.DEAD:
                        continue
                    if actor.pending_respawn:
                        self._try_respawn(actor)
                        continue
                    if actor.proc is not None and actor.proc.poll() is not None:
                        self._on_actor_death(actor)
            # zygote liveness: spawns silently degrade to cold starts
            # if the fork template dies — restart it (cheap pid probe, 2s
            # cadence; launch_worker's cold fallback covers the gap)
            now = time.monotonic()
            if now - last_self_ingest > 1.0:
                last_self_ingest = now
                # the head's ~1s telemetry tick: ship its OWN registry (the
                # authoritative per-tenant byte gauges live here) through
                # the direct-ingest hook so the TSDB behind the scrape
                # endpoint always carries fresh head-side series
                try:
                    from raydp_tpu_torch.obs.tracing import flush_throttled

                    flush_throttled(1.0)
                except Exception:  # a telemetry tick must never take the monitor loop down
                    pass
            if now - last_zygote_check > 2.0:
                last_zygote_check = now
                self._ensure_zygote()
                with self.lock:
                    self._gc_proxy_staging(now)
            # driver liveness: tear everything down if the driver is gone
            if self.driver_pid and not _pid_alive(self.driver_pid):
                self.handle_shutdown()
                os._exit(0)

    def _ensure_zygote(self) -> None:
        from raydp_tpu_torch.cluster.common import start_zygote, zygote_alive

        if zygote_alive(self.session_dir):
            return
        try:
            start_zygote(self.session_dir)
        except Exception:
            # spawns keep falling back to cold subprocess starts (their
            # imports each) — log so slow restarts are attributable
            obs_log.warning("zygote restart failed", exc_info=True)

    def agent_watchdog_loop(self) -> None:
        """Agent liveness: agents watch the head, the head watches agents.
        An unreachable agent (crashed host) gets its node marked dead and
        its actors recycled — otherwise they'd stay ALIVE forever and
        callers would hang retrying a dead tcp:// address. Runs on its OWN
        thread with concurrent probes so blocking 3s pings of several dead
        hosts cannot stall local death detection or driver teardown."""
        agent_last_ok: Dict[str, float] = {}
        while not self.shutting_down:
            time.sleep(2.0)
            with self.lock:
                agent_nodes = [
                    (n.node_id, n.agent_addr)
                    for n in self.nodes.values()
                    if n.alive and n.agent_addr is not None
                ]
            if not agent_nodes:
                continue
            now = time.monotonic()
            results: Dict[str, bool] = {}

            def probe(node_id=None, agent_addr=None):
                try:
                    rpc(agent_addr, ("ping", {}), timeout=3)
                    results[node_id] = True
                except Exception:
                    results[node_id] = False

            threads = [
                threading.Thread(target=probe, kwargs={"node_id": nid, "agent_addr": addr})
                for nid, addr in agent_nodes
            ]
            for t in threads:
                t.start()
            for t in threads:
                # bounded join with slack over the probes' own 3s rpc
                # timeout: a probe stuck past its timeout (half-open TCP,
                # resolver hang) must not park this watchdog forever.
                # Stragglers report into `results` late; the
                # snapshot below keeps their mutation off this iteration
                # and the next sweep picks the node up again.
                t.join(timeout=10.0)
            for node_id, ok in dict(results).items():
                if ok:
                    agent_last_ok[node_id] = now
                    continue
                if now - agent_last_ok.get(node_id, now) > 15.0:
                    try:
                        self.handle_remove_node(node_id)
                    except ClusterError:  # node already removed by a concurrent path
                        pass
                    agent_last_ok.pop(node_id, None)
                else:
                    agent_last_ok.setdefault(node_id, now)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _unknown_method_error(head: "Head", method: str) -> ClusterError:
    """A self-diagnosing unknown-op error: under version skew (old client /
    new head or vice versa) the raw ``unknown head method 'x'`` forced a
    source dive — naming the nearest ``handle_*`` candidates turns a renamed
    op into a one-glance fix. Counted so a fleet speaking a drifted protocol
    shows up in telemetry, not just in one caller's traceback."""
    obs_metrics.counter("head.unknown_method_calls").inc()
    ops = sorted(
        name[len("handle_"):]
        for name in dir(head)
        if name.startswith("handle_") and callable(getattr(head, name))
    )
    near = difflib.get_close_matches(method, ops, n=3, cutoff=0.5)
    hint = f" (nearest handlers: {', '.join(near)})" if near else ""
    return ClusterError(f"unknown head method {method!r}{hint}")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        head: Head = self.server.head  # type: ignore[attr-defined]
        token = getattr(self.server, "token", None)
        if token is not None:  # TCP: authenticate before any unpickling
            from raydp_tpu_torch.cluster.common import verify_token

            if not verify_token(self.request, token):
                return
        # serve frames until the peer hangs up: one-shot clients close after
        # the first reply (loop exits on EOF), pooled clients keep the
        # connection for their lifetime and skip per-call connect+accept
        while True:
            try:
                frame = recv_frame(self.request)
            except (EOFError, OSError):
                return
            frame, trace_ctx = unwrap_traced(frame)
            method, kwargs = frame
            try:
                fn = getattr(head, f"handle_{method}", None)
                if fn is None:
                    raise _unknown_method_error(head, method)
                if trace_ctx is not None and not method.startswith("obs_"):
                    # adopt the caller's trace: the head's handling of a
                    # traced control-plane call becomes a child span on the
                    # head's own track (obs ship/dump calls stay untraced —
                    # tracing the trace plane would feed back on itself)
                    with obs_use_context(trace_ctx), obs_span(
                        f"head.{method}"
                    ):
                        result = fn(**kwargs)
                else:
                    result = fn(**kwargs)
                reply = ("ok", result)
            except BaseException as exc:  # noqa: BLE001 - propagate to caller
                exc.__cause__ = None
                reply = ("err", exc)
            try:
                send_frame(self.request, reply)
            except OSError:
                return
            except Exception:
                # unpicklable reply: report it without severing the pooled
                # connection (the CALLER still needs a frame)
                try:
                    send_frame(
                        self.request,
                        ("err", ClusterError("head reply could not be serialized")),
                    )
                except OSError:
                    return


# fault injection: seconds the head sleeps between its socket's bind and
# its listen (tests show that ``init`` waits it out)
HEAD_LISTEN_DELAY_ENV = "RAYDP_TPU_TORCH_HEAD_LISTEN_DELAY_S"


class _Server(socketserver.ThreadingUnixStreamServer):
    """The head's Unix listener. Its socket file appears only once it
    listens (``common.bind_listening``): ``cluster.init`` waits for the path
    and then calls, so a head descheduled between bind and listen must not
    show the path yet."""

    daemon_threads = True
    allow_reuse_address = True

    def server_bind(self):
        pass  # bound in server_activate, beside the path, then renamed

    def server_activate(self):
        delay = float(os.environ.get(HEAD_LISTEN_DELAY_ENV) or 0.0)
        bind_listening(self.socket, self.server_address,
                       self.request_queue_size,
                       before_listen=(lambda: time.sleep(delay)) if delay > 0
                       else None)


class _TcpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def _advertised_ip() -> str:
    """The IP other hosts can reach this head on: the address of the
    interface that carries the default route (``/proc/net/route``), read
    with an ioctl, so finding it sends nothing to any host; loopback when
    the host has no such route (single-machine sessions)."""
    import fcntl
    import struct

    try:
        with open("/proc/net/route") as f:
            rows = [line.split() for line in f.readlines()[1:]]
        iface = next(row[0] for row in rows
                     if len(row) > 2 and row[1] == "00000000")
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
            packed = fcntl.ioctl(probe.fileno(), 0x8915,  # SIOCGIFADDR
                                 struct.pack("256s", iface[:15].encode()))
        return socket.inet_ntoa(packed[20:24])
    except (OSError, StopIteration):
        return "127.0.0.1"


def run_head(session_dir: str, driver_pid: int, default_resources: Dict[str, float]) -> None:
    from raydp_tpu_torch.obs.tracing import set_local_ingest, set_process_role

    set_process_role("head")
    sanitize.snapshot_baseline()
    head = Head(session_dir, driver_pid, default_resources)
    # the head's own spans/metrics ingest directly — no RPC loopback
    set_local_ingest(head.handle_obs_ingest)
    server = _Server(head_sock_path(session_dir), _Handler)
    server.head = head  # type: ignore[attr-defined]
    # TCP beside the Unix socket: node agents (and their actors) on other
    # hosts address the head through this; the bound address is published in
    # the session dir for local discovery and passed by env to remote actors
    tcp_server = _TcpServer(("0.0.0.0", 0), _Handler)
    tcp_server.head = head  # type: ignore[attr-defined]
    from raydp_tpu_torch.cluster.common import TOKEN_ENV, load_token

    token = load_token(session_dir)
    tcp_server.token = token  # type: ignore[attr-defined]
    # the head itself dials TCP peers (agents) and its env predates the
    # token file — adopt it so outgoing connects authenticate; worker spawns
    # inherit it too
    os.environ[TOKEN_ENV] = token.hex()
    # pre-warmed fork template: light-actor spawns become forks instead of
    # cold interpreter starts. cluster.init usually started one
    # EAGERLY before this head booted (its warm-up is the first session's
    # critical path) — a second one here would rebind the socket over it and
    # double the import work
    from raydp_tpu_torch.cluster.common import start_zygote, zygote_alive

    try:
        if not zygote_alive(session_dir):
            start_zygote(session_dir)
    except Exception:
        obs_log.warning(
            "zygote start failed at head boot; spawns fall back to cold "
            "subprocess starts", exc_info=True,
        )
    head.tcp_addr = f"tcp://{_advertised_ip()}:{tcp_server.server_address[1]}"
    tcp_path = os.path.join(session_dir, HEAD_TCP_FILE)
    with open(tcp_path + ".tmp", "w") as f:
        f.write(head.tcp_addr)
    os.replace(tcp_path + ".tmp", tcp_path)
    threading.Thread(
        target=tcp_server.serve_forever, kwargs={"poll_interval": 0.2}, daemon=True
    ).start()
    monitor = threading.Thread(target=head.monitor_loop, name="monitor", daemon=True)
    monitor.start()
    threading.Thread(
        target=head.agent_watchdog_loop, name="agent-watchdog", daemon=True
    ).start()
    server.timeout = 0.2
    try:
        while not head.shutting_down:
            server.handle_request()
    finally:
        server.server_close()
        tcp_server.shutdown()
        tcp_server.server_close()
        head.close_scrape_server()
        try:
            sanitize.audit_leaks("head")
        except sanitize.LeakError:
            obs_log.error("head leaked resources at shutdown", exc_info=True)
