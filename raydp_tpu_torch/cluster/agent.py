"""Node agent: one per (real or simulated) additional host, the port's own
copy of ``raydp_tpu/cluster/agent.py``.

An agent process:

- registers its node (resources, IP, shm namespace) with the head over TCP;
- forks/kills actor worker processes on ITS host when the head schedules
  actors there (the spec ships in the RPC -- no shared filesystem assumed);
- watches its children and reports deaths so the head can restart actors
  with the same identity.

The JAX agent also serves its node's shared-memory blocks to remote readers
and unlinks them for the head (``block_fetch``, ``unlink_shm``); those come
with the port's store.

On one machine an agent with its own shm NAMESPACE stands in for a separate
host.
"""

from __future__ import annotations

import json
import os
import signal
import socketserver
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

import cloudpickle

from raydp_tpu_torch.cluster.common import (
    HEAD_ADDR_ENV,
    SESSION_ENV,
    SHM_NS_ENV,
    ActorSpec,
    ClusterError,
    host_id as common_host_id,
    recv_frame,
    rpc,
    send_frame,
    unwrap_traced,
)
from raydp_tpu_torch.obs import log as obs_log
from raydp_tpu_torch.obs import span as obs_span
from raydp_tpu_torch.obs import use_context as obs_use_context


class _ChildProc:
    def __init__(self, proc: subprocess.Popen, incarnation: int):
        self.proc = proc
        self.incarnation = incarnation


class NodeAgent:
    def __init__(
        self,
        head_addr: str,
        node_ip: str,
        resources: Dict[str, float],
        shm_ns: str,
        local_dir: str,
    ):
        self.head_addr = head_addr
        self.node_ip = node_ip
        self.resources = dict(resources)
        self.shm_ns = shm_ns
        self.local_dir = local_dir
        os.makedirs(local_dir, exist_ok=True)
        self.children: Dict[str, _ChildProc] = {}
        # highest incarnation ever spawned here, per actor id. The fence
        # must survive the children-table entry (monitor_loop deletes it
        # after a death report) or a delayed stale spawn arriving AFTER the
        # newer worker died would resurrect a fenced-out incarnation as a
        # leaked live process nothing will ever kill.
        self.incarnation_floor: Dict[str, int] = {}
        # floor entries outlive the children table only for the stale-
        # delivery window; after this grace period with no respawn the entry
        # is pruned (an agent under actor churn must not grow one floor per
        # actor id ever spawned, forever). Scheduled when a death report
        # removes the children entry; cancelled by a fresh spawn.
        self.FLOOR_PRUNE_GRACE_S = 600.0
        self._floor_prune_at: Dict[str, float] = {}
        from raydp_tpu_torch import sanitize

        self.lock = sanitize.named_lock("agent.lock", threading.RLock())
        self.stopping = False
        self.addr: Optional[str] = None
        self.node_id: Optional[str] = None
        self.stats = {"spawned": 0}

    # ---------- handlers (same frame protocol as head/actors) ----------

    def handle_ping(self):
        return "pong"

    # operator introspection surface: poked ad hoc over the agent socket,
    # no in-tree call site
    def handle_stats(self):
        with self.lock:
            return dict(self.stats)

    def handle_spawn_actor(self, spec: ActorSpec, incarnation: int, head_addr: str):
        """Fork the worker on THIS host. The spec arrives in the RPC and is
        written to the agent's local dir — no shared filesystem with the head
        is assumed (the head-local path writes it to the session dir)."""
        # Fence BEFORE forking: spawn RPCs land on server threads, so a
        # delayed stale delivery (the fenced-out incarnation whose reply the
        # head lost) can arrive AFTER the newer respawn already runs here.
        # Ordering, not inequality, decides who is stale — a stale spawn must
        # never kill or displace the newer healthy worker.
        with self.lock:
            if self.incarnation_floor.get(spec.actor_id, -1) >= incarnation:
                return False  # newer (or duplicate) spawn already owned the id
        spec_path = os.path.join(self.local_dir, f"a-{spec.actor_id}.spec")
        with open(spec_path + ".tmp", "wb") as f:
            cloudpickle.dump(spec, f)
        os.replace(spec_path + ".tmp", spec_path)

        env = dict(os.environ)
        env.update(spec.env)
        env[SESSION_ENV] = self.local_dir
        env[HEAD_ADDR_ENV] = head_addr or self.head_addr
        env[SHM_NS_ENV] = self.shm_ns
        from raydp_tpu_torch.cluster.common import TOKEN_ENV

        if os.environ.get(TOKEN_ENV):  # workers authenticate over TCP too
            env[TOKEN_ENV] = os.environ[TOKEN_ENV]
        env["RAYDP_TPU_TORCH_ACTOR_ID"] = spec.actor_id
        env["RAYDP_TPU_TORCH_NODE_ID"] = self.node_id or ""
        env["RAYDP_TPU_TORCH_NODE_IP"] = self.node_ip
        env["RAYDP_TPU_TORCH_TCP"] = "1"  # actors must be reachable across hosts
        from raydp_tpu_torch.cluster.common import launch_worker

        proc = launch_worker(spec, incarnation, self.local_dir, env)
        with self.lock:
            old = self.children.get(spec.actor_id)
            if self.incarnation_floor.get(spec.actor_id, -1) >= incarnation:
                # a newer spawn landed while we were forking: OURS is the
                # stale one — reap it and leave the newer worker untouched.
                # The just-forked child may not have setsid'd yet (no
                # process group of its own), so fall back to a direct kill
                # rather than letting it survive untracked.
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    try:
                        os.kill(proc.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):  # kill of an already-dead process is idempotent
                        pass
                except PermissionError:  # killpg fallback; plain kill already sent
                    pass
                return False
            # an OLDER incarnation still running here is by definition stale
            # once the head spawns a newer one: kill it before its
            # children-table entry — and with it the only pid we hold — is
            # overwritten, or it would leak as a live process for the life
            # of the node
            if old is not None and old.proc.poll() is None:
                try:
                    os.killpg(old.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):  # kill of an already-dead process is idempotent
                    pass
            self.children[spec.actor_id] = _ChildProc(proc, incarnation)
            self.incarnation_floor[spec.actor_id] = incarnation
            self._floor_prune_at.pop(spec.actor_id, None)  # live again
            self.stats["spawned"] += 1
        return True

    def handle_kill_actor(self, actor_id: str, incarnation: int = -1):
        """Kill a locally-hosted worker. ``incarnation`` >= 0 restricts the
        kill to that exact spawn — the head's fence-out of a possibly-
        delivered stale spawn must not hit a newer healthy replacement that
        was respawned onto this agent in the meantime."""
        with self.lock:
            child = self.children.get(actor_id)
            if (
                child is not None
                and incarnation >= 0
                and child.incarnation != incarnation
            ):
                return False  # a different (newer) spawn owns the id now
        if child is not None and child.proc.poll() is None:
            try:
                os.killpg(child.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):  # kill of an already-dead process is idempotent
                pass
        return True

    def handle_stop(self):
        self.stopping = True
        with self.lock:
            for child in self.children.values():
                if child.proc.poll() is None:
                    try:
                        os.killpg(child.proc.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):  # kill of an already-dead process is idempotent
                        pass
        return True

    # ---------- lifecycle ----------

    def monitor_loop(self):
        """Report child deaths so the head can run its restart bookkeeping
        (identical semantics to the head's local proc.poll monitoring), and
        watch head liveness: an agent must not outlive its cluster."""
        last_head_ok = time.monotonic()
        last_ping = 0.0
        last_zygote_check = 0.0
        while not self.stopping:
            time.sleep(0.05)
            # zygote liveness (same role as the head's _ensure_zygote, for
            # THIS node): a dead fork template silently degrades every light
            # spawn/restart here to cold starts
            now = time.monotonic()
            if now - last_zygote_check > 2.0:
                last_zygote_check = now
                from raydp_tpu_torch.cluster.common import start_zygote, zygote_alive

                if not zygote_alive(self.local_dir):
                    try:
                        start_zygote(self.local_dir)
                    except Exception:
                        # cold-start fallback keeps working, but every spawn
                        # on this node now pays its imports — say so
                        obs_log.warning(
                            "zygote restart failed; spawns fall back to "
                            "cold subprocess starts", exc_info=True,
                        )
            dead = []
            with self.lock:
                for actor_id, child in list(self.children.items()):
                    if child.proc.poll() is not None:
                        dead.append((actor_id, child.incarnation))
            for actor_id, incarnation in dead:
                obs_log.warning(
                    "hosted actor exited", actor_id=actor_id,
                    incarnation=incarnation,
                )
                try:
                    rpc(
                        self.head_addr,
                        (
                            "actor_exited",
                            {"actor_id": actor_id, "incarnation": incarnation},
                        ),
                        timeout=10,
                    )
                    last_head_ok = time.monotonic()
                except Exception:  # death report kept and retried next loop
                    continue  # keep the entry: retried next loop — a death
                    # report must not be lost to a transient head blip
                with self.lock:
                    # the head may have ALREADY respawned this actor while we
                    # were reporting (its spawn RPC lands on the server
                    # thread): only remove the entry we actually reported
                    current = self.children.get(actor_id)
                    if current is not None and current.incarnation == incarnation:
                        del self.children[actor_id]
                        # keep the incarnation fence for the stale-delivery
                        # window only; schedule its pruning
                        self._floor_prune_at[actor_id] = (
                            time.monotonic() + self.FLOOR_PRUNE_GRACE_S
                        )
            now = time.monotonic()
            if now - last_ping >= 2.0:
                last_ping = now
                from raydp_tpu_torch.obs import flush_throttled as obs_flush_throttled

                # piggyback the telemetry flush on the ping cadence so agent
                # spans/metrics reach the head without a dedicated flusher
                # thread (metrics push with tracing off too)
                obs_flush_throttled(2.0)
                with self.lock:
                    for actor_id in [
                        a
                        for a, t in self._floor_prune_at.items()
                        if now >= t and a not in self.children
                    ]:
                        self._floor_prune_at.pop(actor_id, None)
                        self.incarnation_floor.pop(actor_id, None)
                try:
                    rpc(self.head_addr, ("ping", {}), timeout=5)
                    last_head_ok = now
                except Exception:
                    # expected while the head is briefly unreachable; the
                    # 15s watchdog below decides — the counter makes flaky
                    # links visible without log spam
                    from raydp_tpu_torch.obs import metrics

                    metrics.counter("agent.head_ping_failures").inc()
            if now - last_head_ok > 15.0:
                # head gone: tear down children and exit (parity: Ray nodes
                # die with their GCS; prevents orphaned agent processes)
                self.handle_stop()
                return

    def serve(self):
        agent = self

        from raydp_tpu_torch.cluster.common import session_token, verify_token

        token = session_token()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                if not verify_token(self.request, token):
                    return
                try:
                    frame = recv_frame(self.request)
                except (ConnectionError, EOFError):
                    return
                frame, trace_ctx = unwrap_traced(frame)
                method, kwargs = frame
                try:
                    fn = getattr(agent, f"handle_{method}", None)
                    if fn is None:
                        raise ClusterError(f"unknown agent method {method!r}")
                    if trace_ctx is not None:
                        with obs_use_context(trace_ctx), obs_span(
                            f"agent.{method}"
                        ):
                            reply = ("ok", fn(**kwargs))
                    else:
                        reply = ("ok", fn(**kwargs))
                except BaseException as exc:  # noqa: BLE001
                    reply = ("err", exc)
                try:
                    send_frame(self.request, reply)
                except ConnectionError:  # peer hung up; no one left to reply to
                    pass

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        server = Server(("0.0.0.0", 0), Handler)
        self.addr = f"tcp://{self.node_ip}:{server.server_address[1]}"
        self.node_id = rpc(
            self.head_addr,
            (
                "register_agent",
                {
                    "resources": self.resources,
                    "node_ip": self.node_ip,
                    "agent_addr": self.addr,
                    "shm_ns": self.shm_ns,
                    # host axis: RAYDP_TPU_TORCH_HOST_ID when set (real multi-host
                    # or the simulated harness), else the shm namespace —
                    # which already has host granularity
                    "host": common_host_id(),
                },
            ),
            timeout=30,
        )
        # pre-warmed fork template for THIS node's light actors (same role as
        # the head's zygote; launch_worker routes through it)
        from raydp_tpu_torch.cluster.common import start_zygote

        try:
            start_zygote(self.local_dir)
        except Exception:
            obs_log.warning(
                "zygote start failed at agent boot; spawns fall back to "
                "cold subprocess starts", exc_info=True,
            )
        # publish readiness for whoever launched us
        ready = os.path.join(self.local_dir, "agent_ready.json")
        with open(ready + ".tmp", "w") as f:
            json.dump({"addr": self.addr, "node_id": self.node_id}, f)
        os.replace(ready + ".tmp", ready)
        threading.Thread(target=self.monitor_loop, daemon=True).start()
        server.timeout = 0.2
        try:
            while not self.stopping:
                server.handle_request()
        finally:
            server.server_close()
            from raydp_tpu_torch import sanitize

            try:
                sanitize.audit_leaks(f"agent:{self.node_ip}")
            except sanitize.LeakError:
                obs_log.error(
                    "agent leaked resources at shutdown", exc_info=True
                )


def main() -> None:
    head_addr, node_ip, shm_ns, local_dir, resources_json = sys.argv[1:6]
    from raydp_tpu_torch.obs import set_process_role

    # node-qualified role: two agents on different hosts can share an OS
    # pid, and the (role, pid) pair keys metric snapshots and trace tracks
    set_process_role(f"agent:{node_ip}")
    from raydp_tpu_torch import sanitize

    sanitize.snapshot_baseline()  # leak-audit floor for this agent process
    # anchor the serving root: the spill-path sanitizer pins file:// block
    # reads/unlinks to THIS node's spill dir
    os.environ[SESSION_ENV] = local_dir
    agent = NodeAgent(
        head_addr, node_ip, json.loads(resources_json), shm_ns, local_dir
    )
    agent.serve()


if __name__ == "__main__":
    main()
