"""Client API for the cluster runtime: init/shutdown, actor spawn/call,
placement groups, resource queries -- the port's own copy of
``raydp_tpu/cluster/api.py``.

This is the user-facing surface that replaces Ray core for this framework
(reference substrate, SURVEY.md L1). Handles are plain picklable records, so
they pass freely between actors — exactly how the reference passes executor
actor handles around (ObjectStoreWriter.scala:232-256).
"""

from __future__ import annotations

import atexit
import os
import select
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import cloudpickle

from raydp_tpu_torch.cluster.common import (
    HEAD_ADDR_ENV,
    HEAD_TCP_FILE,
    SESSION_ENV,
    ActorDiedError,
    ActorRecord,
    ActorSpec,
    ActorState,
    ClusterError,
    connect,
    head_sock_path,
    recv_frame,
    resolve_head_addr,
    rpc,
    rpc_pooled,
    send_frame,
    wait_for_path,
)

from raydp_tpu_torch import sanitize as _sanitize

_lock = _sanitize.named_lock("cluster.api", threading.RLock())
_shutting_down = False  # teardown claimed; guarded-by: _lock
_session_dir: Optional[str] = None
_head_proc: Optional[subprocess.Popen] = None
_is_client = False  # attached to someone else's cluster: detach, never tear down
_is_tcp_client = False  # attached over tcp://: cannot host object-store blocks
_client_env_keys: List[str] = []  # env vars connect_cluster set (cleared on detach)
_client_local_dir: Optional[str] = None  # tcp client's scratch dir (removed on detach)


def is_tcp_client() -> bool:
    return _is_tcp_client


def is_initialized() -> bool:
    return _session_dir is not None


def _join_from_env() -> Optional[str]:
    """Adopt the session an enclosing actor was spawned into, if any."""
    global _session_dir
    with _lock:
        if _session_dir is None:
            env_session = os.environ.get(SESSION_ENV)
            if env_session:
                _session_dir = env_session
        return _session_dir


def session_dir() -> str:
    if _session_dir is None and _join_from_env() is None:
        raise ClusterError("cluster runtime not initialized; call cluster.init()")
    return _session_dir


# head methods that must NOT ride the pooled transport: rpc_pooled retries
# once on a reset connection, and a retry after the head already processed
# the frame would double-execute these (a second create_actor spawns and
# orphans a second OS process; a second add_node registers a ghost node; a
# re-sent obs_ingest would duplicate every span of the flush in the trace)
_NON_IDEMPOTENT_HEAD_METHODS = frozenset(
    {"create_actor", "create_placement_group", "add_node",
     "object_put_proxy_commit", "obs_ingest"}
)


def head_rpc(method: str, timeout: float = 60.0, **kwargs) -> Any:
    # pooled: the object/actor metadata plane is called on every block
    # write/read, and a fresh connect + accept-thread per call costs ~ms —
    # safe because the pool's one reconnect-retry only re-sends requests
    # whose re-execution is harmless (the rest go one-shot)
    addr = resolve_head_addr(session_dir())
    if method in _NON_IDEMPOTENT_HEAD_METHODS:
        return rpc(addr, (method, kwargs), timeout=timeout)
    return rpc_pooled(addr, (method, kwargs), timeout=timeout)


def init(
    num_cpus: Optional[float] = None,
    memory: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    session_root: Optional[str] = None,
) -> str:
    """Start (or join) a session. Inside an actor process this attaches to the
    existing session from the environment — mirroring how Ray workers join the
    cluster they were spawned into."""
    global _session_dir, _head_proc
    with _lock:
        if _session_dir is not None or _join_from_env() is not None:
            return _session_dir
        root = session_root or os.path.join(tempfile.gettempdir(), "raydp_tpu_torch")
        os.makedirs(root, exist_ok=True)
        _session_dir = tempfile.mkdtemp(prefix="session-", dir=root)
        default_resources = dict(resources or {})
        default_resources["CPU"] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
        default_resources["memory"] = float(memory if memory is not None else (4 << 30))
        boot = os.path.join(_session_dir, "head_boot.pkl")
        with open(boot, "wb") as f:
            cloudpickle.dump((os.getpid(), default_resources), f)
        head_env = dict(os.environ)
        # the head (and the actors it spawns) must be able to import raydp_tpu_torch
        # and user modules no matter where the driver was launched from
        head_env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        # start the zygote NOW, before the head boots: its import warm-up
        # is the critical path of the first session's actor spawns,
        # and the head's own _ensure_zygote is idempotent per marker. The
        # zygote's parent-death watch follows this driver — acceptable: the
        # head tears the cluster down when the driver dies anyway, and its
        # monitor restarts a missing zygote.
        try:
            from raydp_tpu_torch.cluster.common import start_zygote

            start_zygote(_session_dir, env=head_env)
        except Exception:  # eager warm-up only; the head starts one at boot
            pass  # the head will start one at boot
        # warm boot: fork the head from the pre-warmed zygote when a READY
        # template exists (second-and-later sessions on a machine — the
        # global template survives across clusters): head boot becomes a
        # fork with imports inherited copy-on-write. Cold machines fall through
        # to the subprocess start immediately (no warm-up wait).
        _head_proc = None
        try:
            from raydp_tpu_torch.cluster.common import zygote_fork_main

            _head_proc = zygote_fork_main(
                _session_dir,
                "raydp_tpu_torch.cluster.head_main",
                [_session_dir],
                head_env,
                os.path.join(_session_dir, "head"),
            )
        except Exception:  # warm boot is opportunistic; the cold start below always works
            _head_proc = None
        if _head_proc is None:
            # -S: skip site/sitecustomize (startup hooks the head never
            # needs); imports resolve via the PYTHONPATH above
            _head_proc = subprocess.Popen(
                [sys.executable, "-S", "-m", "raydp_tpu_torch.cluster.head_main", _session_dir],
                start_new_session=True,
                env=head_env,
            )
        wait_for_path(head_sock_path(_session_dir), 30, "head socket")
        # adopt the cluster token into the environment so this process (and
        # every subprocess it starts — agents, SPMD launchers) can
        # authenticate over the TCP transport
        from raydp_tpu_torch.cluster.common import TOKEN_ENV, load_token

        os.environ[TOKEN_ENV] = load_token(_session_dir).hex()
        atexit.register(shutdown)
        _sanitize.snapshot_baseline()  # leak audit floor for THIS session
        return _session_dir


def connect_cluster(address: str, token: Optional[str] = None) -> str:
    """Attach this process as a DRIVER to an already-running cluster — the
    analog of the reference's ``ray://host:port`` client mode (its test
    matrix runs everything twice, in-process and via the client;
    reference conftest.py:45-52).

    ``address`` is either the cluster's session dir (same host: adopts the
    Unix socket and token file) or the head's ``tcp://host:port`` (any
    machine that can reach it; requires the cluster ``token`` hex string —
    obtain both from the owning driver via ``head_tcp_addr()`` and
    ``cluster_token()``). A TCP client gets its own shm namespace so object
    reads always take the network pull path. Clients never tear the cluster
    down: ``shutdown()`` just detaches."""
    global _session_dir, _is_client, _is_tcp_client
    from raydp_tpu_torch.cluster.common import SHM_NS_ENV, TOKEN_ENV, load_token

    with _lock:
        if _session_dir is not None or _join_from_env() is not None:
            raise ClusterError("cluster runtime already initialized in this process")
        set_env: Dict[str, str] = {}
        if address.startswith("tcp://"):
            if token is None:
                raise ClusterError(
                    "tcp:// attach requires the cluster token "
                    "(cluster_token() on the owning driver)"
                )
            root = os.path.join(tempfile.gettempdir(), "raydp_tpu_torch")
            os.makedirs(root, exist_ok=True)
            local_dir = tempfile.mkdtemp(prefix="client-", dir=root)
            # record the head address in the client dir too: handles pickled
            # by this client embed this dir, and a process resolving them
            # without our env finds the tcp address here (resolve_head_addr)
            from raydp_tpu_torch.cluster.common import HEAD_TCP_FILE

            with open(os.path.join(local_dir, HEAD_TCP_FILE), "w") as f:
                f.write(address)
            set_env[HEAD_ADDR_ENV] = address
            set_env[TOKEN_ENV] = token
            if SHM_NS_ENV not in os.environ:
                # never map foreign shm directly: this process may be on
                # another machine — all reads go through block servers
                set_env[SHM_NS_ENV] = f"client-{uuid.uuid4().hex[:6]}"
        else:
            if not os.path.exists(head_sock_path(address)):
                raise ClusterError(f"no running cluster at {address!r}")
            local_dir = address
            set_env[TOKEN_ENV] = load_token(address).hex()
        os.environ.update(set_env)
        _session_dir = local_dir
        try:
            # attach validation must be atomic with the attach state it
            # validates: a concurrent init() observing a half-attached
            # session would race the rollback below. The ping is a leaf RPC
            # (its path takes no other lock, so no inversion is possible)
            # and bounded at 10s.
            head_rpc("ping", timeout=10)  # validate before committing
        except BaseException:
            # roll back: a typo'd address must not poison the process
            _session_dir = None
            for key in set_env:
                os.environ.pop(key, None)
            if address.startswith("tcp://"):
                import shutil

                shutil.rmtree(local_dir, ignore_errors=True)
            raise
        global _client_local_dir
        _client_local_dir = local_dir if address.startswith("tcp://") else None
        _is_client = True
        _is_tcp_client = address.startswith("tcp://")
        _client_env_keys.extend(set_env)
        _sanitize.snapshot_baseline()  # leak audit floor for THIS attach
        return _session_dir


def cluster_token() -> str:
    """This cluster's auth token (hex) — hand it to tcp:// clients."""
    from raydp_tpu_torch.cluster.common import load_token

    return load_token(session_dir()).hex()


def shutdown() -> None:
    global _session_dir, _head_proc, _is_client
    with _lock:
        if _session_dir is None:
            return
        if _is_client:  # clients detach; the cluster belongs to its driver
            global _is_tcp_client, _client_local_dir
            _session_dir = None
            _is_client = False
            _is_tcp_client = False
            for key in _client_env_keys:
                # a later init() in this process must not route to the old
                # cluster through a stale HEAD_ADDR/TOKEN
                os.environ.pop(key, None)
            _client_env_keys.clear()
            if _client_local_dir is not None:
                import shutil

                shutil.rmtree(_client_local_dir, ignore_errors=True)
                _client_local_dir = None
            return
        if os.environ.get(SESSION_ENV):  # actors never tear the session down
            _session_dir = None
            return
        # claim teardown under the lock; RUN it off the lock. The shutdown
        # RPC and process waits block for up to tens of seconds, and holding
        # the api lock through them froze every other thread touching the
        # cluster API — the exact hold-lock-while-blocking shape the
        # blocking-under-lock rule exists for. A concurrent caller returns
        # immediately (_shutting_down claimed) instead of queueing behind
        # the whole teardown; state is cleared only AFTER the teardown
        # completes, so an interrupt (Ctrl-C in a process wait) leaves the
        # session claimable again and the atexit retry can still reap the
        # head/agent processes instead of orphaning them.
        global _shutting_down
        if _shutting_down:
            return  # teardown already in flight on another thread
        _shutting_down = True
        session = _session_dir
        try:
            head_addr = resolve_head_addr(_session_dir)
        except Exception:  # session dir already gone: nothing to signal
            head_addr = None
        head_proc = _head_proc
        agent_procs = list(_agent_procs)
    done = False
    try:
        if head_addr is not None:
            try:
                rpc(head_addr, ("shutdown", {}), timeout=10)
            except Exception:  # head may already be gone at shutdown
                pass
        if head_proc is not None:
            try:
                head_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                head_proc.kill()
        for proc in agent_procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        from raydp_tpu_torch.cluster.common import stop_zygote

        stop_zygote(session)
        done = True
    finally:
        with _lock:
            _shutting_down = False
            if done:
                _head_proc = None
                _agent_procs.clear()
                _session_dir = None
    from raydp_tpu_torch.cluster.common import close_pooled_connections

    close_pooled_connections()
    close_actor_connections()  # doorbell sockets join the fd audit too
    try:
        from raydp_tpu_torch.store.block_service import close_service_pool

        close_service_pool()  # pooled block-fetch sockets too
    except Exception:  # store layer may not be loaded
        pass
    _sanitize.audit_leaks("cluster.shutdown")


# ---------- actors ----------

# ---------------------------------------------------------------------------
# doorbell: persistent per-(thread, actor-socket) dispatch connections
#
# Actor method calls used to open a fresh socket per call (ActorFuture closed
# it after the reply) — a connect + accept-thread round per dispatch, ~ms on
# the interactive-query hot path. The doorbell keeps the socket: a completed
# future returns its connection to the calling thread's pool, and the next
# dispatch to that actor reuses it (one outstanding request per pooled
# connection; concurrent sends to one actor from one thread fall back to
# fresh sockets). SAME-HOST (Unix sockets) ONLY: a stale UDS failing at SEND
# was never delivered (peer-closed stream sockets fail the first write), so
# retrying on a fresh socket is safe — the same contract rpc_pooled has; on
# TCP a send into a dead peer succeeds until the RST arrives, so tcp://
# actors keep per-call sockets. Toggles: RAYDP_TPU_NO_DOORBELL=1 (process)
# or the ``cluster.doorbell`` session conf via set_doorbell(). Shutdown
# closes the calling thread's doorbell sockets so the leak sanitizer's fd
# audit stays clean.
# ---------------------------------------------------------------------------

_doorbell_tls = threading.local()
_DOORBELL_MAX = 16  # dead sessions' executor sockets must not pile up
_doorbell_on = True  # process-wide toggle; bool writes are atomic


def _doorbell_enabled() -> bool:
    return _doorbell_on and os.environ.get("RAYDP_TPU_NO_DOORBELL") != "1"


def set_doorbell(enabled: bool) -> None:
    """Process-wide toggle (the ``cluster.doorbell`` session conf): off =
    one fresh socket per actor call, the pre-doorbell behavior."""
    global _doorbell_on
    _doorbell_on = bool(enabled)


def _doorbell_take(sock_path: str):
    conns = getattr(_doorbell_tls, "conns", None)
    if conns is None:
        return None
    return conns.pop(sock_path, None)


def _doorbell_release(sock_path: str, sock) -> None:
    if not _doorbell_enabled():
        try:
            sock.close()
        except OSError:  # closing a possibly-dead doorbell socket
            pass
        return
    conns = getattr(_doorbell_tls, "conns", None)
    if conns is None:
        conns = _doorbell_tls.conns = {}
    old = conns.pop(sock_path, None)
    if old is not None:
        try:
            old.close()
        except OSError:  # closing a displaced doorbell socket
            pass
    while len(conns) >= _DOORBELL_MAX:
        # evict the OLDEST entry (insertion order): dead sessions' sockets
        # age out while the hot actors' connections stay pooled
        oldest = next(iter(conns))
        victim = conns.pop(oldest)
        try:
            victim.close()
        except OSError:  # closing an evicted doorbell socket
            pass
    conns[sock_path] = sock


def close_actor_connections() -> None:
    """Close THIS thread's doorbell sockets (shutdown hygiene, mirroring
    ``common.close_pooled_connections`` for the head pool: the fd audit in
    the leak sanitizer counts lingering sockets against the baseline)."""
    conns = getattr(_doorbell_tls, "conns", None)
    if not conns:
        return
    for sock in list(conns.values()):
        try:
            sock.close()
        except OSError:  # closing a possibly-dead doorbell socket
            pass
    conns.clear()


class RemoteMethod:
    def __init__(self, handle: "ActorHandle", method: str, no_reply: bool = False,
                 timeout: Optional[float] = None, retries: int = 0):
        self._handle = handle
        self._method = method
        self._no_reply = no_reply
        self._timeout = timeout
        self._retries = retries

    def options(self, no_reply: bool = False, timeout: Optional[float] = None,
                retries: int = 0) -> "RemoteMethod":
        return RemoteMethod(self._handle, self._method, no_reply, timeout, retries)

    def remote(self, *args, **kwargs) -> "ActorFuture":
        return self._handle._call(
            self._method, args, kwargs,
            no_reply=self._no_reply, timeout=self._timeout, retries=self._retries,
        )

    def __call__(self, *args, **kwargs):
        """Synchronous sugar: handle.method(args) == handle.method.remote(...).result()."""
        return self.remote(*args, **kwargs).result()


class ActorFuture:
    def __init__(self, sock, timeout: Optional[float], pool_key: Optional[str] = None):
        self._sock = sock
        self._timeout = timeout
        self._pool_key = pool_key  # doorbell: return the conn on completion
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None):
        if not self._done:
            wait = timeout if timeout is not None else self._timeout
            if wait is not None:
                # probe without consuming, so a timeout leaves the future usable
                readable, _, _ = select.select([self._sock], [], [], wait)
                if not readable:
                    raise TimeoutError(f"no reply within {wait}s")
            self._sock.settimeout(
                300.0 if self._timeout is None else self._timeout
            )
            try:
                status, value = recv_frame(self._sock)
            except BaseException:
                self._sock.close()
                self._done = True
                raise
            # reply fully consumed: the connection is stream-clean — return
            # it to the doorbell pool so the next dispatch to this actor
            # skips connect/accept/handshake entirely
            if self._pool_key is not None:
                _doorbell_release(self._pool_key, self._sock)
            else:
                self._sock.close()
            self._done = True
            if status == "ok":
                self._value = value
            else:
                self._error = value
        if self._error is not None:
            raise self._error
        return self._value


class _ConnectFailed(OSError):
    """Connection to the actor socket could not be established; the request was
    never delivered, so retrying cannot double-execute a method."""


class _CompletedFuture:
    def __init__(self, value=None):
        self._value = value

    def result(self, timeout=None):
        return self._value


def get(futures, timeout: Optional[float] = None):
    """ray.get-style convenience over one future or a list of futures."""
    if isinstance(futures, (list, tuple)):
        return type(futures)(f.result(timeout) for f in futures)
    return futures.result(timeout)


class ActorHandle:
    """Picklable reference to a named, restartable actor."""

    def __init__(self, session_dir: str, actor_id: str, name: Optional[str] = None):
        self._session_dir = session_dir
        self._actor_id = actor_id
        self._name = name
        self._cached_sock: Optional[str] = None

    @property
    def actor_id(self) -> str:
        return self._actor_id

    @property
    def name(self) -> Optional[str]:
        return self._name

    def __reduce__(self):
        return (ActorHandle, (self._session_dir, self._actor_id, self._name))

    def __getattr__(self, item: str) -> RemoteMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        return RemoteMethod(self, item)

    def _record(self) -> Optional[ActorRecord]:
        return rpc_pooled(
            resolve_head_addr(self._session_dir),
            ("get_actor", {"actor_id": self._actor_id}),
            timeout=30,
        )

    def state(self) -> ActorState:
        record = self._record()
        if record is None:
            raise ClusterError(f"actor {self._actor_id} unknown")
        return record.state

    def wait_ready(self, timeout: float = 120.0) -> "ActorHandle":
        deadline = time.monotonic() + timeout
        use_blocking_wait = True
        while True:
            record = None
            if use_blocking_wait:
                # event-driven: the head parks this call on a condition and
                # replies the moment the actor turns ALIVE/DEAD — no 50ms
                # poll overshoot on the startup critical path
                chunk = min(max(deadline - time.monotonic(), 0.0), 30.0)
                try:
                    record = rpc(
                        resolve_head_addr(self._session_dir),
                        (
                            "wait_actor_ready",
                            {"actor_id": self._actor_id, "timeout": chunk},
                        ),
                        timeout=chunk + 10.0,
                    )
                except ClusterError:
                    use_blocking_wait = False  # older head: fall back to polling
            if not use_blocking_wait:
                record = self._record()
            if record is not None:
                if record.state == ActorState.ALIVE:
                    return self
                if record.state == ActorState.DEAD:
                    raise ActorDiedError(
                        f"actor {self._name or self._actor_id} died during start: {record.error}"
                    )
            if time.monotonic() > deadline:
                raise ClusterError(f"timed out waiting for actor {self._name or self._actor_id}")
            if not use_blocking_wait:
                time.sleep(0.05)

    def _try_send(self, sock_path: str, method: str, args, kwargs, no_reply: bool,
                  timeout: Optional[float]):
        """Connect-phase failures raise _ConnectFailed (request was never
        delivered, always safe to retry); send-phase failures propagate raw
        (the actor may have partially received the request). Dispatches ride
        a pooled doorbell connection when one is free: a stale doorbell that
        fails at SEND was never delivered (peer-closed stream sockets fail
        the first write), so it silently falls through to a fresh connect."""
        from raydp_tpu_torch.cluster.common import traced_request
        from raydp_tpu_torch.obs import metrics as _metrics

        # the caller's trace context rides the frame so executor-side
        # spans (task read/compute/emit) link under the driver's stage
        frame = traced_request((method, args, kwargs, no_reply))
        # off-host actors speak the TCP actor protocol — same doorbell pool,
        # one extra precaution. The stale-at-SEND-was-never-delivered retry
        # premise holds for UDS unconditionally (a peer-closed stream fails
        # the first write) but NOT for TCP, where a send into a dead peer
        # succeeds until the RST arrives — so pooled tcp:// connections are
        # liveness-probed before reuse: the actor never sends unsolicited
        # bytes, hence a READABLE pooled socket can only be EOF/RST and is
        # dropped. Past the probe, a TCP send-phase failure means the RST
        # already arrived (never delivered — safe fresh-connect fallthrough)
        # and a send that lands on a just-died peer surfaces at recv, the
        # exact failure shape a per-call socket has always had.
        is_tcp = sock_path.startswith("tcp://")
        _metrics.counter(
            "rpc.doorbell_tcp" if is_tcp else "rpc.doorbell_uds"
        ).inc()
        use_doorbell = _doorbell_enabled()
        pooled = _doorbell_take(sock_path) if use_doorbell else None
        if pooled is not None and is_tcp:
            try:
                readable, _, _ = select.select([pooled], [], [], 0)
            except (OSError, ValueError):
                readable = [pooled]
            if readable:
                _metrics.counter("rpc.doorbell_tcp_evicted").inc()
                try:
                    pooled.close()
                except OSError:  # already dead
                    pass
                pooled = None
        if pooled is not None:
            try:
                pooled.settimeout(300.0 if timeout is None else timeout)
                send_frame(pooled, frame)
            except OSError:
                try:
                    pooled.close()
                except OSError:  # closing the stale doorbell before the fresh connect
                    pass
            else:
                if no_reply:
                    _doorbell_release(sock_path, pooled)
                    return _CompletedFuture()
                return ActorFuture(pooled, timeout, pool_key=sock_path)
        try:
            sock = connect(
                sock_path, timeout=300.0 if timeout is None else timeout
            )
        except OSError as exc:
            raise _ConnectFailed(str(exc)) from exc
        try:
            send_frame(sock, frame)
        except BaseException:
            sock.close()
            raise
        if no_reply:
            if use_doorbell:
                _doorbell_release(sock_path, sock)
            else:
                sock.close()
            return _CompletedFuture()
        return ActorFuture(
            sock, timeout, pool_key=sock_path if use_doorbell else None
        )

    def _call(self, method: str, args, kwargs, no_reply: bool, timeout: Optional[float],
              retries: int) -> ActorFuture:
        if self._cached_sock is not None:
            try:
                return self._try_send(self._cached_sock, method, args, kwargs, no_reply, timeout)
            except _ConnectFailed:
                self._cached_sock = None  # actor moved/restarted; fall through to head lookup
        sends_failed = 0
        # an explicit timeout=0 must mean "no budget", not the 300s default
        deadline = time.monotonic() + (300.0 if timeout is None else timeout)
        while True:
            record = self._record()
            if record is None:
                raise ClusterError(f"actor {self._actor_id} unknown")
            if record.state == ActorState.DEAD:
                raise ActorDiedError(
                    f"actor {self._name or self._actor_id} is dead: {record.error or 'exited'}"
                )
            if record.state == ActorState.ALIVE and record.sock_path:
                try:
                    future = self._try_send(
                        record.sock_path, method, args, kwargs, no_reply, timeout
                    )
                    self._cached_sock = record.sock_path
                    return future
                except _ConnectFailed:  # never delivered; retried until the deadline
                    pass  # never delivered: retry freely until the deadline
                except OSError:
                    sends_failed += 1
                    if sends_failed > retries:
                        raise
            if time.monotonic() > deadline:
                raise ClusterError(
                    f"timed out calling {method} on {self._name or self._actor_id} "
                    f"(state={record.state})"
                )
            time.sleep(0.05)  # PENDING / RESTARTING: wait for the respawn

    def kill(self, no_restart: bool = True) -> None:
        rpc(
            resolve_head_addr(self._session_dir),
            ("kill_actor", {"actor_id": self._actor_id, "no_restart": no_restart}),
            timeout=30,
        )


def spawn(
    cls,
    *args,
    name: Optional[str] = None,
    resources: Optional[Dict[str, float]] = None,
    num_cpus: float = 0.0,
    memory: float = 0.0,
    max_restarts: int = 0,
    max_concurrency: int = 1,
    placement_group: Optional[str] = None,
    bundle_index: int = -1,
    env: Optional[Dict[str, str]] = None,
    block: bool = True,
    light: bool = False,
    **kwargs,
) -> ActorHandle:
    """Create an actor process running ``cls(*args, **kwargs)``.

    ``light=True`` forks the process from the node's pre-warmed zygote
    (or starts it with ``python -S``): no site/sitecustomize, which skips
    environments' expensive startup hooks. The PUBLIC default stays False
    because a light actor silently misses whatever a ``.pth`` file or a
    sitecustomize would have set up."""
    res = dict(resources or {})
    if num_cpus:
        res["CPU"] = float(num_cpus)
    if memory:
        res["memory"] = float(memory)
    env = dict(env or {})
    # actors must be able to import the modules that defined cls and its args
    env.setdefault("PYTHONPATH", os.pathsep.join(p for p in sys.path if p))
    spec = ActorSpec(
        actor_id=f"actor-{uuid.uuid4().hex[:12]}",
        name=name,
        cls_blob=cloudpickle.dumps(cls),
        args_blob=cloudpickle.dumps((args, kwargs)),
        resources=res,
        max_restarts=max_restarts,
        max_concurrency=max_concurrency,
        placement_group=placement_group,
        bundle_index=bundle_index,
        env=env,
        light=light,
    )
    head_rpc("create_actor", spec=spec)
    handle = ActorHandle(session_dir(), spec.actor_id, name)
    if block:
        handle.wait_ready()
    return handle


def get_actor(name: str) -> ActorHandle:
    record = head_rpc("get_actor", name=name)
    if record is None:
        raise ClusterError(f"no actor named {name!r}")
    return ActorHandle(session_dir(), record.actor_id, name)


def list_actors() -> List[ActorRecord]:
    return head_rpc("list_actors")


def kill_all_matching(prefix: str) -> None:
    for record in list_actors():
        if record.name and record.name.startswith(prefix):
            ActorHandle(session_dir(), record.actor_id, record.name).kill()


# ---------- placement groups ----------


class PlacementGroup:
    def __init__(self, pg_id: str):
        self.id = pg_id

    def __reduce__(self):
        return (PlacementGroup, (self.id,))


def create_placement_group(
    bundles: Sequence[Dict[str, float]], strategy: str = "PACK"
) -> PlacementGroup:
    pg_id = head_rpc("create_placement_group", bundles=list(bundles), strategy=strategy)
    return PlacementGroup(pg_id)


def remove_placement_group(pg: PlacementGroup) -> None:
    head_rpc("remove_placement_group", pg_id=pg.id)


def placement_group_table() -> Dict[str, Any]:
    return head_rpc("placement_group_table")


# ---------- nodes / resources ----------


def head_tcp_addr(timeout: float = 30.0) -> str:
    """The head's TCP address (published in the session dir at startup) —
    what node agents on other hosts connect to."""
    path = os.path.join(session_dir(), HEAD_TCP_FILE)
    wait_for_path(path, timeout, "head TCP address")
    with open(path) as f:
        return f.read().strip()


def start_node_agent(
    resources: Dict[str, float],
    node_ip: Optional[str] = None,
    shm_ns: Optional[str] = None,
    head_addr: Optional[str] = None,
    timeout: float = 60.0,
    host: Optional[str] = None,
) -> Dict[str, str]:
    """Launch a node agent as a detached process and wait for it to register.

    On a real deployment each host runs
    ``python -m raydp_tpu_torch.cluster.agent <head_tcp> <ip> <ns> <dir> <json>``;
    this helper starts one on the local machine — with its own shm NAMESPACE,
    so it behaves exactly like a separate host: none of its blocks can be
    mapped by other nodes, every cross-node read goes over TCP. ``host``
    names the simulated host on the cluster's host axis
    (``RAYDP_TPU_TORCH_HOST_ID`` in the agent's env, inherited by its actors);
    it defaults to the namespace, which already has host granularity.

    Returns ``{"node_id", "addr", "dir"}``.
    """
    import json

    from raydp_tpu_torch.cluster.common import HOST_ID_ENV

    head = head_addr or head_tcp_addr()
    ns = shm_ns or f"n{uuid.uuid4().hex[:6]}"
    ip = node_ip or "127.0.0.1"
    local_dir = tempfile.mkdtemp(prefix=f"agent-{ns}-", dir=session_dir())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    if host is not None:
        env[HOST_ID_ENV] = host
    else:
        # the agent must not inherit THIS process's host identity: its
        # namespace is its (simulated) host
        env.pop(HOST_ID_ENV, None)
    proc = subprocess.Popen(
        [
            sys.executable, "-S", "-m", "raydp_tpu_torch.cluster.agent",
            head, ip, ns, local_dir, json.dumps(resources),
        ],
        start_new_session=True,
        env=env,
    )
    _agent_procs.append(proc)
    ready = os.path.join(local_dir, "agent_ready.json")
    try:
        wait_for_path(ready, timeout, "node agent registration")
    except ClusterError:
        # a half-started agent must not register later as a ghost node
        proc.kill()
        raise
    with open(ready) as f:
        info = json.load(f)
    info["dir"] = local_dir
    info["pid"] = proc.pid
    return info


# agent processes this driver started (reaped at shutdown so exited agents
# don't linger as zombies)
_agent_procs: List[subprocess.Popen] = []


def add_node(resources: Dict[str, float], node_ip: Optional[str] = None) -> str:
    return head_rpc("add_node", resources=resources, node_ip=node_ip)


def remove_node(node_id: str) -> None:
    head_rpc("remove_node", node_id=node_id)


def nodes() -> List[Any]:
    return head_rpc("nodes")


def total_resources() -> Dict[str, Dict[str, float]]:
    return head_rpc("total_resources")


def available_resources() -> Dict[str, Dict[str, float]]:
    return head_rpc("available_resources")


# ---------- observability ----------


def dump_metrics() -> Dict[str, dict]:
    """Cluster-wide metrics: ``{"<role>:<pid>": {metric: snapshot}}`` for
    every process that has flushed telemetry to the head, merged with this
    process's live registry. Works (locally) without a running cluster."""
    from raydp_tpu_torch.obs.export import dump_metrics as _dump

    return _dump()


def export_trace(path: str) -> str:
    """Write the cluster's collected trace as Perfetto-loadable JSON (see
    ``raydp_tpu_torch.obs.export_trace``)."""
    from raydp_tpu_torch.obs.export import export_trace as _export

    return _export(path)


def query_metrics(
    name: str,
    window_s: float = 60.0,
    labels: Optional[Dict[str, str]] = None,
    aggregate: bool = False,
) -> Any:
    """Windowed time-series read from the head's ring TSDB — the in-process
    flavor of a Prometheus scrape (docs/observability.md "Time series").
    Returns matching series (``[{name, labels, type, points, last,
    delta?}]``) or, with ``aggregate=True``, one windowed aggregate
    (``{series, delta, last, max}``). Flushes this process first so its own
    registry is part of the answer; degrades to the process-local mirror
    when no cluster is running."""
    from raydp_tpu_torch.obs import timeseries as _ts
    from raydp_tpu_torch.obs.tracing import flush

    flush()  # best-effort: puts this process's snapshot on the head
    try:
        if is_initialized() or os.environ.get(SESSION_ENV):
            return head_rpc(
                "obs_query_series", name=name, window_s=window_s,
                labels=labels, aggregate=aggregate, timeout=30.0,
            )
    except Exception:  # no cluster (or dead head): the local mirror below still answers
        pass
    if aggregate:
        return _ts.local_store.windowed(name, window_s, labels)
    return _ts.local_store.query(name, window_s, labels)


def scrape_addr() -> Optional[tuple]:
    """(host, port) of the head's Prometheus scrape endpoint, or None when
    no session enabled it (``obs.scrape_port`` conf)."""
    return head_rpc("obs_scrape_addr", timeout=10.0)
