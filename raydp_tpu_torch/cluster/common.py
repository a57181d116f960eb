"""Wire protocol and shared records of the cluster runtime: the port's own
copy of ``raydp_tpu/cluster/common.py``.

One *head* process holds the cluster's state (actors, virtual nodes,
placement groups) and one OS process runs each actor, all talking
length-prefixed cloudpickle frames over Unix-domain sockets, or over TCP
with the session token's handshake between hosts. The control plane is
small on purpose: the data plane (a model's tensors on the card) never
crosses these sockets.

The port names the values of its plumbing with its own prefix,
``RAYDP_TPU_TORCH_`` (the session, head address, shm namespace, host id
and token variables below, the node and actor variables a worker reads,
the no-global-zygote switch) and its own temp roots, and keeps the Python
names of the constants: a process that imports both packages, or an actor
of one runtime that imports the other, never joins the other's session.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import socket
import struct
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30

HEAD_SOCK_NAME = "head.sock"
HEAD_TCP_FILE = "head_tcp.addr"
TOKEN_FILE = "cluster.token"
SESSION_ENV = "RAYDP_TPU_TORCH_SESSION"
HEAD_ADDR_ENV = "RAYDP_TPU_TORCH_HEAD_ADDR"
SHM_NS_ENV = "RAYDP_TPU_TORCH_SHM_NS"
# the first part of every store segment's name in /dev/shm and of every
# spill file's name (``rtpt-<ns>-<id>``); the JAX package's are ``rtpu-``,
# so neither runtime counts, serves or unlinks the other's blocks
SHM_PREFIX = "rtpt-"
HOST_ID_ENV = "RAYDP_TPU_TORCH_HOST_ID"
TOKEN_ENV = "RAYDP_TPU_TORCH_TOKEN"
DRIVER_OWNER = "__driver__"
TOKEN_LEN = 32


class ClusterError(RuntimeError):
    pass


class ActorDiedError(ClusterError):
    """The callee actor is dead (crashed past max_restarts or intentionally exited)."""


class OwnerDiedError(ClusterError):
    """An object's owner died and the object was not transferred (parity:
    ray.exceptions.OwnerDiedError asserted in reference
    test_data_owner_transfer.py:33-77)."""


class ProgramCacheMiss(ClusterError):
    """Raised by an executor asked to run a program id it has never seen
    (cache evicted / actor restarted): the driver re-dispatches with the
    program body attached. Picklable with its single string arg; defined
    here (not in etl/program.py) because it crosses the executor RPC
    boundary and the catching process must be able to unpickle it without
    the etl import set."""


class TenantQuotaError(ClusterError):
    """A tenant exceeded one of its quotas (max block bytes at the head,
    max in-flight / queued tasks at the fair-share scheduler). Typed so
    callers can tell an over-quota rejection from an infrastructure failure
    — the multi-tenant contract is reject-fast, never wedge the queue
    (docs/multitenancy.md). Carries ``tenant`` when known; defined here so
    it pickles across the head RPC boundary like every cluster error."""

    tenant: str = ""


def tenant_of_object(object_id: str) -> str:
    """The tenant namespace encoded in a block's object id (empty for
    unprefixed ids — single-session / tenancy-off blocks). Tenant-scoped
    writers mint ids as ``<tenant>.<hex16>`` (store.new_object_id); the hex
    tail never contains a dot, so the LAST dot splits unambiguously."""
    head, sep, _tail = object_id.rpartition(".")
    return head if sep else ""


class ActorState(str, enum.Enum):
    PENDING = "PENDING"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = cloudpickle.dumps(obj)
    if len(payload) > MAX_FRAME:
        raise ClusterError(f"frame too large: {len(payload)} bytes")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> Any:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return cloudpickle.loads(_recv_exact(sock, length))


def session_token() -> bytes:
    """The cluster's shared secret. TCP peers must present it before any
    frame is parsed — without it, a reachable port would mean arbitrary
    unpickling (RCE) for anyone on the network. Resolution: env (remote
    processes) → the session dir's token file (head-local processes)."""
    env_token = os.environ.get(TOKEN_ENV)
    if env_token:
        return bytes.fromhex(env_token)
    session = os.environ.get(SESSION_ENV)
    if session:
        path = os.path.join(session, TOKEN_FILE)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
    return b"\0" * TOKEN_LEN  # no session context: deliberately non-matching


def load_token(session_dir: str) -> bytes:
    with open(os.path.join(session_dir, TOKEN_FILE), "rb") as f:
        return f.read()


def verify_token(sock: socket.socket, expected: bytes) -> bool:
    """Server side of the TCP handshake: challenge-response, verified before
    any frame touches cloudpickle (a reachable port must not mean arbitrary
    unpickling). The server sends a fresh nonce and the client proves
    possession with HMAC-SHA256(token, nonce) — the secret itself never
    crosses the wire, so a passive observer cannot capture-and-replay it.
    (An attacker who can fully MITM an established connection can still relay
    frames; untrusted networks need TLS on top.)"""
    import hashlib
    import hmac

    try:
        nonce = os.urandom(TOKEN_LEN)
        sock.sendall(nonce)
        presented = _recv_exact(sock, hashlib.sha256().digest_size)
    except OSError:
        return False
    digest = hmac.new(expected, nonce, hashlib.sha256).digest()
    return hmac.compare_digest(presented, digest)


def connect(addr: str, timeout: Optional[float] = None) -> socket.socket:
    """Connect to either transport: ``tcp://host:port`` or a Unix socket
    path. The TCP side is what makes the substrate multi-host — agents and
    their actors on other machines are addressed exactly like local ones.
    TCP connections start with the session-token handshake; Unix sockets are
    guarded by the session dir's filesystem permissions instead."""
    if addr.startswith("tcp://"):
        host, _, port = addr[6:].rpartition(":")
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect((host, int(port)))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # client side of the challenge-response handshake (see verify_token)
        import hashlib
        import hmac

        nonce = _recv_exact(sock, TOKEN_LEN)
        sock.sendall(hmac.new(session_token(), nonce, hashlib.sha256).digest())
        return sock
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect(addr)
    return sock


def safe_shm_name(shm_name: str) -> str:
    """Reject anything but a flat segment name (a client-supplied name is
    joined under /dev/shm — path traversal must be impossible)."""
    name = shm_name.lstrip("/")
    if not name or "/" in name or ".." in name or not name.startswith(SHM_PREFIX):
        raise ClusterError(f"invalid shm segment name {shm_name!r}")
    return name


def resolve_head_addr(session_dir: str) -> str:
    """The head's address for THIS process: remote processes (spawned via a
    node agent) carry it in the environment; head-local ones use the Unix
    socket in the session dir. A dir WITHOUT a head socket is a tcp://
    client's local dir — its ``head_tcp.addr`` file (written at attach)
    carries the address, so handles pickled BY the client resolve anywhere
    in the cluster (an actor holding such a handle has neither the client's
    env nor its head socket)."""
    env_addr = os.environ.get(HEAD_ADDR_ENV)
    if env_addr:
        return env_addr
    sock = head_sock_path(session_dir)
    if not os.path.exists(sock):
        tcp_file = os.path.join(session_dir, HEAD_TCP_FILE)
        try:
            with open(tcp_file) as f:
                addr = f.read().strip()
            if addr:
                return addr
        except OSError:  # no tcp addr file: fall through to the unix socket
            pass
    return sock


def shm_namespace() -> str:
    """This process's shared-memory namespace (one per node). Objects are
    only mapped directly when their namespace matches; everything else goes
    through the owning node's block server."""
    return os.environ.get(SHM_NS_ENV, "")


def host_id() -> str:
    """This process's host identity on the cluster's host axis. Real
    multi-host deployments set ``RAYDP_TPU_TORCH_HOST_ID`` per box; the simulated
    multi-host harness (two agents on one machine with distinct shm
    namespaces) falls back to the shm namespace, which already has exactly
    host granularity — same namespace ⇒ blocks map locally, different
    namespace ⇒ bytes cross the (possibly loopback) wire. Empty string is
    the head's own host."""
    return os.environ.get(HOST_ID_ENV) or shm_namespace()


def host_label(host: str) -> str:
    """Metric-safe token for a host id (flat dotted metric names — empty
    host is the head's, dots would split the name)."""
    return (host or "head").replace(".", "_")


# ---------------------------------------------------------------------------
# trace-context propagation (obs layer)
#
# When tracing is on and the calling thread carries a span context, outgoing
# requests are wrapped in an ``("__obs__", (trace_id, span_id), request)``
# envelope; servers unwrap with ``unwrap_traced`` and adopt the context around
# the handled call, so one query's spans link across driver, head, agents and
# executors. Untraced frames are byte-identical to before.
# ---------------------------------------------------------------------------

OBS_FRAME_MARK = "__obs__"


def traced_request(request: Tuple) -> Tuple:
    from raydp_tpu_torch.obs.tracing import current_context, enabled

    if enabled():
        ctx = current_context()
        if ctx is not None:
            return (OBS_FRAME_MARK, ctx, request)
    return request


def unwrap_traced(request: Any) -> Tuple[Any, Optional[Tuple[str, str]]]:
    """(inner_request, trace_ctx_or_None) — the server half."""
    if (
        isinstance(request, tuple)
        and len(request) == 3
        and request[0] == OBS_FRAME_MARK
    ):
        return request[2], request[1]
    return request, None


def _observe_rpc(request: Tuple, seconds: float) -> None:
    from raydp_tpu_torch.obs.metrics import metrics

    metrics.counter("rpc.client.calls").inc()
    metrics.histogram("rpc.client.seconds").observe(seconds)
    if isinstance(request, tuple) and request and isinstance(request[0], str):
        metrics.counter(f"rpc.client.calls.{request[0]}").inc()


def rpc(sock_path: str, request: Tuple, timeout: Optional[float] = 60.0) -> Any:
    """One-shot request/response. Raises the remote exception if status != ok."""
    t0 = time.perf_counter()
    with connect(sock_path, timeout) as sock:
        send_frame(sock, traced_request(request))
        status, value = recv_frame(sock)
    _observe_rpc(request, time.perf_counter() - t0)
    if status == "ok":
        return value
    raise value


# ---------------------------------------------------------------------------
# pooled RPC: persistent per-(thread, address) connections
#
# Control-plane servers serve multiple sequential frames per connection, so
# hot callers (object register/lookup on every block write/read, task
# dispatch bookkeeping) skip the ~ms connect + accept-thread cost per call.
# Strictly sequential request/response per connection — concurrency comes
# from each thread owning its own socket.
# ---------------------------------------------------------------------------

import threading as _threading

_rpc_pool_tls = _threading.local()
_POOL_MAX_ADDRS = 8  # old sessions' sockets must not accumulate per thread


def _pool_drop(addr: str) -> None:
    conns = getattr(_rpc_pool_tls, "conns", None)
    if conns:
        sock = conns.pop(addr, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:  # closing a possibly-dead pooled socket
                pass


def close_pooled_connections() -> None:
    """Close THIS thread's pooled RPC sockets (shutdown hygiene: the pool
    keeps one live socket per address for the thread's lifetime, which the
    leak sanitizer's fd audit would otherwise count against the baseline
    forever)."""
    conns = getattr(_rpc_pool_tls, "conns", None)
    if not conns:
        return
    for addr in list(conns):
        _pool_drop(addr)


def rpc_pooled(sock_path: str, request: Tuple, timeout: Optional[float] = 60.0) -> Any:
    """Request/response over a cached per-thread connection. A stale cached
    connection (server restarted / closed idle) is dropped and the request
    retried ONCE on a fresh connection — the same failure surface a fresh-
    connection caller has. Callers routing non-idempotent requests should
    use ``rpc`` instead."""
    conns = getattr(_rpc_pool_tls, "conns", None)
    if conns is None:
        conns = _rpc_pool_tls.conns = {}
    t0 = time.monotonic()
    wire_request = traced_request(request)
    for attempt in (0, 1):
        sock = conns.get(sock_path)
        fresh = sock is None
        try:
            if sock is None:
                if len(conns) >= _POOL_MAX_ADDRS:
                    for stale in list(conns):
                        _pool_drop(stale)
                sock = connect(sock_path, timeout)
                conns[sock_path] = sock
            sock.settimeout(timeout)
            send_frame(sock, wire_request)
            status, value = recv_frame(sock)
            break
        except socket.timeout:
            # the server HAS the request and may still be processing it —
            # retrying would double-execute (create_actor would leak a
            # second process). Propagate like plain rpc(); the connection
            # is poisoned (a late reply would desync the stream), so drop it.
            _pool_drop(sock_path)
            raise
        except (EOFError, OSError):
            _pool_drop(sock_path)
            if attempt or fresh:
                raise
    _observe_rpc(request, time.monotonic() - t0)
    if status == "ok":
        return value
    raise value


# A Unix socket's file appears at ``bind``, before ``listen``: a client that
# waits for the path (``wait_for_path``) and connects inside that window is
# refused. So a listener whose path others wait on binds to this temporary
# name beside it, listens, and only then renames the file into place: the
# path exists only once it accepts connections.
BIND_SUFFIX = ".b"


def bind_listening(sock: socket.socket, path: str, backlog: int,
                   before_listen=None) -> None:
    """Bind ``sock`` at ``path + BIND_SUFFIX``, call ``before_listen`` (a
    test's stall), listen, and rename the socket file to ``path``."""
    tmp = path + BIND_SUFFIX
    try:
        os.unlink(tmp)
    except FileNotFoundError:  # no stale temporary socket
        pass
    sock.bind(tmp)
    if before_listen is not None:
        before_listen()
    sock.listen(backlog)
    os.rename(tmp, path)


def wait_for_path(path: str, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise ClusterError(f"timed out waiting for {what} at {path}")
        # 5ms: this poll sits on the warm-boot critical path (the head
        # socket after a zygote fork)
        time.sleep(0.005)


@dataclasses.dataclass
class ActorSpec:
    """Everything needed to (re)start an actor process; persisted to the session
    dir so the head can respawn a crashed actor with the same identity
    (restart-aware identity, parity: RayDPExecutor restart dance,
    reference RayDPExecutor.scala:84-96 / RayExecutorUtils.java:63-65)."""

    actor_id: str
    name: Optional[str]
    cls_blob: bytes  # cloudpickled class
    args_blob: bytes  # cloudpickled (args, kwargs)
    resources: Dict[str, float]
    max_restarts: int = 0
    max_concurrency: int = 1
    placement_group: Optional[str] = None
    bundle_index: int = -1
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    # light=True starts the actor with `python -S`, or forks it from the
    # node's pre-warmed zygote (itself a `python -S` process): site and
    # sitecustomize are skipped and imports resolve via the PYTHONPATH the
    # spawner provides. An actor whose imports need site (.pth files) must
    # set light=False.
    light: bool = True


@dataclasses.dataclass
class ActorRecord:
    """Head-side view of one actor, as reported to clients."""

    actor_id: str
    name: Optional[str]
    state: ActorState
    incarnation: int
    sock_path: Optional[str]
    node_id: Optional[str]
    node_ip: Optional[str]
    restarts_used: int = 0
    error: Optional[str] = None
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NodeRecord:
    node_id: str
    node_ip: str
    resources: Dict[str, float]
    alive: bool = True
    # agent-backed nodes (real multi-host): the head spawns/kills actors and
    # fetches blocks through the agent's TCP address; shm_ns is the node's
    # shared-memory namespace (objects from other namespaces must be pulled
    # over the network, never mapped)
    agent_addr: Optional[str] = None
    shm_ns: str = ""
    # host axis: which physical (or simulated) host this node
    # lives on. Placement scoring and transport selection key on it; ""
    # means the head's own host. Defaults keep old pickles/ctors valid.
    host: str = ""


def actor_sock_path(session_dir: str, actor_id: str, incarnation: int) -> str:
    return os.path.join(session_dir, f"a-{actor_id}-{incarnation}.sock")


def head_sock_path(session_dir: str) -> str:
    return os.path.join(session_dir, HEAD_SOCK_NAME)


def safe_spill_path(name: str) -> str:
    """Validate a ``file://`` block location before serving/unlinking it: the
    resolved path must be a framework spill file (``SHM_PREFIX``) DIRECTLY
    inside this process's own spill root (``$RAYDP_TPU_TORCH_SESSION/spill`` —
    head_main/agent anchor it at boot) — a client-supplied path must not be
    able to read or remove arbitrary files, nor another session's spill."""
    path = os.path.realpath(name[len("file://"):])
    base = os.path.basename(path)
    if not base.startswith(SHM_PREFIX):
        raise ClusterError(f"invalid spill block path {name!r}")
    session = os.environ.get(SESSION_ENV)
    if not session:
        raise ClusterError(
            f"cannot serve spill path {name!r}: no session root anchored"
        )
    root = os.path.realpath(os.path.join(session, "spill"))
    if os.path.dirname(path) != root:
        raise ClusterError(f"spill path {name!r} outside this node's spill dir")
    return path


def object_meta_entry(
    object_id: str, owner: str, shm_name: str, size: int,
    node_id: str, shm_ns: str = "",
) -> Dict[str, Any]:
    """The canonical metadata-registration record for one object-store
    block — the single schema shared by the per-block ``object_put`` RPC and
    the vectorized ``object_put_batch`` frame (store client side and head
    handler side both build/consume exactly this shape)."""
    return {
        "object_id": object_id,
        "owner": owner,
        "shm_name": shm_name,
        "size": size,
        "node_id": node_id,
        "shm_ns": shm_ns,
    }


def serve_block_bytes(shm_name: str, offset: int = 0, length: int = -1) -> bytes:
    """Read a local block for a remote reader (the block-server primitive
    shared by the head and node agents — one copy of the sanitize/seek/length
    logic). Serves both tiers: /dev/shm segments and ``file://`` spill files."""
    if shm_name.startswith("file://"):
        path = safe_spill_path(shm_name)
    else:
        path = os.path.join("/dev/shm", safe_shm_name(shm_name))
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read() if length < 0 else f.read(length)


class RawView:
    """A zero-copy reply payload: a read-only view over an mmap of the
    block's backing file. When an actor method returns one, the worker's
    serve loop streams the bytes straight from the page cache onto the
    socket — ``("raw", size)`` header frame, then ``size`` raw bytes — with
    no pickling and no intermediate copy. The handler, not the method, owns
    closing it (the view must stay mapped until sendall returns)."""

    __slots__ = ("view", "size", "_mm")

    def __init__(self, mm, view: memoryview):
        self._mm = mm
        self.view = view
        self.size = len(view)

    def close(self) -> None:
        try:
            self.view.release()
            if hasattr(self._mm, "close"):
                self._mm.close()
        except (BufferError, ValueError):  # a partially sent view may still be exported; the mmap closes with the process
            pass


def serve_block_view(shm_name: str, offset: int = 0, length: int = -1) -> RawView:
    """Zero-copy variant of ``serve_block_bytes``: mmap the block (either
    tier) and return a :class:`RawView` over the requested range instead of
    a copied ``bytes``. The streaming block server sends it with
    ``sendall(view)`` — kernel reads pages straight from the segment."""
    import mmap

    if shm_name.startswith("file://"):
        path = safe_spill_path(shm_name)
    else:
        path = os.path.join("/dev/shm", safe_shm_name(shm_name))
    with open(path, "rb") as f:
        total = os.fstat(f.fileno()).st_size
        if total == 0:
            # cannot mmap an empty file; an empty view needs no backing
            return RawView(memoryview(b""), memoryview(b""))
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    end = total if length < 0 else min(total, offset + length)
    start = min(offset, total)
    return RawView(mm, memoryview(mm)[start:end])


def unlink_block(shm_name: str) -> None:
    """Remove a block in either tier (shared by head and agents)."""
    from raydp_tpu_torch import sanitize

    sanitize.untrack_block(shm_name)
    try:
        if shm_name.startswith("file://"):
            os.unlink(safe_spill_path(shm_name))
        else:
            os.unlink(os.path.join("/dev/shm", safe_shm_name(shm_name)))
    except (OSError, ClusterError):  # best-effort removal; block may already be gone
        pass


class ZygoteProc:
    """Popen-shaped handle for a zygote-forked worker. The child's true
    parent (the zygote) reaps it and records the exit status in an
    ``<log_base>.exit`` marker; monitors here read the marker first, then
    fall back to a pid probe — a raw probe alone would report "alive"
    forever after pid reuse and could never recover the exit code."""

    def __init__(self, pid: int, log_base: str = ""):
        self.pid = pid
        self._log_base = log_base
        self._rc: Optional[int] = None

    def wait(self, timeout: Optional[float] = None) -> int:
        """Popen.wait parity over the poll shim (callers that treat head/
        agent processes uniformly — api.shutdown — need it). Raises
        subprocess.TimeoutExpired like the real thing."""
        import subprocess

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("zygote-forked-process", timeout)
            time.sleep(0.01)

    def kill(self) -> None:
        """SIGKILL the forked child's process group (it setsid() at birth,
        so the group is exactly its own tree)."""
        import signal as _signal

        try:
            os.killpg(self.pid, _signal.SIGKILL)
        except OSError:
            try:
                os.kill(self.pid, _signal.SIGKILL)
            except OSError:  # kill of an already-dead process is idempotent
                pass

    def poll(self) -> Optional[int]:
        if self._rc is not None:
            return self._rc
        if self._log_base:
            try:
                with open(self._log_base + ".exit") as f:
                    self._rc = int(f.read().strip() or 0)
                return self._rc
            except (OSError, ValueError):  # no exit marker yet: pid probe follows
                pass  # no marker yet: the child may still be running
        # _probe_pid treats zombies as dead: the child may be dead but not
        # yet reaped by the zygote (its loop cadence stretches under CPU
        # contention); death detection
        # must not wait on the reaper. The exit marker, when it lands,
        # carries the real code for post-mortems.
        state = _probe_pid(self.pid)
        if state == "gone":
            self._rc = 0  # vanished before the marker landed; code unknown
            return self._rc
        if state == "dead":
            self._rc = 1
            return self._rc
        return None


# the zygote processes THIS process started, keyed by run_dir — kept so
# liveness checks can poll() (and thereby reap) a dead child: a bare pid
# probe sees the unreaped zombie as alive forever
_zygote_procs: Dict[str, Any] = {}


def _zygote_source_key() -> str:
    """Staleness key for the machine-global zygote: interpreter, the
    raydp_tpu_torch source tree's (path, mtime, size) set, AND the versions
    of the warmed dependencies (an in-place upgrade of torch must not leave
    a template serving the old in-memory copy). Any change keys new
    sessions into a fresh global dir; stale templates idle out."""
    import hashlib
    import sys

    import raydp_tpu_torch

    pkg_root = os.path.dirname(os.path.abspath(raydp_tpu_torch.__file__))
    h = hashlib.sha1()
    h.update(sys.executable.encode())
    h.update(pkg_root.encode())
    from importlib import metadata

    for dist in ("torch", "numpy", "cloudpickle"):
        try:  # dist-info read, no import (torch costs seconds to import)
            h.update(f"{dist}={metadata.version(dist)};".encode())
        except Exception:
            h.update(f"{dist}=?;".encode())
    for dirpath, dirnames, filenames in sorted(os.walk(pkg_root)):
        dirnames.sort()
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            try:
                st = os.stat(path)
            except OSError:  # file vanished mid-walk: excluded from the key
                continue
            h.update(
                f"{os.path.relpath(path, pkg_root)}:{st.st_mtime_ns}:{st.st_size};".encode()
            )
    return h.hexdigest()[:16]


def _probe_pid(pid: int) -> str:
    """'alive' | 'gone' (no such pid) | 'dead' (zombie, or pid owned by
    another uid — our child can't be). The one pid-probe implementation
    shared by ZygoteProc.poll and the zygote liveness checks."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return "gone"
    except PermissionError:  # pragma: no cover - pid reused by another uid
        return "dead"
    try:
        with open(f"/proc/{pid}/stat") as f:
            if f.read().rsplit(") ", 1)[1][:1] == "Z":
                return "dead"
    except (OSError, IndexError):  # proc entry vanished: next probe decides
        pass
    return "alive"


def _pid_alive_not_zombie(pid: int) -> bool:
    return _probe_pid(pid) == "alive"


def _proc_starttime(pid: int) -> Optional[int]:
    """Kernel start time (clock ticks since boot, /proc stat field 22) —
    the (pid, starttime) pair uniquely identifies a process incarnation,
    immune to pid reuse AND to fork-without-exec cmdline inheritance."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return int(f.read().rsplit(") ", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


def _write_zygote_marker(marker: str, pid: int) -> None:
    """pid in the marker + its starttime in a sidecar (separate file: the
    marker's bare-int format is read by tests and older probes)."""
    with open(marker + ".tmp", "w") as f:
        f.write(str(pid))
    os.replace(marker + ".tmp", marker)
    st = _proc_starttime(pid)
    try:
        if st is not None:
            with open(marker + ".start.tmp", "w") as f:
                f.write(str(st))
            os.replace(marker + ".start.tmp", marker + ".start")
        else:
            os.unlink(marker + ".start")
    except OSError:  # starttime sidecar is best-effort
        pass


def _marker_pid_alive(marker: str) -> Optional[int]:
    """The marker's pid if that exact process incarnation is still alive
    (starttime sidecar checked when present — a REUSED pid reads as dead,
    even one whose inherited cmdline still looks like a zygote)."""
    try:
        with open(marker) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    if not _pid_alive_not_zombie(pid):
        return None
    try:
        with open(marker + ".start") as f:
            recorded = int(f.read().strip())
        live = _proc_starttime(pid)
        if live is not None and live != recorded:
            return None  # same pid, different process: reuse
    except (OSError, ValueError):  # no sidecar (older writer): liveness is the best we have
        pass  # no sidecar (older writer): plain liveness is the best we have
    return pid


def _adopt_global_zygote(run_dir: str, env: Dict[str, str]) -> bool:
    """Adopt (or start) the machine-global pre-warmed zygote and point this
    session's zygote.sock/zygote.pid at it. The global template is shared by
    every cluster of this user running the SAME source tree (fork requests
    carry the target session's run_dir and env, so the zygote itself is
    session-agnostic): after the first cluster on a machine pays the import
    warm-up once, later first-sessions fork instead of importing.
    Returns False on any problem — the caller falls back to a session-local
    zygote."""
    import fcntl
    import subprocess
    import sys

    from raydp_tpu_torch.cluster.zygote import (
        GLOBAL_MODE_ENV,
        touch_adoption_stamp,
        zygote_marker_path,
        zygote_sock_path,
    )

    # per-uid root (like tempfile/X11 sockets): a shared machine's first
    # user must not own the path and silently lock everyone else out
    root = os.path.join(
        tempfile.gettempdir(), f"raydp_tpu_torch-zygote-{os.getuid()}"
    )
    os.makedirs(root, mode=0o700, exist_ok=True)
    os.chmod(root, 0o700)
    if os.stat(root).st_uid != os.getuid():  # pragma: no cover - hostile /tmp
        return False
    gdir = os.path.join(root, _zygote_source_key())
    os.makedirs(gdir, mode=0o700, exist_ok=True)
    with open(os.path.join(gdir, ".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        gmarker = zygote_marker_path(gdir)
        pid = _marker_pid_alive(gmarker)
        if pid is None:
            genv = dict(env)
            genv[GLOBAL_MODE_ENV] = "1"
            if not genv.get("PYTHONPATH"):
                # the zygote runs python -S: without an explicit PYTHONPATH
                # it cannot resolve site-packages and dies at import
                genv["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
            log = os.path.join(gdir, "zygote.log")
            with open(log, "ab") as out:
                proc = subprocess.Popen(
                    [
                        sys.executable, "-S", "-m",
                        "raydp_tpu_torch.cluster.zygote", gdir,
                    ],
                    stdout=out,
                    stderr=out,
                    env=genv,
                    start_new_session=True,
                )
            pid = proc.pid
            _write_zygote_marker(gmarker, pid)
        # session-side adoption UNDER THE LOCK (the zygote's idle-TTL exit
        # takes this lock too, so a just-adopted template can't vanish
        # between the liveness check and the marker write)
        sock = zygote_sock_path(run_dir)
        try:
            os.unlink(sock)
        except OSError:  # stale symlink may not exist
            pass
        # symlink may dangle until the global zygote binds — the spawn
        # path's connect-retry loop covers the warm-up window
        os.symlink(zygote_sock_path(gdir), sock)
        _write_zygote_marker(zygote_marker_path(run_dir), pid)
        # idle-clock bump UNDER THE LOCK: retirement re-checks
        # this stamp after taking the same flock, so a template exactly at
        # its idle TTL can no longer retire right after we adopted it — the
        # old post-unlock socket poke left exactly that window, stranding
        # the session's marker/symlink on a dead template
        touch_adoption_stamp(gdir)
    # a dead session-local Popen recorded earlier must not shadow the
    # healthy adopted template in zygote_alive()
    _zygote_procs.pop(run_dir, None)
    return True


def start_zygote(run_dir: str, env: Optional[Dict[str, str]] = None) -> None:
    """Provide a pre-warmed fork template for this node (idempotent per
    marker file): adopt the machine-global zygote when possible (one import
    warm-up per machine per source tree), else start a session-local one.
    Called at head/agent boot — and eagerly by cluster.init — so any
    warm-up overlaps other startup work; spawns wait on the socket."""
    import subprocess
    import sys

    from raydp_tpu_torch.cluster.zygote import zygote_marker_path

    env_dict = dict(env if env is not None else os.environ)
    if os.environ.get("RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE") != "1":
        try:
            if _adopt_global_zygote(run_dir, env_dict):
                return
        except Exception:  # session-local fallback follows
            pass  # fall back to the session-local template

    marker = zygote_marker_path(run_dir)
    log = os.path.join(run_dir, "zygote.log")
    with open(log, "ab") as out:
        proc = subprocess.Popen(
            [sys.executable, "-S", "-m", "raydp_tpu_torch.cluster.zygote", run_dir],
            stdout=out,
            stderr=out,
            env=env_dict,
            start_new_session=True,
        )
    _zygote_procs[run_dir] = proc
    _write_zygote_marker(marker, proc.pid)


def stop_zygote(run_dir: str, timeout: float = 10.0) -> None:
    """Stop the session-local zygote THIS process started for ``run_dir``
    (an adopted machine-global template is not ours to stop). The template
    watches its parent, and the parent of the one ``cluster.init`` starts
    is the driver: without this it would outlive ``cluster.shutdown()``
    for as long as the driver runs."""
    import subprocess

    proc = _zygote_procs.pop(run_dir, None)
    if proc is None:
        return
    proc.kill()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:  # unkillable (D state): the OS reaps it later
        pass


def zygote_alive(run_dir: str) -> bool:
    """Is this node's zygote running? Polls (reaps) our own child; falls
    back to a pid probe for a zygote another process started (incl. an
    adopted machine-global one). A ZOMBIE counts as dead (an unreaped
    corpse would otherwise look alive forever), and a REUSED pid counts as
    dead (the probe verifies the cmdline is actually a zygote)."""
    proc = _zygote_procs.get(run_dir)
    if proc is not None:
        return proc.poll() is None
    from raydp_tpu_torch.cluster.zygote import zygote_marker_path

    return _marker_pid_alive(zygote_marker_path(run_dir)) is not None


def _safe_getcwd(fallback: str) -> str:
    """getcwd that tolerates a DELETED working directory (raises
    FileNotFoundError otherwise) — spawns must degrade, not crash."""
    try:
        return os.getcwd()
    except OSError:
        return fallback


def _zygote_request(run_dir: str, req: Dict[str, Any], wait_s: float = 15.0):
    """Send one fork request to the node's zygote; the child pid, or None =
    unavailable (no marker, dead zygote, protocol failure) — callers fall
    back to a cold subprocess start. ``wait_s`` bounds how long to wait for
    a zygote still warming its imports."""
    from raydp_tpu_torch.cluster.zygote import zygote_marker_path, zygote_sock_path

    marker = zygote_marker_path(run_dir)
    if not os.path.exists(marker) or not zygote_alive(run_dir):
        return None
    sock_path = zygote_sock_path(run_dir)
    # the zygote may still be warming its imports; wait for the socket (its
    # warm-up started at node boot, so this is usually instant)
    deadline = time.monotonic() + wait_s
    while True:
        try:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(10.0)
            sock.connect(sock_path)
            break
        except OSError:
            sock.close()
            if time.monotonic() > deadline:
                return None
            if not zygote_alive(run_dir):
                return None  # died while warming
            time.sleep(0.02)
    try:
        send_frame(sock, req)
        status, pid = recv_frame(sock)
    except OSError:
        return None
    finally:
        sock.close()
    if status != "ok":
        return None
    return pid


def _zygote_spawn(spec, incarnation: int, run_dir: str, env: Dict[str, str], log_base: str):
    """Request an actor-worker fork from the node's zygote; None = fall back
    to a cold subprocess start."""
    pid = _zygote_request(
        run_dir,
        {
            "run_dir": run_dir,
            "actor_id": spec.actor_id,
            "incarnation": incarnation,
            "env": env,
            "log_base": log_base,
            # what a cold subprocess start would inherit — the global
            # zygote's own cwd belongs to whichever driver started it
            "cwd": _safe_getcwd(run_dir),
        },
    )
    if pid is None:
        return None
    return ZygoteProc(pid, log_base)


def zygote_fork_main(
    run_dir: str,
    module: str,
    argv: List[str],
    env: Dict[str, str],
    log_base: str,
    wait_s: float = 2.0,
):
    """Fork a MODULE MAIN (head / agent entry point) from the pre-warmed
    zygote: the warm-boot path on a machine whose global template is
    already up — the head becomes a fork with its import set inherited
    copy-on-write, instead of a
    cold ``python -S`` start. Returns a ZygoteProc, or None when no READY
    template exists (absent or still warming — boot must fall back to the
    cold start immediately rather than wait out the warm-up)."""
    from raydp_tpu_torch.cluster.zygote import zygote_sock_path

    if not os.path.exists(zygote_sock_path(run_dir)):
        # exists() follows the adoption symlink: a dangling link means the
        # global template is still importing — cold start wins that race
        return None
    pid = _zygote_request(
        run_dir,
        {
            "kind": "main",
            "module": module,
            "argv": list(argv),
            "run_dir": run_dir,
            "env": dict(env),
            "log_base": log_base,
            "cwd": _safe_getcwd(run_dir),
        },
        wait_s=wait_s,
    )
    if pid is None:
        return None
    return ZygoteProc(pid, log_base)


def launch_worker(spec, incarnation: int, run_dir: str, env: Dict[str, str]):
    """Fork one actor worker process — the single spawn recipe used by both
    the head (local nodes) and node agents (remote nodes): log redirection,
    optional ``-S`` light start, detached session. Light actors fork from
    the node's pre-warmed zygote when one is up (a fork instead of a cold
    start's imports); everything else — and any zygote failure — takes the cold
    subprocess path."""
    import subprocess
    import sys

    log_base = os.path.join(run_dir, f"a-{spec.actor_id}-{incarnation}")
    try:  # a stale marker from a same-(id, incarnation) relaunch would make
        os.unlink(log_base + ".exit")  # the new child look dead at birth
    except OSError:  # stale exit marker may not exist
        pass
    if getattr(spec, "light", True):
        proc = _zygote_spawn(spec, incarnation, run_dir, env, log_base)
        if proc is not None:
            return proc
    with open(log_base + ".out", "ab") as out, open(log_base + ".err", "ab") as err:
        return subprocess.Popen(
            [sys.executable]
            + (["-S"] if getattr(spec, "light", True) else [])
            + [
                "-m",
                "raydp_tpu_torch.cluster.worker",
                run_dir,
                spec.actor_id,
                str(incarnation),
            ],
            stdout=out,
            stderr=err,
            env=env,
            start_new_session=True,
        )
