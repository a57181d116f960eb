"""Per-host block service: blocks survive the process that wrote them, the
port's own copy of ``raydp_tpu/store/block_service.py``.

One :class:`BlockService` actor per shared-memory namespace (= per host;
every virtual node on one machine shares /dev/shm), forked warm from the
node's zygote like any light actor, whose actor id is the OWNER of record
for completed blocks.

The handoff is an ownership transfer of the existing segment — zero-copy
and zero extra RPCs. A writer actor's block registration (the
``batched_registration`` frame, or a single ``object_put``) carries a
``handoff`` flag when ``object_store.set_block_service(True)`` is on; the
head, which knows actor liveness authoritatively, records the namespace's
live block service as the owner instead of the writer. Nothing moves: the
segment stays exactly where the writer put it, readers keep mapping shm
directly, and the registration reply tells the writer the effective owner
so its location cache (and the metas it pushes to peers) stay truthful.

What this buys:

- a writer's SIGKILL no longer loses blocks — the owner of record is
  alive, so nothing is unregistered and reads keep hitting shm;
- the lease-stamped head-bypass location cache never goes stale on the
  writer's death (the cached owner is the service, which is still alive);
- remote fetches get a first-class owner to talk to: the head advertises
  a live service's TCP socket as ``service_addr`` in location records, and
  the store's fetch path prefers it (with the jittered-backoff retry
  ladder in ``object_store._fetch_chunk`` riding out service restarts).

The service is also the cluster's cross-host DATA PLANE:

- ``block_fetch_raw`` streams a block range zero-copy: the actor serve
  loop mmaps the segment (``common.serve_block_view``) and sendall()s the
  pages straight onto the socket — no pickle, no intermediate copy — and
  the client side receives with ``recv_into`` directly into the caller's
  destination buffer, so a fetched block lands as a mapped ``pa.Buffer``
  with exactly one wire copy end to end;
- ``service_block_fetch`` runs over a small per-process CONNECTION POOL
  (idle timeout + liveness probe) instead of a fresh TCP handshake per
  ranged read; ``object_store._remote_fetch`` issues multi-chunk reads in
  parallel over it;
- ``block_put`` accepts a remote writer's block and hosts it on THIS
  host — the third storage tier (``spill-to-remote``) the store escalates
  to when local shm is full and ``mem.pressure`` is high.

The service itself is deliberately STATELESS: segments live in /dev/shm
and ownership lives at the head, so a crash-restart (same actor identity,
``max_restarts``) loses nothing. An intentional kill is real loss — the
head's owner-death path tombstones and unlinks every service-owned block.
"""

from __future__ import annotations

import os
import select
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

BLOCK_SERVICE_SUFFIX = "_BLOCK_SERVICE"

STREAM_FETCH_ENV = "RAYDP_TPU_TORCH_STREAM_FETCH"
POOL_SIZE_ENV = "RAYDP_TPU_TORCH_FETCH_POOL"
POOL_IDLE_ENV = "RAYDP_TPU_TORCH_FETCH_POOL_IDLE_S"


class BlockService:
    """The per-host block-server actor. Owns completed blocks in the head's
    metadata table and serves their bytes to remote readers; holds no block
    state of its own (see module docstring — restart must be free)."""

    def __init__(self, app_name: str = ""):
        self.app_name = app_name
        import threading

        from raydp_tpu_torch.sanitize import named_lock

        self._lock = named_lock("store.block_service", threading.Lock())
        self._stats = {"fetches": 0, "bytes_served": 0, "puts": 0, "bytes_put": 0}  # guarded-by: self._lock

    def ping(self) -> str:
        return "pong"

    def block_fetch(self, shm_name: str, offset: int = 0, length: int = -1) -> bytes:
        """Serve a local block's bytes (either tier: shm segment or spill
        file) to a remote reader — the same primitive the head and node
        agents expose, now answered by the blocks' owner of record."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.cluster.common import serve_block_bytes

        with obs.span("block_service.fetch", shm_name=shm_name):
            data = serve_block_bytes(shm_name, offset, length)
        self._count_fetch(len(data))
        return data

    def block_fetch_raw(self, shm_name: str, offset: int = 0, length: int = -1):
        """Streaming variant: return a :class:`common.RawView` over an mmap
        of the block range. The worker serve loop streams it onto the
        socket unpickled (``("raw", size)`` header + raw bytes) — the
        zero-copy half of the cross-host data plane."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.cluster.common import serve_block_view

        with obs.span("block_service.fetch", shm_name=shm_name, raw=True):
            raw = serve_block_view(shm_name, offset, length)
        self._count_fetch(raw.size)
        return raw

    def block_put(self, object_id: str, payload: bytes, storage: str = "auto") -> dict:
        """Host a REMOTE writer's block on this service's host and register
        it under this actor's ownership — the spill-to-remote tier. The
        writer's local shm was full (``_should_spill``) and under memory
        pressure; rather than its own disk, the bytes land in a peer host's
        shm where readers reach them through the normal service fetch path.
        Returns the meta view the writer should cache as the location."""
        from raydp_tpu_torch import obs
        from raydp_tpu_torch.cluster import api as cluster_api
        from raydp_tpu_torch.cluster.common import host_id, shm_namespace
        from raydp_tpu_torch.cluster.worker import current_context
        from raydp_tpu_torch.store import object_store as store

        payload = bytes(payload)
        with obs.span("block_service.put", object_id=object_id, n=len(payload)):
            shm_name = store.host_block_locally(object_id, payload, storage=storage)
            ctx = current_context()
            owner = ctx.actor_id if ctx is not None else store.current_owner()
            node_id = (ctx.node_id if ctx is not None else "") or "driver"
            cluster_api.head_rpc(
                "object_put", object_id=object_id, owner=owner,
                shm_name=shm_name, size=len(payload), node_id=node_id,
                shm_ns=shm_namespace(),
            )
        obs.metrics.counter("block_service.remote_puts").inc()
        with self._lock:
            self._stats["puts"] += 1
            self._stats["bytes_put"] += len(payload)
        from raydp_tpu_torch.obs import flush_throttled

        flush_throttled(2.0)
        return {
            "object_id": object_id, "owner": owner, "shm_name": shm_name,
            "size": len(payload), "node_id": node_id,
            "shm_ns": shm_namespace(), "host": host_id(),
        }

    def _count_fetch(self, n: int) -> None:
        from raydp_tpu_torch import obs

        obs.metrics.counter("block_service.fetches").inc()
        obs.metrics.counter("block_service.bytes_served").inc(n)
        with self._lock:
            self._stats["fetches"] += 1
            self._stats["bytes_served"] += n
        from raydp_tpu_torch.obs import flush_throttled

        flush_throttled(2.0)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)


# ---------------------------------------------------------------------------
# pooled streaming client
#
# One small per-process pool of actor-protocol connections, keyed by
# service address. A shuffle reduce fetches hundreds of ranged chunks from
# the same few services; a TCP handshake (and token round-trip) per chunk
# was measurable drag and file-descriptor churn. Entries carry an idle
# stamp (pruned past RAYDP_TPU_TORCH_FETCH_POOL_IDLE_S) and are liveness-probed
# before reuse: the service never sends unsolicited bytes, so a readable
# pooled socket can only mean EOF/RST — a restarted or dead peer — and is
# dropped instead of reused. Errors mid-call close the socket rather than
# returning it (a half-consumed reply must never leak to the next caller).
# ---------------------------------------------------------------------------

def _pool_size() -> int:
    try:
        return max(1, int(os.environ.get(POOL_SIZE_ENV, "4")))
    except ValueError:
        return 4


def _pool_idle_s() -> float:
    try:
        return float(os.environ.get(POOL_IDLE_ENV, "30"))
    except ValueError:
        return 30.0


def _stream_fetch_enabled() -> bool:
    return os.environ.get(STREAM_FETCH_ENV, "1").lower() not in ("0", "false", "no")


class _ServicePool:
    def __init__(self):
        from raydp_tpu_torch.sanitize import named_lock

        self._lock = named_lock("store.service_pool", threading.Lock())
        self._idle: Dict[str, List[Tuple[socket.socket, float]]] = {}  # guarded-by: self._lock
        self.stats = {  # guarded-by: self._lock
            "connections_opened": 0,
            "reuses": 0,
            "evicted_idle": 0,
            "evicted_stale": 0,
        }

    def acquire(self, addr: str, timeout: float) -> socket.socket:
        now = time.monotonic()
        idle_cut = now - _pool_idle_s()
        stale: List[socket.socket] = []
        sock: Optional[socket.socket] = None
        with self._lock:
            entries = self._idle.get(addr, [])
            while entries:
                cand, stamp = entries.pop()
                if stamp < idle_cut:
                    stale.append(cand)
                    self.stats["evicted_idle"] += 1
                    continue
                # liveness probe: readable ⇒ the peer closed (or spoke out
                # of turn — equally unusable); select on a connected TCP/UDS
                # socket with zero timeout is just a poll syscall
                try:
                    readable, _, _ = select.select([cand], [], [], 0)
                except (OSError, ValueError):
                    readable = [cand]
                if readable:
                    stale.append(cand)
                    self.stats["evicted_stale"] += 1
                    continue
                sock = cand
                self.stats["reuses"] += 1
                break
        for dead in stale:
            try:
                dead.close()
            except OSError:  # already dead
                pass
        if sock is not None:
            sock.settimeout(timeout)
            return sock
        from raydp_tpu_torch.cluster.common import connect

        sock = connect(addr, timeout)
        with self._lock:
            self.stats["connections_opened"] += 1
        return sock

    def release(self, addr: str, sock: socket.socket) -> None:
        now = time.monotonic()
        evict: Optional[socket.socket] = None
        with self._lock:
            entries = self._idle.setdefault(addr, [])
            if len(entries) >= _pool_size():
                evict = entries.pop(0)[0]
            entries.append((sock, now))
        if evict is not None:
            try:
                evict.close()
            except OSError:  # eviction is best-effort
                pass

    def discard(self, sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:  # already closed
            pass

    def close_all(self) -> None:
        with self._lock:
            entries = [s for lst in self._idle.values() for s, _ in lst]
            self._idle.clear()
        for sock in entries:
            try:
                sock.close()
            except OSError:  # teardown
                pass

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["idle"] = sum(len(v) for v in self._idle.values())
            return out


_pool = _ServicePool()


def service_pool_stats() -> dict:
    """Pool counters for tests and the observatory (connections_opened is
    the regression signal: N sequential fetches to one service must not
    open N sockets)."""
    return _pool.snapshot()


def close_service_pool() -> None:
    """Drop every pooled connection (cluster shutdown / fork hygiene)."""
    _pool.close_all()


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed connection mid-stream")
        got += r


def _service_call(sock, method: str, args: tuple, into: Optional[memoryview]):
    """One request/reply on an established actor-protocol connection.
    Returns (bytes_like_or_len, raw_used)."""
    from raydp_tpu_torch.cluster.common import (
        recv_frame,
        send_frame,
        traced_request,
    )

    send_frame(sock, traced_request((method, args, {}, False)))
    status, value = recv_frame(sock)
    if status == "raw":
        size = int(value)
        if into is not None:
            if size != len(into):
                # drain to keep the stream coherent, then fail loudly
                _recv_exact_into(sock, memoryview(bytearray(size)))
                raise ConnectionError(
                    f"raw block reply size {size} != expected {len(into)}"
                )
            _recv_exact_into(sock, into)
            return size, True
        buf = bytearray(size)
        _recv_exact_into(sock, memoryview(buf))
        return bytes(buf), True
    if status == "ok":
        if into is not None:
            data = memoryview(value)
            if len(data) != len(into):
                raise ConnectionError(
                    f"block reply size {len(data)} != expected {len(into)}"
                )
            into[:] = data
            return len(data), False
        return value, False
    # application-level error, shipped in a fully-consumed reply frame: the
    # connection is still coherent. Tag it so the pool RELEASES instead of
    # discarding — FileNotFoundError (segment gone) is an OSError subclass
    # and would otherwise be mistaken for a transport failure.
    try:
        value._raydp_stream_clean = True
    except (AttributeError, TypeError):  # tag is best-effort
        pass
    raise value


def service_block_fetch(
    addr: str, shm_name: str, offset: int, length: int,
    timeout: float = 300.0, into: Optional[memoryview] = None,
):
    """One ranged ``block_fetch`` against a BlockService ACTOR socket over
    the pooled streaming transport. Actors speak the 4-tuple method frame
    (worker.py), not the head/agent 2-tuple op frame — this is the store's
    client for ``service_addr`` location records.

    With ``into`` the bytes land directly in the caller's buffer (parallel
    chunked fetch assembles one destination with no join copy) and the byte
    count is returned; without it a bytes object is returned."""
    method = "block_fetch_raw" if _stream_fetch_enabled() else "block_fetch"
    sock = _pool.acquire(addr, timeout)
    try:
        try:
            result, _ = _service_call(
                sock, method, (shm_name, offset, length), into
            )
        except AttributeError:
            # a service without block_fetch_raw: the error reply
            # leaves the stream clean, so fall back on the same connection
            result, _ = _service_call(
                sock, "block_fetch", (shm_name, offset, length), into
            )
    except OSError as exc:
        if getattr(exc, "_raydp_stream_clean", False):
            _pool.release(addr, sock)  # app error in OSError clothing
        else:
            _pool.discard(sock)
        raise
    except BaseException:
        # application-level error (e.g. FileNotFoundError pickled by the
        # service): the reply was fully consumed, the connection is clean
        _pool.release(addr, sock)
        raise
    else:
        _pool.release(addr, sock)
    return result


def service_block_put(
    addr: str, object_id: str, payload: bytes, storage: str = "auto",
    timeout: float = 300.0,
) -> dict:
    """Ship a block to a peer host's service (the spill-to-remote tier
    writer side) over the pooled transport; returns the registered meta."""
    sock = _pool.acquire(addr, timeout)
    try:
        result, _ = _service_call(
            sock, "block_put", (object_id, bytes(payload), storage), None
        )
    except OSError as exc:
        if getattr(exc, "_raydp_stream_clean", False):
            _pool.release(addr, sock)
        else:
            _pool.discard(sock)
        raise
    except BaseException:
        _pool.release(addr, sock)
        raise
    else:
        _pool.release(addr, sock)
    return result


def service_for_namespace(shm_ns: str = "", tenant: str = "") -> Optional[str]:
    """The actor id of the block service registered for a shared-memory
    namespace — the ``tenant``-scoped entry first, the namespace's tenant-
    less fallback second (None when that host runs without one —
    registrations there keep their writer's ownership)."""
    from raydp_tpu_torch.cluster import api as cluster_api

    return cluster_api.head_rpc(
        "block_service_lookup", shm_ns=shm_ns, tenant=tenant
    )


def service_peers(exclude_host: str = "") -> list:
    """Live block services on OTHER hosts, as ``{actor_id, shm_ns, host,
    service_addr}`` rows — the spill-to-remote tier's target list."""
    from raydp_tpu_torch.cluster import api as cluster_api

    peers = cluster_api.head_rpc("block_service_peers") or []
    return [p for p in peers if p.get("host", "") != exclude_host]


def register_service(actor_id: str, tenant: str = "") -> str:
    """Record a spawned BlockService actor as its node namespace's owner of
    record at the head (scoped to ``tenant`` when given, so one session's
    service never adopts — or tombstones, at stop — another tenant's
    blocks); returns the namespace it now serves."""
    from raydp_tpu_torch.cluster import api as cluster_api

    return cluster_api.head_rpc(
        "block_service_register", actor_id=actor_id, tenant=tenant
    )


def deregister_service(actor_id: str) -> bool:
    """Drop a service from the head's owner-kind table WITHOUT killing it:
    registrations fall back to executor ownership (the A/B toggle the
    bench's two-tier recovery probe flips mid-session)."""
    from raydp_tpu_torch.cluster import api as cluster_api

    return cluster_api.head_rpc("block_service_unregister", actor_id=actor_id)
