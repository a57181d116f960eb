"""Object store: shared-memory blocks with ownership semantics, the port's
own copy of ``raydp_tpu/store/object_store.py``.

The exchange currency is the Arrow IPC stream block. The store is native
/dev/shm segments (C++, ``native/store.cpp``, built with ``g++`` at first
use), and ownership lives in the head process:

- every object has an *owner* (an actor id, or the driver); when the owner
  dies, un-transferred objects are GC'd and reads raise ``OwnerDiedError``;
- ``transfer()`` re-assigns ownership (to e.g. a long-lived holder actor) so
  data outlives the process that produced it.

Reads are zero-copy: the mapped segment is exposed to pyarrow as a foreign
buffer feeding ``ipc.open_stream`` directly.

Two storage tiers: /dev/shm segments (fast path) and a DISK spill tier
(``<session>/spill/rtpt-*`` files, mmap'd on read). Writes spill
automatically when shm is near-full (or the ``RAYDP_TPU_TORCH_SHM_CAPACITY``
cap is exceeded) — a dataset larger than shm degrades to memory-and-disk
instead of failing. ``storage="disk"`` forces the spill tier (DISK_ONLY
semantics).

Segments are named ``rtpt-<ns>-<id>`` (``common.SHM_PREFIX``) and every
environment variable carries ``RAYDP_TPU_TORCH_``, so a JAX session and a
port session on one host never count, serve or unlink each other's blocks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import uuid
from dataclasses import dataclass
from typing import List, Optional, Sequence

from raydp_tpu_torch.cluster import api as cluster_api
from raydp_tpu_torch.cluster.common import (
    DRIVER_OWNER,
    SESSION_ENV,
    SHM_PREFIX,
    ClusterError,
    OwnerDiedError,
    object_meta_entry,
    rpc,
    shm_namespace,
    unlink_block,
)

# observability: cross-node pulls vs local zero-copy maps (tests assert the
# pull path actually ran in multi-node scenarios)
stats = {"remote_fetches": 0, "remote_bytes": 0}

# ---------------------------------------------------------------------------
# head-bypass location cache
#
# Every registration already knows the full location record it sends to the
# head (object_meta_entry), so the writer caches it locally; readers resolve
# through the cache first and only RPC the head for misses. Compiled-plan
# dispatches additionally PUSH lease-stamped entries with the task specs
# (ReadSpec.metas), so a reducer resolving sibling map outputs — blocks it
# never wrote — still skips the head on the warm path. Entries are
# lease-stamped: expired entries take the head miss path, and a read that
# finds a cache-served segment gone retries once through the head (which is
# authoritative for deletion and owner-death, so OwnerDiedError semantics
# survive the bypass).
# ---------------------------------------------------------------------------

LOCATION_LEASE_ENV = "RAYDP_TPU_TORCH_LOCATION_LEASE_S"
_LOCATION_CACHE_CAP = 8192
_location_enabled = True
_location_cache: dict = {}  # object_id -> (meta, stamp, lease_s); guarded-by: _location_lock


def default_location_lease_s() -> float:
    import os as _os

    try:
        return float(_os.environ.get(LOCATION_LEASE_ENV, "") or 120.0)
    except ValueError:
        return 120.0


def set_location_cache(enabled: bool) -> None:
    """Session-conf toggle (``planner.head_bypass``): off = every lookup is
    a head RPC, the pre-cache behavior (the A/B parity path)."""
    global _location_enabled
    _location_enabled = bool(enabled)
    if not enabled:
        with _location_lock:
            _location_cache.clear()


# ---------------------------------------------------------------------------
# block-service handoff (store/block_service.py)
#
# With ``store.block_service`` on (session default), an ACTOR's block
# registrations are flagged for handoff: the head records the namespace's
# live per-host block service as the owner instead of this executor — an
# ownership transfer of the existing segment, zero-copy, riding the same
# (batched) registration frame. The reply names the effective owner so the
# writer's cached location (and the metas it pushes with task results)
# carry the service, keeping the head-bypass cache truthful across
# executor death.
#
# The MODULE default is off: only processes the ETL plane configures —
# executors (via their configs dict) and the session driver — participate.
# SPMD rank actors, holder actors, and standalone store users keep
# self-ownership exactly as before.
# ---------------------------------------------------------------------------

_block_service_on = False


def set_block_service(enabled: bool) -> None:
    """Session-conf toggle (``store.block_service``): off = executors own
    their blocks (what an executor's death takes with it) — the A/B
    parity arm."""
    global _block_service_on
    _block_service_on = bool(enabled)


def block_service_enabled() -> bool:
    return _block_service_on


def _adopt_owner(object_id: str, owner: str) -> None:
    """The head reassigned a handoff registration to the block service:
    patch this process's cached location so reads (and the pushed
    ReadSpec.metas built from ``local_meta``) name the LIVE owner, not the
    executor that happened to write the bytes."""
    from raydp_tpu_torch.obs import metrics

    metrics.counter("block_service.handoffs").inc()
    with _location_lock:
        entry = _location_cache.get(object_id)
        if entry is not None:
            entry[0]["owner"] = owner


def cache_location(
    object_id: str, meta: dict, stamp: Optional[float] = None,
    lease_s: Optional[float] = None,
) -> None:
    import time as _time

    if not _location_enabled:
        return
    with _location_lock:
        if len(_location_cache) >= _LOCATION_CACHE_CAP:
            # FIFO eviction: dict order is insertion order
            for old in list(_location_cache)[: _LOCATION_CACHE_CAP // 8]:
                del _location_cache[old]
        _location_cache[object_id] = (
            dict(meta),
            _time.monotonic() if stamp is None else stamp,
            default_location_lease_s() if lease_s is None else lease_s,
        )


def cached_location(object_id: str) -> Optional[dict]:
    """A lease-fresh, locally-usable location record, or None (miss path).
    The returned dict is marked ``cached`` so readers know a mapping failure
    should retry through the head instead of raising."""
    import time as _time

    if not _location_enabled:
        return None
    with _location_lock:
        entry = _location_cache.get(object_id)
    if entry is None:
        return None
    meta, stamp, lease_s = entry
    if _time.monotonic() - stamp > lease_s:
        return None  # lease expired: authoritative path
    if meta.get("shm_ns", "") != shm_namespace() and not meta.get("fetch_addr"):
        return None  # foreign block with no pull address: must ask the head
    out = dict(meta)
    out["cached"] = True
    return out


def evict_location(object_id: str) -> None:
    with _location_lock:
        _location_cache.pop(object_id, None)


# ---------------------------------------------------------------------------
# dead-owner registry (head-bypass stale-location fast path)
#
# A cache-served read that finds its segment gone cannot tell "deleted /
# moved" (retry through the head — it may have been lineage-rebound) from
# "owner is dead" (the head would just raise OwnerDiedError). This process
# REMEMBERS owners it has seen die — from head OwnerDiedError replies and
# from the session's own intentional executor kills — so the stale-location
# path raises OwnerDiedError immediately and lineage recovery triggers
# without a wasted head round trip. Bounded; cleared with the cache toggle.
# ---------------------------------------------------------------------------

import collections as _collections  # noqa: E402

_DEAD_OWNER_CAP = 1024
_dead_owners: "_collections.OrderedDict" = _collections.OrderedDict()  # guarded-by: _location_lock


def note_owner_dead(owner: Optional[str]) -> None:
    """Record that ``owner``'s objects are gone for good (fed by head
    OwnerDiedError replies and by intentional executor kills)."""
    if not owner or owner == DRIVER_OWNER:
        return
    with _location_lock:
        _dead_owners[owner] = True
        _dead_owners.move_to_end(owner)
        while len(_dead_owners) > _DEAD_OWNER_CAP:
            _dead_owners.popitem(last=False)


def owner_known_dead(owner: Optional[str]) -> bool:
    if not owner:
        return False
    with _location_lock:
        return owner in _dead_owners


def _note_dead_owner_from(exc: BaseException) -> None:
    note_owner_dead(getattr(exc, "owner", None))


# ids THIS process deliberately deleted (bounded): lineage recovery refuses
# to resurrect them at depth 0 — "deleted" must stay deleted. Keyed locally
# (not by head tombstone absence) so a mass owner-death that overflows the
# head's tombstone table can never be misread as deletion and refused.
_RECENT_DELETE_CAP = 8192
_recent_deletes: "_collections.OrderedDict" = _collections.OrderedDict()  # guarded-by: _location_lock


def _note_deleted(object_ids) -> None:
    with _location_lock:
        for oid in object_ids:
            _recent_deletes[oid] = True
            _recent_deletes.move_to_end(oid)
        while len(_recent_deletes) > _RECENT_DELETE_CAP:
            _recent_deletes.popitem(last=False)


def was_deleted_here(object_id: str) -> bool:
    with _location_lock:
        return object_id in _recent_deletes


def seed_locations(entries: dict) -> None:
    """Adopt lease-stamped entries pushed with a task's ReadSpecs:
    ``{object_id: (meta, age_s)}`` where ``age_s`` is how old the entry
    already was when the DRIVER shipped it (monotonic clocks don't compare
    across processes, so the wire format carries age, not a timestamp)."""
    import time as _time

    now = _time.monotonic()
    for object_id, (meta, age_s) in entries.items():
        cache_location(object_id, meta, stamp=now - max(0.0, float(age_s)))


from raydp_tpu_torch import sanitize as _sanitize

# the native library is built at first use from the port's own copy of the
# source, beside the package in the git-ignored build/ tree, named by a hash
# of the source and the flags (an edit builds a new library, never loads a
# stale one)
_NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "store.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "raydp_tpu_torch_store",
)
_GXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lib_lock = _sanitize.named_lock("store._lib_lock", threading.Lock())
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lib_lock
_location_lock = _sanitize.named_lock("store.location_cache", threading.Lock())


def native_library_path() -> str:
    import hashlib

    digest = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    with open(_NATIVE_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"libraydp_tpu_torch_store_{digest.hexdigest()[:16]}.so")


def _build_native(target: str) -> None:
    """Compile the library into ``target``: under an flock, to a temporary
    name renamed into place, so concurrent processes build it once and never
    load a half-written file."""
    import fcntl

    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.exists(target):
            return
        tmp = f"{target}.tmp.{os.getpid()}"
        # one-time lazy build: every caller needs the library before it can
        # do anything, and this path takes no other lock. -lrt: shm_open and
        # shm_unlink live in librt on pre-2.34 glibc, and a light (python
        # -S) actor may not have librt mapped when it loads the library
        run = subprocess.run(
            ["g++", *_GXX_FLAGS, "-o", tmp, _NATIVE_SRC, "-lrt"],
            capture_output=True, text=True,
        )
        if run.returncode != 0:
            raise OSError(f"building the native store failed:\n{run.stderr}")
        os.replace(tmp, target)


def _load_native() -> ctypes.CDLL:
    """Load (building if needed) the native store library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = native_library_path()
        if not os.path.exists(path):
            _build_native(path)
        lib = ctypes.CDLL(path)
        lib.rtpu_shm_create.restype = ctypes.c_void_p
        lib.rtpu_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_shm_finalize.restype = ctypes.c_int
        lib.rtpu_shm_finalize.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_shm_map.restype = ctypes.c_void_p
        lib.rtpu_shm_map.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        lib.rtpu_shm_unmap.restype = ctypes.c_int
        lib.rtpu_shm_unmap.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_shm_unlink.restype = ctypes.c_int
        lib.rtpu_shm_unlink.argtypes = [ctypes.c_char_p]
        lib.rtpu_shm_put.restype = ctypes.c_int
        lib.rtpu_shm_put.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_errno.restype = ctypes.c_int
        _lib = lib
        return lib


def current_owner() -> str:
    """The owner id for objects created by this process: the enclosing actor,
    or the driver sentinel."""
    from raydp_tpu_torch.cluster.worker import current_context

    ctx = current_context()
    return ctx.actor_id if ctx is not None else DRIVER_OWNER


@dataclass(frozen=True)
class ObjectRef:
    """Picklable reference to one stored block."""

    object_id: str
    size: int

    @property
    def shm_name(self) -> str:
        """The segment name in THIS node's namespace — valid for writers
        (who create locally); readers must use the registered shm_name from
        the head, which carries the PRODUCER's namespace."""
        return _local_shm_name(self.object_id)


def _local_shm_name(object_id: str) -> str:
    ns = shm_namespace()
    return f"/{SHM_PREFIX}{ns}-{object_id}" if ns else f"/{SHM_PREFIX}{object_id}"


class _MappedBuffer:
    """Owns an mmap of a segment; keeps it alive for zero-copy consumers.
    ``size`` is the logical object size; ``mapped_size`` the mapping length."""

    def __init__(self, lib: ctypes.CDLL, ptr: int, size: int, mapped_size: Optional[int] = None):
        self._lib = lib
        self.ptr = ptr
        self.size = size
        self.mapped_size = size if mapped_size is None else mapped_size

    def memoryview(self) -> memoryview:
        if self.size == 0:
            return memoryview(b"")
        # route through an arrow foreign buffer so the returned view keeps this
        # mapping alive (ctypes.from_address would dangle after GC → segfault)
        import pyarrow as pa

        return memoryview(pa.foreign_buffer(self.ptr, self.size, base=self))

    def __del__(self):
        try:
            if self.ptr:
                self._lib.rtpu_shm_unmap(ctypes.c_void_p(self.ptr), self.mapped_size)
        except Exception:  # __del__ teardown must never raise
            pass


class WritableBlock:
    """A created-but-unsealed segment writers stream Arrow IPC into directly
    (no staging copy): ``block = create_block(cap); sink = block.arrow_sink();
    ... ; ref = block.seal(owner)``."""

    def __init__(self, object_id: str, capacity: int):
        import mmap as _mmap

        self.object_id = object_id
        self.capacity = capacity
        self._lib = _load_native()
        self._name = _local_shm_name(object_id).encode()
        ptr = self._lib.rtpu_shm_create(self._name, capacity)
        if not ptr:
            raise OSError(
                f"shm create failed (errno={self._lib.rtpu_errno()}) for {capacity} bytes"
            )
        # drop the C++ mapping; writers need a *writable* python-buffer view,
        # which pyarrow only honors through the buffer protocol (mmap)
        self._lib.rtpu_shm_unmap(ctypes.c_void_p(ptr), capacity)
        self._file = open("/dev/shm" + self._name.decode(), "r+b")
        self._mmap = _mmap.mmap(self._file.fileno(), capacity)
        self._sealed = False
        _sanitize.track_block(
            self._name.decode(), "/dev/shm" + self._name.decode()
        )

    def arrow_sink(self):
        """A pyarrow FixedSizeBufferWriter over the raw segment (writes stream
        straight into shared memory; no staging copy)."""
        import pyarrow as pa

        return pa.FixedSizeBufferWriter(pa.py_buffer(self._mmap))

    def writable_view(self) -> memoryview:
        """A writable memoryview over the raw segment, for callers that use
        the block as a long-lived mutable arena (the serve KV cache) rather
        than a seal-once IPC sink. The block stays unsealed; release with
        ``abort()`` when the arena is retired. Living in shm keeps the arena
        visible to the memory-watermark plane (``mem.shm_bytes`` scans
        /dev/shm) and the leak audit."""
        if self._sealed:
            raise ClusterError("block already sealed")
        return memoryview(self._mmap)

    def _close_mapping(self) -> None:
        try:
            self._mmap.close()
        except BufferError:  # an arrow sink still holds the buffer; kernel keeps the pages
            pass  # an arrow sink still holds the buffer; kernel keeps the pages
        self._file.close()

    def seal(self, written: int, owner: Optional[str] = None) -> ObjectRef:
        if self._sealed:
            raise ClusterError("block already sealed")
        if written > self.capacity:
            raise ClusterError(f"wrote {written} past capacity {self.capacity}")
        self._close_mapping()
        if written < self.capacity:
            if self._lib.rtpu_shm_finalize(self._name, written) != 0:
                err = self._lib.rtpu_errno()
                self._lib.rtpu_shm_unlink(self._name)
                self._sealed = True
                raise OSError(f"shm finalize failed (errno={err})")
        ref = ObjectRef(self.object_id, written)
        try:
            _register(ref, owner)
        except BaseException:
            self._lib.rtpu_shm_unlink(self._name)
            self._sealed = True
            raise
        self._sealed = True
        return ref

    def abort(self) -> None:
        if not self._sealed:
            self._close_mapping()
            self._lib.rtpu_shm_unlink(self._name)
            self._sealed = True


def _register(ref: ObjectRef, owner: Optional[str], shm_name: Optional[str] = None) -> None:
    from raydp_tpu_torch.cluster.worker import current_context
    from raydp_tpu_torch.obs import metrics

    metrics.counter("store.blocks_written").inc()
    metrics.counter("store.bytes_written").inc(ref.size)
    if (shm_name or "").startswith("file://"):
        metrics.counter("store.blocks_spilled").inc()
    if cluster_api.is_tcp_client():
        raise ClusterError(
            "tcp:// client processes cannot host object-store blocks (no "
            "block server runs on a client machine, so nothing could ever "
            "serve them); create data through the cluster — e.g. "
            "session.read_parquet / executor-side tasks — or attach by "
            "session dir on the head host"
        )
    ctx = current_context()
    entry = object_meta_entry(
        object_id=ref.object_id,
        owner=owner or current_owner(),
        shm_name=shm_name or ref.shm_name,
        size=ref.size,
        node_id=ctx.node_id if ctx else "driver",
        shm_ns=shm_namespace(),
    )
    # the writer knows the full location record: cache it so this process's
    # own reads (and the compiled-plan dispatches that push it to peers)
    # never ask the head where the block lives
    cache_location(ref.object_id, entry)
    wire = entry
    if _block_service_on and ctx is not None and owner is None:
        # actor-produced block with default self-ownership: flag it for the
        # per-host block-service handoff. The HEAD decides (it knows the
        # service's liveness) and the reply names the effective owner; an
        # explicit owner (ObjectHolder, recovery rebinds with a pinned
        # target) is never second-guessed.
        wire = dict(entry, handoff=True)
    staged = getattr(_register_batch_tls, "stack", None)
    if staged:
        # a batched_registration() scope is active on this thread: stage the
        # entry; ONE object_put_batch frame ships everything at scope exit
        staged[-1].append(wire)
        return
    effective = cluster_api.head_rpc("object_put", **wire)
    if isinstance(effective, str) and effective != entry["owner"]:
        _adopt_owner(ref.object_id, effective)


# ---------------------------------------------------------------------------
# batched metadata registration
# ---------------------------------------------------------------------------

_register_batch_tls = threading.local()


def _flush_register_batch(entries: List[dict]) -> None:
    """Ship staged registrations as one RPC frame; falls back to per-entry
    puts against an older head that lacks the batch handler."""
    if not entries:
        return
    if len(entries) == 1:
        effective = cluster_api.head_rpc("object_put", **entries[0])
        if isinstance(effective, str) and effective != entries[0]["owner"]:
            _adopt_owner(entries[0]["object_id"], effective)
        return
    from raydp_tpu_torch.obs import metrics

    try:
        reassigned = cluster_api.head_rpc("object_put_batch", entries=entries)
        metrics.counter("store.register_batches").inc()
        if isinstance(reassigned, dict):
            # block-service handoff: the head named the effective owner for
            # every reassigned entry — correct the cache in the same frame
            for object_id, owner in reassigned.items():
                _adopt_owner(object_id, owner)
    except ClusterError as exc:
        if "unknown head method" not in str(exc):
            raise
        for entry in entries:
            # an older head has no batch op — and no handoff kwarg (nor a
            # service to adopt): strip the flag so the compat path degrades
            # to executor ownership instead of a TypeError
            cluster_api.head_rpc(
                "object_put",
                **{k: v for k, v in entry.items() if k != "handoff"},
            )


def _discard_staged(entries: List[dict]) -> None:
    """Failure cleanup for a batched-registration scope: some entries MAY
    have registered (partial per-entry fallback, or a batch frame that
    applied but whose reply was lost) — head metadata left pointing at
    locally-unlinked segments would turn later reads into serve failures
    instead of clean not-found errors. Best-effort delete through the head
    FIRST (pops metadata and unlinks registered segments), then unlink
    locally for the never-registered rest."""
    try:
        cluster_api.head_rpc(
            "object_delete", object_ids=[e["object_id"] for e in entries]
        )
    except Exception:
        # head unreachable: metadata dies with the session — counted like
        # _delete_blocks failures so quiet leaks stay visible
        from raydp_tpu_torch.obs import metrics

        metrics.counter("store.delete_failures").inc(len(entries))
    for entry in entries:
        evict_location(entry["object_id"])
        unlink_block(entry["shm_name"])


class batched_registration:
    """Defer this thread's block registrations into ONE ``object_put_batch``
    RPC at scope exit — the metadata side of the shuffle map path (a task
    batch's blocks register in one frame instead of one RPC each). Scopes
    nest (each flushes its own entries). On failure — the scope body raising,
    or the flush itself failing — the staged (never-registered) segments are
    unlinked, matching ``seal()``'s register-failure cleanup."""

    def __enter__(self) -> "batched_registration":
        stack = getattr(_register_batch_tls, "stack", None)
        if stack is None:
            stack = _register_batch_tls.stack = []
        self._entries: List[dict] = []
        stack.append(self._entries)
        return self

    def __exit__(self, exc_type, exc, tb):
        _register_batch_tls.stack.pop()
        if exc_type is not None:
            _discard_staged(self._entries)
            return False
        try:
            _flush_register_batch(self._entries)
        except BaseException:
            _discard_staged(self._entries)
            raise
        return False


# ---------------------------------------------------------------------------
# tenant block namespaces
#
# Object ids minted by a tenant-scoped writer carry the tenant namespace as
# an id prefix (``<tenant>.<hex16>``): the head attributes bytes/quota per
# tenant from the id alone, lineage records / tombstones / deletion records
# are per-tenant by construction (they are keyed by id), and the block-
# service owner table keys on (shm namespace, tenant) so one tenant's stop
# can never adopt or GC another tenant's blocks. Two scopes compose:
#
# - the PROCESS default (``set_tenant_namespace``) — executors belong to
#   exactly one session, so their whole process writes under that tenant;
# - a THREAD overlay (``tenant_scope``) — the driver hosts many sessions,
#   so each query/conversion wraps its writes in the owning session's scope.
#
# Default empty: unprefixed ids, zero behavior change (the tenancy-off A/B
# arm and every pre-tenancy process).
# ---------------------------------------------------------------------------

_default_tenant_ns = ""
_tenant_tls = threading.local()


def set_tenant_namespace(ns: str) -> None:
    """Process-default tenant namespace for newly minted object ids
    (executors set this from their session configs at spawn)."""
    global _default_tenant_ns
    _default_tenant_ns = ns or ""


class tenant_scope:
    """Thread-scoped tenant namespace overlay (driver-side: one process
    hosts many sessions, so each query's writes ride the owning session's
    scope). Nests; restores the previous overlay on exit."""

    def __init__(self, ns: str):
        self._ns = ns or ""
        self._prev: Optional[str] = None

    def __enter__(self) -> "tenant_scope":
        self._prev = getattr(_tenant_tls, "ns", None)
        _tenant_tls.ns = self._ns
        return self

    def __exit__(self, *exc) -> None:
        if self._prev is None:
            _tenant_tls.ns = ""
            del _tenant_tls.ns
        else:
            _tenant_tls.ns = self._prev


def current_tenant_namespace() -> str:
    ns = getattr(_tenant_tls, "ns", None)
    if ns:
        return ns
    return _default_tenant_ns


def new_object_id() -> str:
    ns = current_tenant_namespace()
    suffix = uuid.uuid4().hex[:16]
    return f"{ns}.{suffix}" if ns else suffix


# ---------------------------------------------------------------------------
# disk spill tier
# ---------------------------------------------------------------------------

SHM_CAPACITY_ENV = "RAYDP_TPU_TORCH_SHM_CAPACITY"
_SHM_HEADROOM = 64 << 20  # never fill /dev/shm to the last byte
_SHM_DIR = "/dev/shm"  # the tmpfs the capacity check scans and measures


def _spill_dir() -> str:
    """This node's spill directory (under the session/local dir so cluster
    teardown removes it with everything else)."""
    base = os.environ.get(SESSION_ENV)
    if not base:
        try:
            base = cluster_api.session_dir()
        except Exception:
            import tempfile

            base = tempfile.gettempdir()
    d = os.path.join(base, "spill")
    os.makedirs(d, exist_ok=True)
    return d


def _should_spill(capacity: int) -> bool:
    """Spill when the write wouldn't fit shm: under an explicit test/ops cap
    (total bytes of this framework's segments), or within the headroom of the
    real tmpfs free space."""
    cap = int(os.environ.get(SHM_CAPACITY_ENV, "0") or "0")
    if cap:
        try:
            used = sum(
                e.stat().st_size
                for e in os.scandir(_SHM_DIR)
                if e.name.startswith(SHM_PREFIX)
            )
        except OSError:
            used = 0
        return used + capacity > cap
    try:
        st = os.statvfs(_SHM_DIR)
        return capacity > st.f_bavail * st.f_frsize - _SHM_HEADROOM
    except OSError:
        return False


class _SpillBlock:
    """WritableBlock's disk twin: a plain file in the spill dir, written
    through the same mmap/arrow-sink interface, registered as ``file://``."""

    def __init__(self, object_id: str, capacity: int):
        import mmap as _mmap

        self.object_id = object_id
        self.capacity = capacity
        self.path = os.path.join(_spill_dir(), f"{SHM_PREFIX}{object_id}")
        self._file = open(self.path, "w+b")
        os.ftruncate(self._file.fileno(), max(capacity, 1))
        self._mmap = _mmap.mmap(self._file.fileno(), max(capacity, 1))
        self._sealed = False
        _sanitize.track_block(f"file://{self.path}", self.path, kind="spill")

    def arrow_sink(self):
        import pyarrow as pa

        return pa.FixedSizeBufferWriter(pa.py_buffer(self._mmap))

    def _close_mapping(self) -> None:
        try:
            self._mmap.close()
        except BufferError:  # an arrow sink still holds the buffer
            pass
        self._file.close()

    def seal(self, written: int, owner: Optional[str] = None) -> ObjectRef:
        if self._sealed:
            raise ClusterError("block already sealed")
        if written > self.capacity:
            raise ClusterError(f"wrote {written} past capacity {self.capacity}")
        self._close_mapping()
        os.truncate(self.path, written)
        ref = ObjectRef(self.object_id, written)
        try:
            _register(ref, owner, shm_name=f"file://{self.path}")
        except BaseException:
            try:
                os.unlink(self.path)
            except OSError:  # spill file may already be gone
                pass
            self._sealed = True
            raise
        self._sealed = True
        return ref

    def abort(self) -> None:
        if not self._sealed:
            self._close_mapping()
            try:
                os.unlink(self.path)
            except OSError:  # spill file may already be gone
                pass
            self._sealed = True


_PROXY_CHUNK = 64 << 20  # stay far under the transport's 1 GiB frame cap


def _proxy_put(
    object_id: str, payload: bytes, owner: Optional[str], storage: str = "auto"
) -> None:
    """Ship a tcp client's block to the head, chunked so arbitrarily large
    puts never hit the frame-size cap (the read side chunks the same way).
    ``storage`` forwards the tier request — ``disk`` must mean DISK_ONLY on
    the head too, not wherever the head's own shm pressure happens to be."""
    owner = owner or current_owner()
    if len(payload) <= _PROXY_CHUNK:
        cluster_api.head_rpc(
            "object_put_proxy",
            object_id=object_id,
            payload=payload,
            owner=owner,
            storage=storage,
            timeout=120.0,
        )
        return
    view = memoryview(payload)
    total = -(-len(payload) // _PROXY_CHUNK)
    try:
        for seq in range(total):
            cluster_api.head_rpc(
                "object_put_proxy_chunk",
                object_id=object_id,
                seq=seq,
                payload=bytes(view[seq * _PROXY_CHUNK : (seq + 1) * _PROXY_CHUNK]),
                timeout=120.0,
            )
        cluster_api.head_rpc(
            "object_put_proxy_commit",
            object_id=object_id,
            owner=owner,
            total_chunks=total,
            storage=storage,
            timeout=120.0,
        )
    except BaseException:
        # a failed multi-chunk upload must not pin its partial chunks in head
        # memory until the TTL sweep; best-effort — the head GCs stragglers
        try:
            cluster_api.head_rpc(
                "object_put_proxy_abort", object_id=object_id, timeout=5.0
            )
        except Exception:  # abort rpc is best-effort; the TTL sweep GCs the staging
            pass
        raise


class _ProxyBlock:
    """Writable block for tcp:// client drivers: buffers the Arrow stream
    locally and ships it to the HEAD at seal, which hosts (and serves) the
    bytes on its own node. Same interface as WritableBlock/_SpillBlock."""

    def __init__(self, object_id: str, capacity: int, storage: str = "auto"):
        import pyarrow as pa

        self.object_id = object_id
        self.capacity = capacity
        self.storage = storage
        self._out = pa.BufferOutputStream()
        self._sealed = False

    def arrow_sink(self):
        return self._out

    def seal(self, written: int, owner: Optional[str] = None) -> ObjectRef:
        if self._sealed:
            raise ClusterError("block already sealed")
        if written > self.capacity:  # same contract as WritableBlock
            raise ClusterError(f"wrote {written} past capacity {self.capacity}")
        buf = self._out.getvalue()
        _proxy_put(
            self.object_id, bytes(memoryview(buf)[:written]), owner,
            storage=self.storage,
        )
        self._sealed = True
        return ObjectRef(self.object_id, written)

    def abort(self) -> None:
        self._sealed = True


class _RemoteBlock:
    """Writable block for the spill-to-remote tier: buffers the Arrow
    stream in anonymous memory and ships it to a PEER host's block service
    at seal (local shm was full and under pressure — see
    ``_spill_remote_target``). The peer's service becomes the owner of
    record; on any shipping failure the bytes fall back to the local disk
    tier, so remote spill is strictly opportunistic. Same interface as
    WritableBlock/_SpillBlock/_ProxyBlock."""

    def __init__(self, object_id: str, capacity: int, peer: dict):
        import pyarrow as pa

        self.object_id = object_id
        self.capacity = capacity
        self.peer = peer
        self._out = pa.BufferOutputStream()
        self._sealed = False

    def arrow_sink(self):
        return self._out

    def seal(self, written: int, owner: Optional[str] = None) -> ObjectRef:
        if self._sealed:
            raise ClusterError("block already sealed")
        if written > self.capacity:
            raise ClusterError(f"wrote {written} past capacity {self.capacity}")
        import pyarrow as pa

        buf = pa.py_buffer(memoryview(self._out.getvalue())[:written])
        self._sealed = True
        try:
            return _put_remote(self.object_id, buf, self.peer)
        except Exception:  # remote tier is opportunistic; local disk always works
            from raydp_tpu_torch.obs import metrics

            metrics.counter("store.remote_spill_failures").inc()
            return _put_spill(self.object_id, buf, owner)

    def abort(self) -> None:
        self._sealed = True


def host_block_locally(
    object_id: str, payload: bytes, spill_dir: Optional[str] = None,
    storage: str = "auto",
) -> str:
    """Write bytes into THIS process's node shm (falling back to the disk
    tier; ``storage="disk"`` forces disk, ``"shm"`` is strict and raises on
    failure — same tier contract as ``put``) WITHOUT registering them — the
    head calls this to host a tcp client's proxied block, then inserts the
    metadata itself. Returns the shm/file name to register."""
    n = len(payload)
    name = _local_shm_name(object_id)
    want_shm = storage == "shm" or (
        storage != "disk" and n and not _should_spill(n)
    )
    if want_shm:
        lib = _load_native()
        # the native layer owns the empty-object invariant (size-0 maps a
        # 1-byte segment, store.cpp); the registered size stays authoritative
        cbuf = (ctypes.c_char * max(n, 1)).from_buffer_copy(payload or b"\0")
        rc = lib.rtpu_shm_put(
            name.encode(), ctypes.cast(cbuf, ctypes.c_void_p), n
        )
        if rc == 0:
            _sanitize.track_block(name, "/dev/shm" + name)
            return name
        if storage == "shm":  # strict tier: no silent downgrade to disk
            raise OSError(f"shm put failed (errno={lib.rtpu_errno()})")
    base = spill_dir or _spill_dir()
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"{SHM_PREFIX}{object_id}")
    with open(path, "wb") as f:
        f.write(payload)
    _sanitize.track_block(f"file://{path}", path, kind="spill")
    return f"file://{path}"


def create_block(capacity: int, storage: str = "auto"):
    """A writable block in the requested tier: "auto" prefers shm and spills
    to disk when shm is (nearly) full, "shm" is strict, "disk" forces the
    spill tier (DISK_ONLY semantics). tcp:// client drivers get a proxy
    block hosted on the head at seal (ray-client put parity)."""
    object_id = new_object_id()
    if cluster_api.is_tcp_client():
        return _ProxyBlock(object_id, capacity, storage)
    if storage == "disk":
        return _SpillBlock(object_id, capacity)
    if storage == "auto" and _should_spill(capacity):
        peer = _spill_remote_target(capacity)
        if peer is not None:
            return _RemoteBlock(object_id, capacity, peer)
        return _SpillBlock(object_id, capacity)
    try:
        return WritableBlock(object_id, capacity)
    except OSError:
        if storage == "shm":
            raise
        return _SpillBlock(object_id, capacity)


def put(data, owner: Optional[str] = None, storage: str = "auto") -> ObjectRef:
    """Store a materialized buffer (bytes / memoryview / arrow Buffer)."""
    import pyarrow as pa

    buf = data if isinstance(data, pa.Buffer) else pa.py_buffer(data)
    object_id = new_object_id()
    if cluster_api.is_tcp_client():
        # proxy through the head (ray-client put parity): the client has no
        # block server, so the head hosts and serves the bytes
        _proxy_put(object_id, bytes(memoryview(buf)), owner, storage=storage)
        return ObjectRef(object_id, buf.size)
    if storage == "disk" or (storage == "auto" and _should_spill(buf.size)):
        if storage == "auto":
            peer = _spill_remote_target(buf.size)
            if peer is not None:
                try:
                    return _put_remote(object_id, buf, peer)
                except Exception:  # remote tier is opportunistic; local disk always works
                    from raydp_tpu_torch.obs import metrics

                    metrics.counter("store.remote_spill_failures").inc()
        return _put_spill(object_id, buf, owner)
    lib = _load_native()
    ref = ObjectRef(object_id, buf.size)
    rc = lib.rtpu_shm_put(
        ref.shm_name.encode(), ctypes.c_void_p(buf.address), buf.size
    )
    if rc != 0:
        if storage == "shm":
            raise OSError(f"shm put failed (errno={lib.rtpu_errno()})")
        return _put_spill(object_id, buf, owner)
    _sanitize.track_block(ref.shm_name, "/dev/shm" + ref.shm_name)
    try:
        _register(ref, owner)
    except BaseException:
        lib.rtpu_shm_unlink(ref.shm_name.encode())
        raise
    return ref


def _put_spill(object_id: str, buf, owner: Optional[str]) -> ObjectRef:
    path = os.path.join(_spill_dir(), f"{SHM_PREFIX}{object_id}")
    with open(path, "wb") as f:
        f.write(memoryview(buf))
    _sanitize.track_block(f"file://{path}", path, kind="spill")
    ref = ObjectRef(object_id, buf.size)
    try:
        _register(ref, owner, shm_name=f"file://{path}")
    except BaseException:
        try:
            os.unlink(path)
        except OSError:  # cleanup of a failed spill write
            pass
        raise
    return ref


# ---------------------------------------------------------------------------
# spill-to-remote: the third storage tier
#
# tier order under "auto": local shm → (under memory pressure, with a peer
# host available) a peer host's shm via its block service → local disk.
# Remote beats disk only when this host is genuinely squeezed — the gate is
# the conjunction of _should_spill (the write doesn't fit shm) and the
# mem.pressure watermark the profiler maintains — so single-host runs and
# unpressured spills keep the exact PR-era disk behavior.
# ---------------------------------------------------------------------------

REMOTE_SPILL_ENV = "RAYDP_TPU_TORCH_REMOTE_SPILL"
REMOTE_SPILL_PRESSURE_ENV = "RAYDP_TPU_TORCH_REMOTE_SPILL_PRESSURE"
# a remote spill is one pooled block_put frame; bigger blocks take local disk
_REMOTE_SPILL_MAX = 256 << 20
_PEER_CACHE_TTL_S = 5.0
_peer_cache_lock = _sanitize.named_lock("store.remote_spill_peers", threading.Lock())
_peer_cache: List = [0.0, None]  # guarded-by: _peer_cache_lock


def _remote_spill_enabled() -> bool:
    return os.environ.get(REMOTE_SPILL_ENV, "1").lower() not in ("0", "false", "no")


def _remote_spill_pressure() -> float:
    try:
        return float(os.environ.get(REMOTE_SPILL_PRESSURE_ENV, "0.85"))
    except ValueError:
        return 0.85


def _remote_spill_peer() -> Optional[dict]:
    """A live block service on ANOTHER host (addr + namespace row), or None.
    Cached a few seconds: the spill path must not add a head RPC per block
    while a query churns through a full shm."""
    import time as _time

    from raydp_tpu_torch.cluster.common import host_id

    now = _time.monotonic()
    with _peer_cache_lock:
        stamp, peers = _peer_cache
        if peers is None or now - stamp > _PEER_CACHE_TTL_S:
            peers = ()
            try:
                from raydp_tpu_torch.store.block_service import service_peers

                peers = tuple(
                    p for p in service_peers(exclude_host=host_id())
                    if p.get("service_addr")
                )
            except Exception:  # no head / old head: remote tier simply unavailable
                peers = ()
            _peer_cache[0] = now
            _peer_cache[1] = peers
    return peers[0] if peers else None


def _spill_remote_target(capacity: int) -> Optional[dict]:
    """The peer to remote-spill to, or None ⇒ take the local disk tier."""
    if not _remote_spill_enabled() or capacity > _REMOTE_SPILL_MAX:
        return None
    try:
        from raydp_tpu_torch import obs

        obs.sample_memory()
        pressure = obs.metrics.gauge("mem.pressure").value
    except Exception:  # no obs plane: treat as unpressured
        return None
    if pressure < _remote_spill_pressure():
        return None
    return _remote_spill_peer()


def _put_remote(object_id: str, buf, peer: dict) -> ObjectRef:
    """Ship a block to a peer host's service and adopt the returned meta as
    this process's cached location (owner = the peer service, namespace =
    the peer host's — readers go through the normal remote-fetch path)."""
    from raydp_tpu_torch.cluster.common import host_id, host_label
    from raydp_tpu_torch.obs import metrics
    from raydp_tpu_torch.store.block_service import service_block_put

    payload = bytes(memoryview(buf))
    meta = service_block_put(peer["service_addr"], object_id, payload)
    meta = dict(meta)
    meta.setdefault("service_addr", peer["service_addr"])
    cache_location(object_id, meta)
    metrics.counter("store.blocks_spilled_remote").inc()
    metrics.counter("rpc.bytes_over_wire").inc(len(payload))
    src = host_label(host_id())
    dst = host_label(meta.get("host", "") or meta.get("shm_ns", ""))
    metrics.counter(f"rpc.bytes_over_wire.{src}.{dst}").inc(len(payload))
    return ObjectRef(object_id, len(payload))


def _lookup(ref: ObjectRef, fresh: bool = False) -> dict:
    if not fresh:
        meta = cached_location(ref.object_id)
        if meta is not None:
            from raydp_tpu_torch.obs import metrics

            metrics.counter("rpc.head_bypass_hits").inc()
            return meta
    try:
        meta = cluster_api.head_rpc("object_lookup", object_id=ref.object_id)
    except OwnerDiedError as exc:
        _note_dead_owner_from(exc)
        raise
    if meta is None:
        err = ClusterError(
            f"object {ref.object_id} not found (already deleted?)"
        )
        err.object_ids = [ref.object_id]
        raise err
    cache_location(ref.object_id, meta)
    return meta


def _lookup_batch_rpc(ids: List[str]) -> dict:
    """One head round trip for many ids — the lease-stamped op when the head
    has it (entries enter the cache with the SERVER's lease), the plain batch
    lookup otherwise, per-ref lookups against the oldest heads."""
    try:
        metas = cluster_api.head_rpc("object_lookup_lease", object_ids=ids)
    except OwnerDiedError as exc:
        _note_dead_owner_from(exc)
        raise
    except ClusterError as exc:
        if "unknown head method" not in str(exc):
            raise
        try:
            metas = cluster_api.head_rpc("object_lookup_batch", object_ids=ids)
        except ClusterError as exc2:
            if "unknown head method" not in str(exc2):
                raise
            metas = {
                oid: cluster_api.head_rpc("object_lookup", object_id=oid)
                for oid in ids
            }
    for oid, meta in metas.items():
        if meta is not None:
            cache_location(oid, meta, lease_s=meta.get("lease_s"))
    return metas


def lookup_many(refs: Sequence[ObjectRef]) -> dict:
    """Resolve many refs' metadata: {object_id: meta}. The reduce side of a
    shuffle resolves every input slice's block through this. Warm entries —
    writer-cached, lease entries pushed with the task spec, or previously
    fetched — are served from the local location cache (counted as
    ``rpc.head_bypass_hits``); only misses cost a head round trip. Raises
    (like ``_lookup``) if any object is missing or its owner died."""
    ids = list({r.object_id for r in refs})
    if not ids:
        return {}
    metas: dict = {}
    missing: List[str] = []
    for oid in ids:
        meta = cached_location(oid)
        if meta is not None:
            metas[oid] = meta
        else:
            missing.append(oid)
    if metas:
        from raydp_tpu_torch.obs import metrics

        metrics.counter("rpc.head_bypass_hits").inc(len(metas))
    if missing:
        metas.update(_lookup_batch_rpc(missing))
    absent = [oid for oid in ids if metas.get(oid) is None]
    if absent:
        err = ClusterError(
            f"object(s) {absent[:3]} not found (already deleted?)"
        )
        err.object_ids = absent
        raise err
    return metas


def local_meta(object_id: str):
    """The raw cache entry ``(meta, age_s)`` for a block THIS process knows
    about, in the wire form ReadSpec.metas carries (age, not timestamp —
    monotonic clocks don't compare across processes). None when unknown or
    the cache is disabled."""
    import time as _time

    if not _location_enabled:
        return None
    with _location_lock:
        entry = _location_cache.get(object_id)
    if entry is None:
        return None
    meta, stamp, _lease = entry
    return dict(meta), max(0.0, _time.monotonic() - stamp)


class _FetchedBuffer:
    """A block pulled over the network from its owning node (no local
    mapping exists for foreign-namespace objects)."""

    def __init__(self, data: bytes):
        self._data = data
        self.size = len(data)

    def memoryview(self) -> memoryview:
        return memoryview(self._data)


class _FileBuffer:
    """A spilled block mmap'd read-only from the local spill dir."""

    def __init__(self, path: str, size: int):
        import mmap as _mmap

        self._file = open(path, "rb")
        self.size = size
        self._mmap = (
            _mmap.mmap(self._file.fileno(), size, access=_mmap.ACCESS_READ)
            if size
            else None
        )

    def memoryview(self) -> memoryview:
        if self._mmap is None:
            return memoryview(b"")
        return memoryview(self._mmap)

    def __del__(self):
        try:
            if self._mmap is not None:
                self._mmap.close()
            self._file.close()
        except Exception:  # close teardown must never raise
            pass


# RPC robustness for the block-fetch path (the "retry ladder"): a reader hitting a RESTARTING block service (or a briefly
# unreachable agent) backs off with jitter and retries under a per-call
# deadline instead of surfacing a raw ConnectionRefusedError — and past the
# deadline it raises a lost-block-shaped error so the caller degrades to
# lineage recovery. Counted: ``rpc.retries`` / ``rpc.deadline_exceeded``.
FETCH_DEADLINE_ENV = "RAYDP_TPU_TORCH_FETCH_DEADLINE_S"
_FETCH_BACKOFF_BASE_S = 0.05
_FETCH_BACKOFF_CAP_S = 2.0


def _fetch_deadline_s() -> float:
    try:
        return float(os.environ.get(FETCH_DEADLINE_ENV, "") or 30.0)
    except ValueError:
        return 30.0


def _fetch_chunk(
    ref: ObjectRef, meta: dict, offset: int, length: int, deadline: float,
    into: Optional[memoryview] = None,
):
    """One ranged chunk pull with the jittered-backoff retry ladder.
    Prefers the block service's own socket (``service_addr`` — the
    first-class owner, over the pooled streaming transport) over
    the node's agent/head ``fetch_addr``; every few failed attempts the
    location is re-resolved through the head, so a service that restarted
    onto a fresh socket is found mid-ladder (and an owner the head reports
    dead propagates OwnerDiedError → lineage).

    With ``into`` the chunk is received directly into the caller's
    destination view (the parallel assembly path — no join copy) and the
    byte count is returned; otherwise the bytes are returned."""
    import random
    import socket as _socket
    import time as _time

    from raydp_tpu_torch.obs import metrics

    request = {"shm_name": meta["shm_name"], "offset": offset, "length": length}
    attempt = 0
    while True:
        service_addr = meta.get("service_addr")
        try:
            if service_addr:
                from raydp_tpu_torch.store.block_service import service_block_fetch

                return service_block_fetch(
                    service_addr, meta["shm_name"], offset, length, into=into
                )
            data = rpc(meta["fetch_addr"], ("block_fetch", request), timeout=300)
            if into is None:
                return data
            view = memoryview(data)
            into[: len(view)] = view
            return len(view)
        except (EOFError, OSError) as exc:
            if isinstance(exc, FileNotFoundError):
                # a remote "segment/file is gone" is NOT transient: the
                # bytes are gone while the head meta survives, and retrying
                # would stall the reader for the whole deadline against the
                # same answer — surface it now (the caller's stale-location
                # retry / lineage fallback is the right escalation)
                raise
            metrics.counter("rpc.retries").inc()
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                metrics.counter("rpc.deadline_exceeded").inc()
                err = ClusterError(
                    f"object {ref.object_id} fetch from "
                    f"{service_addr or meta.get('fetch_addr')} kept failing "
                    f"past the {_fetch_deadline_s():.0f}s deadline ({exc})"
                )
                # lost-block-shaped: the reader's lineage fallback takes over
                err.object_ids = [ref.object_id]
                raise err from exc
            delay = min(
                _FETCH_BACKOFF_CAP_S, _FETCH_BACKOFF_BASE_S * (2 ** attempt)
            )
            # jitter: a herd of readers bounced off one restarting service
            # must not retry in lockstep
            delay *= 0.5 + random.random()
            _time.sleep(min(delay, max(0.0, remaining)))
            attempt += 1
            if attempt % 3 == 0:
                # authoritative re-resolution: a restarted service binds a
                # FRESH socket; the head's live view carries it (and raises
                # OwnerDiedError / not-found when the block is really gone,
                # which must propagate — that IS the lineage trigger).
                # Updated IN PLACE: _remote_fetch shares one meta dict
                # across chunks, so later chunks of a large fetch start at
                # the re-resolved address instead of re-paying the ladder.
                fresh = _lookup(ref, fresh=True)
                meta.clear()
                meta.update(fresh)
                request["shm_name"] = meta["shm_name"]


def _fetch_parallelism() -> int:
    try:
        return max(1, int(os.environ.get("RAYDP_TPU_TORCH_FETCH_PARALLEL", "4")))
    except ValueError:
        return 4


def _count_over_wire(meta: dict, nbytes: int, fetches: int = 1) -> None:
    """The observatory's view of the cross-host data plane: every remote
    byte is counted, totalled and per host edge. Flat dotted names stand in
    for labels (metrics.py has none): ``rpc.bytes_over_wire`` is the total,
    ``rpc.bytes_over_wire.<src_host>.<dst_host>`` one directed edge —
    src is the host SERVING the bytes, dst the host reading them."""
    from raydp_tpu_torch.cluster.common import host_id, host_label
    from raydp_tpu_torch.obs import metrics

    metrics.counter("rpc.remote_fetches").inc(fetches)
    metrics.counter("rpc.bytes_over_wire").inc(nbytes)
    src = host_label(meta.get("host", "") or meta.get("shm_ns", ""))
    dst = host_label(host_id())
    metrics.counter(f"rpc.bytes_over_wire.{src}.{dst}").inc(nbytes)
    from raydp_tpu_torch.obs import flush_throttled

    flush_throttled(2.0)


def _remote_fetch(ref: ObjectRef, meta: dict, offset: int, length: int):
    """Ranged network pull of ``[offset, offset+length)`` from the owning
    node's block server (chunked: stays under the wire frame cap for
    arbitrarily large reads and bounds per-chunk copies). The server's
    ``block_fetch`` is range-native, so a reducer pulling its slice of an
    indexed shuffle block moves only that slice's bytes over the network.
    Multi-chunk reads fan out in parallel over the service connection pool,
    each chunk landing directly in its slice of one preallocated buffer —
    no join copy. Each chunk rides the retry ladder (``_fetch_chunk``): a
    restarting block service degrades to backoff-and-retry, then to
    lineage recovery at the deadline, never to a raw
    ConnectionRefusedError."""
    import time as _time

    chunk = 64 << 20
    deadline = _time.monotonic() + _fetch_deadline_s()
    nchunks = max(1, -(-length // chunk))
    workers = min(_fetch_parallelism(), nchunks)
    if nchunks == 1 or workers <= 1:
        parts = []
        pulled = 0
        # one shared copy: a mid-ladder re-resolution in _fetch_chunk
        # updates it in place, so every later chunk starts at the live
        # address
        meta = dict(meta)
        while pulled < length:
            part = _fetch_chunk(
                ref, meta, offset + pulled, min(chunk, length - pulled), deadline
            )
            if not part:
                break
            parts.append(part)
            pulled += len(part)
        data = parts[0] if len(parts) == 1 else b"".join(parts)
    else:
        from concurrent.futures import ThreadPoolExecutor

        buf = bytearray(length)
        mv = memoryview(buf)
        src = dict(meta)

        def pull(i: int) -> int:
            start = i * chunk
            ln = min(chunk, length - start)
            # per-worker meta copy: the in-place re-resolution contract
            # assumes a single ladder walking the dict; concurrent ladders
            # each re-resolve their own
            return _fetch_chunk(
                ref, dict(src), offset + start, ln, deadline,
                into=mv[start:start + ln],
            )

        with ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="rtpt-fetch"
        ) as pool:
            counts = list(pool.map(pull, range(nchunks)))
        short = sum(
            1 for i, n in enumerate(counts)
            if n < min(chunk, length - i * chunk)
        )
        data = buf if not short else bytes()
    stats["remote_fetches"] += 1
    stats["remote_bytes"] += len(data)
    from raydp_tpu_torch.obs import metrics

    metrics.counter("store.remote_fetches").inc()
    metrics.counter("store.remote_bytes").inc(len(data))
    _count_over_wire(meta, len(data))
    if len(data) < length:
        raise ClusterError(
            f"object {ref.object_id} remote fetch truncated: "
            f"{len(data)} < {length}"
        )
    return data if len(data) == length else data[:length]


def _retry_uncached(ref: ObjectRef, meta: Optional[dict], exc: BaseException):
    """A read through a CACHE-SERVED location that found the segment/file
    gone re-resolves through the head once — the head is authoritative for
    deletion and owner death, so the caller gets OwnerDiedError / a clean
    not-found instead of a stale-bypass artifact. Returns the fresh meta, or
    re-raises ``exc`` when the location didn't come from the cache.

    Fast path: when the stale entry's recorded owner is ALREADY known dead
    in this process (head OwnerDiedError seen before / intentional executor
    kill), raise OwnerDiedError immediately — lineage recovery is the only
    way forward, and the head round trip would just say the same thing. A
    block the recovery layer REBOUND carries the new (live) owner in its
    refreshed records, so rebound reads never hit this path."""
    if meta is None or not meta.get("cached"):
        raise exc
    evict_location(ref.object_id)
    if owner_known_dead(meta.get("owner")):
        from raydp_tpu_torch.obs import metrics

        metrics.counter("store.dead_owner_fastpath").inc()
        err = OwnerDiedError(
            f"object {ref.object_id}: cached location's owner "
            f"{meta.get('owner')!r} is known dead (head-bypass fast path)"
        )
        err.object_ids = [ref.object_id]
        err.owner = meta.get("owner")
        raise err from exc
    return _lookup(ref, fresh=True)


def get_buffer(ref: ObjectRef, meta: Optional[dict] = None):
    """View of the object's bytes: a zero-copy shm mapping when the object
    lives in THIS node's namespace, otherwise a network pull from the owning
    node's block server (head or node agent) — the cross-host data plane.
    Raises OwnerDiedError
    via head if the owner died untransferred. The registered size is
    authoritative — the segment may be 1 byte for empty objects or
    capacity-sized if finalize was skipped. ``meta`` (from ``lookup_many``)
    skips the per-object lookup RPC; a cache-served meta whose segment turns
    out gone retries once through the head."""
    if meta is None:
        meta = _lookup(ref)
    try:
        return _get_buffer_resolved(ref, meta)
    except (ClusterError, OSError) as exc:
        if isinstance(exc, OwnerDiedError):
            raise
        fresh = _retry_uncached(ref, meta, exc)
        return _get_buffer_resolved(ref, fresh)


def _get_buffer_resolved(ref: ObjectRef, meta: Optional[dict] = None):
    if meta is None:
        meta = _lookup(ref)
    if meta["size"] == 0:
        return _MappedBuffer(_load_native(), 0, 0)
    if meta.get("shm_ns", "") != shm_namespace():
        return _FetchedBuffer(_remote_fetch(ref, meta, 0, meta["size"]))
    if meta["shm_name"].startswith("file://"):
        # spilled block on THIS node: mmap the file (still no payload copy)
        path = meta["shm_name"][len("file://"):]
        try:
            return _FileBuffer(path, meta["size"])
        except OSError as exc:
            err = ClusterError(
                f"object {ref.object_id} metadata exists but spill file is "
                f"gone ({exc})"
            )
            err.object_ids = [ref.object_id]
            raise err
    lib = _load_native()
    seg_size = ctypes.c_uint64()
    ptr = lib.rtpu_shm_map(meta["shm_name"].encode(), ctypes.byref(seg_size), 0)
    if not ptr:
        err = ClusterError(
            f"object {ref.object_id} metadata exists but segment is gone"
        )
        err.object_ids = [ref.object_id]
        raise err
    if seg_size.value < meta["size"]:
        lib.rtpu_shm_unmap(ctypes.c_void_p(ptr), seg_size.value)
        err = ClusterError(
            f"object {ref.object_id} segment truncated: "
            f"{seg_size.value} < {meta['size']}"
        )
        err.object_ids = [ref.object_id]
        raise err
    return _MappedBuffer(lib, ptr, meta["size"], mapped_size=seg_size.value)


def get_bytes(ref: ObjectRef) -> bytes:
    return bytes(get_buffer(ref).memoryview())


def get_arrow_buffer(
    ref: ObjectRef,
    offset: int = 0,
    length: int = -1,
    meta: Optional[dict] = None,
):
    """The object's bytes — or a ``[offset, offset+length)`` RANGE of them —
    as a pyarrow Buffer. Local objects stay zero-copy: the range is a window
    over the shared mapping (shm) or the spill-file mmap; cross-node reads
    pull ONLY the requested range from the owning node's block server. The
    range path is the read side of indexed shuffle blocks: a reducer views
    just its slice of a map task's single output block. ``meta`` (from
    ``lookup_many``) skips the per-object lookup RPC."""
    import pyarrow as pa

    if meta is None:
        meta = _lookup(ref)
    size = meta["size"]
    if length is None or length < 0:
        length = size - offset
    if offset < 0 or length < 0 or offset + length > size:
        raise ClusterError(
            f"object {ref.object_id} range [{offset}, {offset + length}) "
            f"out of bounds for size {size}"
        )
    ranged = not (offset == 0 and length == size)
    if length == 0:
        return pa.py_buffer(b"")
    if ranged and meta.get("shm_ns", "") != shm_namespace():
        # ranged network pull: only the slice crosses the wire
        try:
            return pa.py_buffer(_remote_fetch(ref, meta, offset, length))
        except (ClusterError, OSError) as exc:
            if isinstance(exc, OwnerDiedError):
                raise
            fresh = _retry_uncached(ref, meta, exc)
            return pa.py_buffer(_remote_fetch(ref, fresh, offset, length))
    buf = get_buffer(ref, meta=meta)
    if ranged:
        from raydp_tpu_torch.obs import metrics

        metrics.counter("store.range_reads").inc()
    if isinstance(buf, (_FetchedBuffer, _FileBuffer)):
        # py_buffer wraps the existing memory (network bytes or spill mmap)
        # without copying; the memoryview inside keeps the backing alive
        view = buf.memoryview()
        return pa.py_buffer(view[offset : offset + length] if ranged else view)
    return pa.foreign_buffer(buf.ptr + offset, length, base=buf)


def read_arrow_batches(
    ref: ObjectRef,
    offset: int = 0,
    length: int = -1,
    meta: Optional[dict] = None,
):
    """Decode an Arrow-IPC-stream object (or an IPC-stream RANGE of one —
    an indexed shuffle block's slice) into (schema, [RecordBatch...])."""
    import pyarrow as pa

    with pa.ipc.open_stream(
        get_arrow_buffer(ref, offset, length, meta=meta)
    ) as reader:
        schema = reader.schema
        batches = list(reader)
    return schema, batches


def transfer(refs: Sequence[ObjectRef], new_owner: str) -> None:
    """Re-own objects (e.g. to a long-lived holder actor) so they survive their
    producer's death."""
    cluster_api.head_rpc(
        "object_transfer_owner",
        object_ids=[r.object_id for r in refs],
        new_owner=new_owner,
    )


def delete(refs: Sequence[ObjectRef]) -> None:
    for r in refs:
        evict_location(r.object_id)
    _note_deleted([r.object_id for r in refs])
    cluster_api.head_rpc("object_delete", object_ids=[r.object_id for r in refs])


def owner_of(ref: ObjectRef) -> Optional[str]:
    return cluster_api.head_rpc("object_owner_of", object_id=ref.object_id)


class ObjectHolder:
    """Long-lived actor pinning ObjectRefs per dataset uuid — the ownership-
    transfer target."""

    def __init__(self):
        self._objects = {}

    def add_objects(self, dataset_uuid: str, refs: List[ObjectRef]) -> int:
        self._objects[dataset_uuid] = list(refs)
        transfer(refs, current_owner())
        return len(refs)

    def get_objects(self, dataset_uuid: str) -> Optional[List[ObjectRef]]:
        return self._objects.get(dataset_uuid)

    def get_object(self, dataset_uuid: str, index: int) -> ObjectRef:
        return self._objects[dataset_uuid][index]

    def remove_objects(self, dataset_uuid: str, delete_data: bool = True) -> bool:
        refs = self._objects.pop(dataset_uuid, None)
        if refs is None:
            return False
        if delete_data:
            delete(refs)
        return True
