"""Runtime sanitizers of the port: its own copy of ``raydp_tpu/sanitize.py``
(``RAYDP_TPU_SANITIZE``).

The modes are comma-separated in ``RAYDP_TPU_SANITIZE``, all off by
default and all on for the test suite (tests/conftest.py):

- ``donation`` -- the aliasing sanitizer below: an in-place write into a
  CPU tensor whose storage is host memory the port does not own raises
  :class:`DonationAliasError` before it writes.
- ``lockdep`` -- every named lock (:func:`named_lock`) is an
  :class:`InstrumentedLock` proxy that records the per-thread held set and
  a process-global lock-acquisition-order graph, and raises
  :class:`LockOrderError` with both acquisition stacks the moment an
  acquisition closes a cycle, whether or not the run deadlocks. The
  cluster head's crash dossiers carry the graph
  (``obs.recorder.FlightRecorder.assemble``).
- ``leaks`` -- a per-process resource inventory: a baseline at start-up
  (:func:`snapshot_baseline`: threads and fds, and exact tracking of shared
  memory segments and spill files through
  :func:`track_block`/:func:`untrack_block`), audited back to it by
  ``cluster.shutdown()`` and an actor's graceful exit (:func:`audit_leaks`,
  which sets the ``sanitize.leaked_*`` gauges and logs named leaks).
  ``leaks-strict`` also raises :class:`LeakError` on a leaked segment or
  spill file.

The donation plane
------------------

The JAX package's hazard is XLA reusing a donated buffer that CPU jax
zero-copied from a host numpy array. The port donates nothing; its
counterpart is an in-place write (an optimizer's ``p.add_``, a cache's
row scatter) into a CPU tensor that shares memory the port does not own:
``torch.from_numpy`` and ``torch.as_tensor`` share a numpy array's memory,
and ``.to("cpu")`` of a CPU tensor returns that tensor. Such memory is a
caller's numpy array, an Arrow ``to_numpy`` view, or a store block's mapped
segment, and a write into it corrupts the caller's data silently.

- Staging sites register the host memory they stage from and do not own
  (:func:`note_external_host_buffer`). A span is the owning buffer's: a
  tensor's storage (``untyped_storage()``), not its view, and a numpy
  array's ultimate base. A span drops when the registering object is
  collected, since a freed span would indict whatever lands at its address
  next.
- In-place writers guard what they write before they write
  (:func:`guard_donated_args`): it raises when a CPU tensor's storage
  overlaps a registered span. A CUDA tensor never aliases host memory and
  is skipped. :func:`checked_step` is the counterpart of the JAX package's
  ``checked_jit``: an optimizer's step with its parameters and state
  guarded first.
- The guard returns after one comparison when nothing is registered, and
  reads the environment at each call, so a step built before the mode was
  set is still checked once it is.

The audit of the port's staging sites (which stage from memory the port
does not own, and whether what reaches a writer aliases it):

- ``exchange/torch_io.py`` ``SegmentUploader.upload``: its host tensors
  share the decoded segment's arrays (registered); the step gets a
  ``clone()`` on the CPU or a pinned copy uploaded to the card: owned.
- ``exchange/dataset.py`` ``Dataset.to_torch``: a batch's tensors share the
  batch's arrays (registered); they go to the caller, no writer of the
  port's touches them.
- ``estimator/estimator.py`` ``Estimator._to_device`` (``predict``): on the
  CPU the tensor shares the caller's array (registered); read only.
- ``estimator/torch_estimator.py`` ``_TorchWorkerFn.stage``: on the CPU a
  rank's features and labels share the shard's arrays (registered); the
  steps gather batches from them by index (copies) and write only the
  model's parameters and the optimizer's state: owned.
- ``parallel/partitioner.py`` ``_to_tensor``: on the CPU an input shares
  its array (registered); the staged training set is read by index only.
- ``serve/kvcache.py`` ``PagedKVCache``'s CPU arena: a tensor over a store
  segment that the cache created itself (``create_block``) and writes on
  purpose: owned, not registered.
- ``estimator/checkpoint.py`` ``load_state``: ``torch.load`` reads the file
  into tensors of its own: owned, not registered (a load that maps the
  file, ``mmap=True``, would have to register them).

No site aliases a tensor that a writer writes today: the guarded writers
are the optimizers' steps (:func:`checked_step` in ``Estimator._step`` and
``TorchEstimator``'s step; ``optim.Adafactor.step`` guards itself) and
``models/transformer.py`` ``_scatter_rows``.

Stdlib only at import, numpy and torch inside the donation functions: the
head, the zygote and ``python -S`` actors import this module.
"""

from __future__ import annotations

import os
import sys
import threading
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "DonationAliasError",
    "LockOrderError",
    "LeakError",
    "donation_check_enabled",
    "lockdep_enabled",
    "leaks_enabled",
    "leaks_strict",
    "note_external_host_buffer",
    "external_range_count",
    "donation_stats",
    "guard_donated_args",
    "step_targets",
    "checked_step",
    "named_lock",
    "InstrumentedLock",
    "reset_lockdep",
    "lock_order_edges",
    "snapshot_baseline",
    "track_block",
    "untrack_block",
    "leak_report",
    "audit_leaks",
]


class DonationAliasError(RuntimeError):
    """An in-place write targets a CPU tensor whose storage aliases
    externally-owned host memory."""


class LockOrderError(RuntimeError):
    """An acquisition closed a cycle in the lock-order graph (potential
    deadlock), or a non-reentrant lock was re-acquired by its holder."""


class LeakError(RuntimeError):
    """Shutdown audit found tracked resources that outlived the cluster
    (``leaks-strict`` mode only)."""


def _modes() -> set:
    return {
        m.strip()
        for m in os.environ.get("RAYDP_TPU_SANITIZE", "").split(",")
        if m.strip()
    }


def donation_check_enabled() -> bool:
    """Read the env each call (tests toggle it): one getenv and a substring
    test, as the JAX package's check."""
    return "donation" in os.environ.get("RAYDP_TPU_SANITIZE", "")


def lockdep_enabled() -> bool:
    return "lockdep" in _modes()


def leaks_enabled() -> bool:
    modes = _modes()
    return "leaks" in modes or "leaks-strict" in modes


def leaks_strict() -> bool:
    return "leaks-strict" in _modes()


# ---------------------------------------------------------------------------
# donation: in-place writes into host memory the port does not own
# ---------------------------------------------------------------------------

# id(registering object) -> (start, end, tag); the weakref finalizer of that
# object drops its entry
_external: Dict[int, Tuple[int, int, str]] = {}
_finalizers: Dict[int, Any] = {}
_guard_checks = 0  # guarded writes held against registered spans
_registered = 0  # spans registered in this process, ever


def _ultimate_base(arr) -> Any:
    """Walk the numpy view chain to the owning object: registering the base
    covers every view sliced out of it."""
    seen = 0
    base = arr
    while getattr(base, "base", None) is not None and seen < 64:
        base = base.base
        seen += 1
    return base


def _array_span(arr) -> Optional[Tuple[int, int]]:
    iface = getattr(arr, "__array_interface__", None)
    if not iface:
        return None
    start = iface.get("data", (None,))[0]
    nbytes = getattr(arr, "nbytes", 0)
    if start is None or not nbytes:
        return None
    return (start, start + nbytes)


def _numpy_span(arr) -> Optional[Tuple[int, int]]:
    """The ultimate base's bytes when it is an ndarray, else the view's own
    (an Arrow view's owner is a buffer, not an array)."""
    import numpy as np

    base = _ultimate_base(arr)
    return _array_span(base if isinstance(base, np.ndarray) else arr)


def _tensor_span(t) -> Optional[Tuple[int, int]]:
    """A CPU tensor's storage bytes (not its view's); None off the CPU."""
    if t.device.type != "cpu":
        return None
    storage = t.untyped_storage()
    start, nbytes = storage.data_ptr(), storage.nbytes()
    if not start or not nbytes:
        return None
    return (start, start + nbytes)


def _kind(obj) -> Optional[str]:
    """"tensor", "ndarray" or None. Through sys.modules: a process that
    never loaded torch (or numpy) holds none of its objects, and must not
    import it here."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(obj, torch.Tensor):
        return "tensor"
    np = sys.modules.get("numpy")
    if np is not None and isinstance(obj, np.ndarray):
        return "ndarray"
    return None


def _span(obj) -> Optional[Tuple[int, int]]:
    kind = _kind(obj)
    if kind == "tensor":
        return _tensor_span(obj)
    if kind == "ndarray":
        return _numpy_span(obj)
    return None


def note_external_host_buffer(arr, tag: str = "external") -> None:
    """Register ``arr`` (a numpy array or view, or a CPU tensor) as host
    memory the port does not own. No-op unless the donation sanitizer is
    enabled. The span's lifetime is ``arr``'s: it drops when ``arr`` is
    collected."""
    if not donation_check_enabled():
        return
    if _kind(arr) is None:
        arr = getattr(arr, "__array__", lambda: None)()
    span = _span(arr)
    if span is None:
        return
    key = id(arr)
    if key in _external:
        return
    global _registered
    _registered += 1
    _external[key] = (span[0], span[1], tag)
    _finalizers[key] = weakref.finalize(arr, _drop_external, key)


def _drop_external(key: int) -> None:
    _external.pop(key, None)
    _finalizers.pop(key, None)


def external_range_count() -> int:
    return len(_external)


def donation_stats() -> Dict[str, int]:
    """This process's donation plane: ``registered`` spans ever, ``live``
    spans now, and ``checks``, the guarded writes held against registered
    spans (a guard that returned early, with nothing registered or the
    mode off, is not counted)."""
    return {"registered": _registered, "live": len(_external),
            "checks": _guard_checks}


def _overlapping_tag(start: int, end: int) -> Optional[str]:
    # a snapshot: finalizers (_drop_external) fire at any bytecode boundary
    for s, e, tag in list(_external.values()):
        if start < e and s < end:
            return tag
    return None


def guard_donated_args(targets: Iterable, label: str = "write") -> None:
    """Raise :class:`DonationAliasError` if a tensor (or numpy array) that
    ``label`` is about to write in place overlaps a registered
    externally-owned host span. CUDA tensors are skipped: they never alias
    host memory."""
    if not _external:
        return
    if not donation_check_enabled():
        return
    global _guard_checks
    _guard_checks += 1
    for target in targets:
        span = _span(target)
        if span is None:
            continue
        tag = _overlapping_tag(*span)
        if tag is not None:
            raise DonationAliasError(
                f"in-place write of {label} (shape="
                f"{tuple(getattr(target, 'shape', ()))} dtype="
                f"{getattr(target, 'dtype', '?')}) targets externally-owned "
                f"host memory ({tag}, span 0x{span[0]:x}-0x{span[1]:x}): "
                "torch.from_numpy and torch.as_tensor share a numpy array's "
                "memory and .to('cpu') of a CPU tensor returns it, so the "
                "write would scribble over memory the port does not own. "
                "Stage through an owned copy first: torch.from_numpy(x)"
                ".clone() or torch.tensor(x).")


def step_targets(optimizer):
    """The tensors an optimizer's step writes in place: its parameters and
    its state's tensors (each label's optimizer of a ``MultiTransform``)."""
    inner = getattr(optimizer, "optimizers", None)
    if isinstance(inner, dict):
        for opt in inner.values():
            yield from step_targets(opt)
        return
    for group in getattr(optimizer, "param_groups", ()):
        yield from group["params"]
    for state in getattr(optimizer, "state", {}).values():
        for value in state.values():
            if hasattr(value, "untyped_storage"):
                yield value


def checked_step(optimizer, label: Optional[str] = None) -> None:
    """``optimizer.step()`` with its parameters and state guarded first:
    the port's ``checked_jit``. One comparison when nothing is
    registered."""
    if _external and donation_check_enabled():
        guard_donated_args(step_targets(optimizer),
                           label or f"{type(optimizer).__name__}.step")
    optimizer.step()


# ---------------------------------------------------------------------------
# lockdep: runtime lock-order sanitizer (RAYDP_TPU_SANITIZE=lockdep)
# ---------------------------------------------------------------------------
#
# Classic lockdep (Linux): lock ORDER, not lock OWNERSHIP, is the invariant.
# Locks are keyed by NAME (a lock class -- every instance of one class shares
# one node, like lockdep's per-class keys), so one run that acquires A→B and
# a later run that acquires B→A is caught even though no two threads ever
# actually interleaved into the deadlock. Reentrancy and self-deadlock are
# judged by lock IDENTITY (two instances of one class are distinct locks).

_RLOCK_TYPE = type(threading.RLock())

_graph_lock = threading.Lock()  # plain, never instrumented: guards the graph
_lock_edges: Dict[Tuple[str, str], Dict[str, str]] = {}  # guarded-by: _graph_lock
_lock_adj: Dict[str, set] = {}  # guarded-by: _graph_lock
_tls_lockdep = threading.local()


def _held_stack() -> List[list]:
    """This thread's held locks: [name, lock_id, count] entries, in
    acquisition order."""
    stack = getattr(_tls_lockdep, "stack", None)
    if stack is None:
        stack = _tls_lockdep.stack = []
    return stack


def _format_site(skip_innermost: int = 2, limit: int = 8) -> str:
    import traceback

    frames = traceback.format_stack()[:-skip_innermost]
    return "".join(frames[-limit:])


def _find_path(src: str, dst: str) -> Optional[List[str]]:  # guarded-by: _graph_lock held
    """Shortest src ⇝ dst path in the order graph (caller holds _graph_lock)."""
    if src == dst:
        return [src]
    prev: Dict[str, str] = {}
    queue = [src]
    while queue:
        node = queue.pop(0)
        for nxt in _lock_adj.get(node, ()):
            if nxt in prev or nxt == src:
                continue
            prev[nxt] = node
            if nxt == dst:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return list(reversed(path))
            queue.append(nxt)
    return None


def _before_acquire(
    name: str, lock: Any, reentrant: bool, blocking: bool = True
) -> None:
    """Order check + edge recording, BEFORE delegating to the real acquire:
    if this acquisition would deadlock, the caller gets a stack instead of a
    hang, and the edge is in the graph for other threads even if we block."""
    if getattr(_tls_lockdep, "busy", False):
        return  # re-entered from lockdep's own error path
    held = _held_stack()
    for ent in held:
        if ent[1] == id(lock):
            if not reentrant and blocking:
                raise LockOrderError(
                    f"self-deadlock: thread {threading.current_thread().name!r} "
                    f"re-acquiring non-reentrant lock '{name}' it already "
                    f"holds\n  at:\n{_format_site()}"
                )
            # RLock reentry — or a NON-blocking probe of a plain lock by its
            # own holder, which legally returns False (threading.Condition's
            # _is_owned fallback probes exactly this way on a plain Lock):
            # either way, no new ordering information
            return
    if not held:
        return  # first lock of the chain: nothing to order against
    _tls_lockdep.busy = True
    try:
        error: Optional[str] = None
        with _graph_lock:
            for ent in held:
                holder = ent[0]
                if holder == name or (holder, name) in _lock_edges:
                    continue  # same lock class or edge already known
                back_path = _find_path(name, holder)
                if back_path is not None:
                    cycle = " -> ".join(back_path + [name])
                    first = _lock_edges.get((back_path[0], back_path[1])) if len(back_path) > 1 else None
                    prior = (
                        f"  reverse edge {back_path[0]} -> {back_path[1]} first "
                        f"recorded on thread {first['thread']!r} at:\n{first['stack']}"
                        if first
                        else ""
                    )
                    error = (
                        f"lock-order inversion: thread "
                        f"{threading.current_thread().name!r} acquiring "
                        f"'{name}' while holding '{holder}' closes the cycle "
                        f"{cycle}\n  this acquisition at:\n{_format_site(3)}"
                        f"{prior}"
                    )
                    break
                _lock_edges[(holder, name)] = {
                    "stack": _format_site(3),
                    "thread": threading.current_thread().name,
                }
                _lock_adj.setdefault(holder, set()).add(name)
        if error is not None:
            # metrics OUTSIDE _graph_lock: the registry's own lock is
            # instrumented, and counter creation re-enters this machinery
            try:
                from raydp_tpu_torch.obs import metrics as _metrics

                _metrics.counter("sanitize.lock_order_violations").inc()
            except Exception:  # (obs unavailable must not mask the LockOrderError)
                pass
            raise LockOrderError(error)
    finally:
        _tls_lockdep.busy = False


def _after_acquire(name: str, lock: Any) -> None:
    held = _held_stack()
    for ent in held:
        if ent[1] == id(lock):
            ent[2] += 1
            return
    held.append([name, id(lock), 1])


def _on_release(lock: Any) -> None:
    """Unconditional (runs even with lockdep off, so toggling the env while
    a lock is held can never strand a stale held-entry)."""
    stack = getattr(_tls_lockdep, "stack", None)
    if not stack:
        return
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][1] == id(lock):
            stack[i][2] -= 1
            if stack[i][2] == 0:
                del stack[i]
            return


class InstrumentedLock:
    """Lock proxy carrying a lockdep name. With ``lockdep`` off this is pure
    delegation (one env dict lookup per acquire); with it on, every acquire
    runs the order check above. ``threading.Condition(proxy)`` works: the
    Condition binds the PROXY's acquire/release (``with cond:`` is tracked)
    while its wait-path ``_release_save``/``_acquire_restore``/``_is_owned``
    resolve through ``__getattr__`` to the raw lock — a Condition over a
    named lock is the SAME lockdep node, which is exactly right (they are
    the same mutex; the head's ``actor_state_cond`` wraps ``head.lock``).
    Over a plain ``Lock`` (no ``_is_owned``), Condition's ownership
    fallback probes ``acquire(False)`` from the holding thread — legal, and
    distinguished from a real self-deadlock by ``blocking``."""

    def __init__(self, name: str, lock: Any):
        self._name = name
        self._lock = lock
        self._reentrant = isinstance(lock, _RLOCK_TYPE)

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if lockdep_enabled():
            _before_acquire(self._name, self._lock, self._reentrant, blocking)
        if timeout == -1:
            # let each lock type apply its OWN no-timeout default:
            # Lock/RLock spell it -1 but Semaphore spells it None, and
            # forwarding -1 to a Semaphore turns a blocking acquire into an
            # instantly-expired try-acquire
            ok = self._lock.acquire(blocking)
        else:
            ok = self._lock.acquire(blocking, timeout)
        if ok and lockdep_enabled():
            _after_acquire(self._name, self._lock)
        return ok

    def release(self) -> None:
        _on_release(self._lock)
        self._lock.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, attr: str):
        return getattr(self._lock, attr)

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self._name} over {self._lock!r}>"


def named_lock(name: str, lock: Any = None) -> InstrumentedLock:
    """Wrap ``lock`` (default: a fresh ``threading.Lock``) in the lockdep
    proxy under ``name``. Name by lock CLASS, not instance
    (``"planner.reduce_launcher"``, not one name per launcher): ordering
    discipline is a property of the code, and per-class keys let one
    instance's history convict another instance's inversion."""
    if lock is None:
        lock = threading.Lock()
    return InstrumentedLock(name, lock)


def reset_lockdep() -> None:
    """Drop the recorded order graph and THIS thread's held-set (tests, and
    zygote-forked children whose parent recorded edges that are meaningless
    in the child)."""
    with _graph_lock:
        _lock_edges.clear()
        _lock_adj.clear()
    _tls_lockdep.stack = []


def lock_order_edges() -> List[Tuple[str, str]]:
    """The recorded acquisition-order edges (introspection/tests)."""
    with _graph_lock:
        return sorted(_lock_edges)


# ---------------------------------------------------------------------------
# leaks: shutdown resource audit (RAYDP_TPU_SANITIZE=leaks[,leaks-strict])
# ---------------------------------------------------------------------------
#
# Two precision tiers. Shm segments and spill files are tracked EXACTLY
# (create/unlink hooks in the store + cluster.common), so a leaked segment is
# named, attributable, and — in leaks-strict mode — fatal. Threads and fds
# are counted as deltas against the startup baseline and reported as gauges
# only: library internals (torch, numpy) open fds and park daemon threads at
# unpredictable times, and indicting them by count would make the audit cry
# wolf. The audit double-checks tracked entries against the filesystem:
# another process may legitimately have unlinked a segment this process
# created (the head unlinks driver blocks at shutdown).

_leak_lock = threading.Lock()  # plain: leaf lock inside sanitize internals
_baseline: Optional[Dict[str, int]] = None  # guarded-by: _leak_lock
_tracked_blocks: Dict[str, Tuple[str, str]] = {}  # guarded-by: _leak_lock


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1  # non-procfs platform: fd audit degrades to "unknown"


def snapshot_baseline() -> None:
    """Record this process's resource floor. Called at cluster init /
    attach and at worker main — each call re-baselines, so a driver that
    runs several init/shutdown cycles audits each cycle against its own
    start, not the first one's."""
    if not leaks_enabled():
        return
    global _baseline
    with _leak_lock:
        _baseline = {
            "fds": _fd_count(),
            "threads": len(threading.enumerate()),
        }


def track_block(shm_name: str, path: str, kind: str = "shm") -> None:
    """A native-store segment (``kind="shm"``) or spill file
    (``kind="spill"``) was created by THIS process; audited at shutdown."""
    if not leaks_enabled():
        return
    with _leak_lock:
        _tracked_blocks[shm_name] = (kind, path)


def untrack_block(shm_name: str) -> None:
    # racy emptiness probe ON PURPOSE: with leaks off the dict is always
    # empty and every unlink skips the lock; a stale read just takes the lock
  
    if not _tracked_blocks:
        return
    with _leak_lock:
        _tracked_blocks.pop(shm_name, None)


def leak_report() -> Dict[str, Any]:
    """Current inventory vs the baseline. ``shm``/``spill`` list tracked
    blocks whose backing file still exists (stale entries for blocks some
    other process unlinked are dropped, not reported); ``fds``/``threads``
    are deltas (0 when no baseline or unknowable); ``pending_spans`` is the
    obs ring-buffer depth (spans recorded but never shipped)."""
    with _leak_lock:
        items = list(_tracked_blocks.items())
        baseline = dict(_baseline) if _baseline else None
    leaked: Dict[str, List[str]] = {"shm": [], "spill": []}
    stale: List[str] = []
    for name, (kind, path) in items:
        if os.path.exists(path):
            leaked.setdefault(kind, []).append(name)
        else:
            stale.append(name)
    if stale:
        with _leak_lock:
            for name in stale:
                _tracked_blocks.pop(name, None)
    fds = threads = 0
    if baseline is not None:
        now_fds = _fd_count()
        if now_fds >= 0 and baseline["fds"] >= 0:
            fds = max(0, now_fds - baseline["fds"])
        threads = max(0, len(threading.enumerate()) - baseline["threads"])
    pending_spans = 0
    try:
        from raydp_tpu_torch.obs import tracing as _tracing

        pending_spans = len(_tracing._buffer)
    except Exception:  # (obs optional in minimal processes)
        pass
    return {
        "shm": sorted(leaked["shm"]),
        "spill": sorted(leaked["spill"]),
        "fds": fds,
        "threads": threads,
        "pending_spans": pending_spans,
    }


def audit_leaks(label: str = "shutdown") -> Dict[str, Any]:
    """The teardown audit: export ``sanitize.leaked_*`` gauges, log any
    named leak, raise :class:`LeakError` in ``leaks-strict`` mode. Wired
    into ``cluster.shutdown()`` and the worker's graceful exit; safe to call
    repeatedly (gauges, not counters — a re-audit overwrites, it does not
    double-count)."""
    if not leaks_enabled():
        return {}
    report = leak_report()
    try:
        from raydp_tpu_torch.obs import metrics as _metrics

        _metrics.gauge("sanitize.leaked_shm_segments").set(len(report["shm"]))
        _metrics.gauge("sanitize.leaked_spill_files").set(len(report["spill"]))
        _metrics.gauge("sanitize.leaked_fds").set(report["fds"])
        _metrics.gauge("sanitize.leaked_threads").set(report["threads"])
        _metrics.gauge("sanitize.pending_spans").set(report["pending_spans"])
    except Exception:  # (obs unavailable must not break shutdown)
        pass
    if report["shm"] or report["spill"]:
        try:
            from raydp_tpu_torch.obs import log as _obs_log

            _obs_log.warning(
                "resource leak at teardown",
                label=label,
                shm=report["shm"][:20],
                spill=report["spill"][:20],
            )
        except Exception:  # (obs unavailable must not break shutdown)
            pass
        if leaks_strict():
            raise LeakError(
                f"{label}: {len(report['shm'])} shm segment(s) and "
                f"{len(report['spill'])} spill file(s) outlived teardown: "
                f"{(report['shm'] + report['spill'])[:20]}"
            )
    return report
