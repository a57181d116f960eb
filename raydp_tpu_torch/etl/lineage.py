"""Block lineage: the planner's recovery backbone.

The reference RayDP survives executor loss with ``from_spark_recoverable``
plus Ray's lineage-based object reconstruction.
This module is the Arrow-native analog: every block the
planner registers gets a COMPACT lineage entry — a (deferred) producing
``TaskSpec`` maker plus the produced block ids/sizes — and any read that
surfaces a lost-block error (``OwnerDiedError``, block/segment not found)
re-executes just the producing tasks on surviving executors, transitively
up to a bounded depth and under a per-query re-execution budget, so a
flapping node fails fast instead of looping.

The key trick is the REBIND: a re-executed task writes fresh blocks under
fresh object ids, but every in-flight consumer (reduce-side slice reads,
pushed ReadSpecs, Datasets, estimator feeds) holds the ORIGINAL refs. The
head's ``object_rebind`` op re-registers the regenerated block's metadata
under the original object id, so recovery is invisible to readers: they
re-resolve the same ref and find live bytes. This is sound because task
re-execution is byte-deterministic (seeded Samples/splits, order-preserving
shuffle reads — the engine's determinism contract); the rebind VALIDATES
the regenerated sizes against the originals and refuses to rebind a
divergent result rather than serve silently different bytes.

Driver-process-local by design (entries hold live TaskSpec objects and
closures; nothing here is pickled). The registry is LRU-bounded. Entries
survive block deletion on purpose: recovering a live output may require
transitively re-materializing an already-cleaned-up shuffle intermediate
(Ray's lineage reconstruction makes the same call). Recovery only ever
runs against a LIVE session — the ownership contract that non-transferred
blocks die with the session (test_ownership_dies_with_session) is gated at
the read sites, not here.
"""

from __future__ import annotations

import collections
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from raydp_tpu_torch.cluster.common import ClusterError, OwnerDiedError


class RecoveryError(ClusterError):
    """Lineage recovery could not restore the lost blocks (no lineage
    entry, recovery budget/depth exhausted, or the re-executed task produced
    a divergent result). Carries the original read error as ``__cause__``."""


# object ids are uuid4().hex[:16], optionally carrying a tenant-namespace
# prefix "<tenant>." (store.new_object_id) — the
# string-fallback extraction must keep the prefix or recovery would probe
# ids that don't exist
_OBJECT_ID_RE = re.compile(r"\b(?:[A-Za-z0-9_-]+\.)?[0-9a-f]{16}\b")

# substrings of the store/head error messages that mean "the block's bytes
# are gone" (as opposed to an application error inside a task body)
_LOST_MARKERS = (
    "not found",
    "owner died",
    "owner is dead",
    "segment is gone",
    "spill file is gone",
    "segment truncated",
)


def is_lost_block_error(exc: BaseException) -> bool:
    """True when ``exc`` means a block's BYTES are unavailable — the errors
    lineage recovery exists for. Anything else (application errors, protocol
    errors) must propagate untouched."""
    if isinstance(exc, OwnerDiedError):
        return True
    if getattr(exc, "object_ids", None):
        return True
    if isinstance(exc, ClusterError):
        msg = str(exc)
        return any(marker in msg for marker in _LOST_MARKERS)
    return False


def missing_ids(exc: BaseException) -> List[str]:
    """The lost block ids named by a lost-block error: the structured
    ``object_ids`` attribute when the raise site attached one (store and
    head raise sites do), else every object-id-shaped token in the message
    (errors that crossed an RPC boundary from an older peer)."""
    ids = getattr(exc, "object_ids", None)
    if ids:
        return list(ids)
    return _OBJECT_ID_RE.findall(str(exc))


class _Entry:
    """Lineage of ONE producing task: how to rebuild its spec, and the
    block ids/sizes it originally produced (position-ordered — re-execution
    reproduces the same positions)."""

    __slots__ = ("make_spec", "block_ids", "sizes")

    def __init__(
        self,
        make_spec: Callable[[], Any],
        block_ids: Tuple[Optional[str], ...],
        sizes: Tuple[int, ...],
    ):
        self.make_spec = make_spec
        self.block_ids = block_ids
        self.sizes = sizes


class LineageRegistry:
    """Driver-side object-id → lineage-entry map, LRU-bounded. Cheap on the
    happy path: recording is one dict insert per produced block (the spec is
    stored by reference or as a zero-cost closure — nothing is copied or
    serialized until recovery actually runs)."""

    CAP = 8192

    def __init__(self):
        from raydp_tpu_torch.sanitize import named_lock

        self._lock = named_lock("planner.lineage")
        self._entries: "collections.OrderedDict[str, _Entry]" = (
            collections.OrderedDict()
        )  # guarded-by: self._lock

    def record_spec(self, spec, result) -> None:
        """Record a dispatched spec's produced blocks (the staged paths,
        where the TaskSpec object is at hand — stored by reference)."""
        self.record_maker(lambda spec=spec: spec, result)

    def record_maker(self, make_spec: Callable[[], Any], result) -> None:
        """Record with a DEFERRED spec maker (the compiled/fused paths,
        where building the concrete TaskSpec driver-side would cost a bind
        per query — the closure defers that to recovery time)."""
        blocks = getattr(result, "blocks", None)
        if not blocks or not any(b is not None for b in blocks):
            return
        entry = _Entry(
            make_spec,
            tuple(b.object_id if b is not None else None for b in blocks),
            tuple(b.size if b is not None else 0 for b in blocks),
        )
        with self._lock:
            for b in blocks:
                if b is None:
                    continue
                self._entries[b.object_id] = entry
                self._entries.move_to_end(b.object_id)
            while len(self._entries) > self.CAP:
                self._entries.popitem(last=False)

    def entry(self, object_id: str) -> Optional[_Entry]:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None:
                self._entries.move_to_end(object_id)
            return entry

    def forget(self, object_ids: Sequence[str]) -> None:
        """Drop entries (used for the interim new-id entries after a
        rebind). Deliberate-deletion protection does NOT rely on this:
        ``recover_blocks`` refuses depth-0 recovery of ids the head reports
        cleanly absent (deleted, no owner-death tombstone) — entries must
        SURVIVE deletion so cleaned-up shuffle intermediates stay
        transitively re-materializable."""
        with self._lock:
            for oid in object_ids:
                self._entries.pop(oid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# recovery driver
# ---------------------------------------------------------------------------


def _probe_fresh(object_ids: Sequence[str]) -> Dict[str, Optional[dict]]:
    """Authoritative per-id head lookups for the lost set (cold path only).
    An id another recovery pass already rebound resolves fresh here —
    concurrent failures of sibling readers must not re-execute the same
    task N times. Per-id (not batched) on purpose: batches raise as a
    whole, which would hide rebound siblings."""
    from raydp_tpu_torch.cluster import api as cluster_api
    from raydp_tpu_torch.store import object_store as store

    out: Dict[str, Optional[dict]] = {}
    for oid in object_ids:
        try:
            meta = cluster_api.head_rpc("object_lookup", object_id=oid)
        except ClusterError:
            meta = None
        out[oid] = meta
        if meta is not None:
            store.cache_location(oid, meta)
    return out


def refresh_reads(reads, object_ids: Sequence[str]) -> None:
    """Re-push THIS process's (post-rebind) location records for the given
    ids into ReadSpecs, overwriting stale pre-recovery pushes — the
    executor seeds its cache from ``read.metas`` BEFORE resolving, so a
    retried task must carry the rebound locations, not the dead owner's."""
    from raydp_tpu_torch.store import object_store as store

    wanted = set(object_ids)
    for read in reads:
        for ref in list(read.blocks) + [r for r, _, _ in read.slices]:
            if ref is not None and ref.object_id in wanted:
                entry = store.local_meta(ref.object_id)
                if entry is not None:
                    read.metas[ref.object_id] = entry


def spec_input_ids(spec) -> List[str]:
    """Every input block id a TaskSpec reads (whole blocks, indexed slices,
    and a join merge's right side) — the transitive-recovery frontier."""
    reads = list(getattr(spec, "reads", None) or [])
    merge = getattr(spec, "merge", None)
    if merge is not None and getattr(merge, "right", None) is not None:
        reads.append(merge.right)
    out: List[str] = []
    for read in reads:
        for ref in list(read.blocks) + [r for r, _, _ in read.slices]:
            if ref is not None:
                out.append(ref.object_id)
    return list(dict.fromkeys(out))


def refresh_spec_metas(spec, object_ids: Sequence[str]) -> None:
    """``refresh_reads`` over every ReadSpec a TaskSpec carries (primary
    reads + a join merge's right side)."""
    reads = list(getattr(spec, "reads", None) or [])
    merge = getattr(spec, "merge", None)
    if merge is not None and getattr(merge, "right", None) is not None:
        reads.append(merge.right)
    refresh_reads(reads, object_ids)


def recover_blocks(planner, object_ids: Sequence[str], depth: int = 0) -> int:
    """Re-execute the producing tasks of the given lost block ids on the
    planner's surviving executors and rebind the regenerated blocks under
    the ORIGINAL ids. Returns the number of blocks restored (0 when every
    id already resolved fresh — a sibling reader recovered them first).
    Raises :class:`RecoveryError` when any id has no lineage entry, the
    per-query budget / transitive depth is exhausted, or a re-executed task
    produced a divergent (different-sized) result."""
    from raydp_tpu_torch import obs
    from raydp_tpu_torch.cluster import api as cluster_api
    from raydp_tpu_torch.store import object_store as store

    ids = list(dict.fromkeys(object_ids))
    if not ids:
        return 0
    if depth > planner.recovery_max_depth:
        raise RecoveryError(
            f"lineage recovery exceeded max depth {planner.recovery_max_depth} "
            f"re-materializing inputs for {ids[:3]} (flapping cluster?)"
        )
    # a sibling reader (another reducer hitting the same dead map output)
    # may have already recovered these ids: the authoritative probe filters
    # them out before any re-execution is charged against the budget
    fresh = _probe_fresh(ids)
    lost = [oid for oid in ids if fresh.get(oid) is None]
    if not lost:
        return 0
    if depth == 0:
        # deletion is not loss: an id THIS process deliberately deleted
        # (store.delete records it locally — keyed here, not by head
        # tombstone absence, so a mass owner-death that overflows the
        # head's tombstone table can never be misread as deletion) must
        # not be resurrected — that would silently undo the deletion AND
        # leak the re-registered segment. Only depth-0 is policed:
        # transitive inputs (depth > 0) legitimately include cleaned-up
        # shuffle intermediates.
        from raydp_tpu_torch.store import object_store as _store

        deleted = [oid for oid in lost if _store.was_deleted_here(oid)]
        if deleted:
            raise RecoveryError(
                f"block(s) {deleted[:3]} were deliberately deleted — "
                "lineage recovers LOST blocks, not deleted ones"
            )

    registry: LineageRegistry = planner.lineage
    groups: Dict[int, Tuple[_Entry, List[str]]] = {}
    for oid in lost:
        entry = registry.entry(oid)
        if entry is None:
            raise RecoveryError(
                f"no lineage recorded for lost block(s) {lost[:3]} — cannot "
                "re-execute the producing task (block predates this planner, "
                "was deliberately deleted, or lineage recovery is disabled)"
            )
        key = id(entry)
        if key in groups:
            groups[key][1].append(oid)
        else:
            groups[key] = (entry, [oid])

    planner._charge_recovery(len(groups))
    recovered = 0
    for entry, _wanted in groups.values():
        spec = entry.make_spec()
        # transitive inputs FIRST, as one batch: probe every input ref the
        # spec reads and re-materialize the missing set together one level
        # deeper (a cleaned-up shuffle's reduce task reads M map blocks —
        # discovering them one failed dispatch at a time would burn one
        # retry attempt per block and time out the depth budget)
        inputs = spec_input_ids(spec)
        if inputs:
            probed = _probe_fresh(inputs)
            missing = [oid for oid in inputs if probed.get(oid) is None]
            if missing:
                recover_blocks(planner, missing, depth + 1)
        result = None
        for attempt in range(planner.recovery_max_depth + 1):
            refresh_spec_metas(spec, inputs)
            try:
                result = planner._submit_recovery(spec)
                break
            except ClusterError as exc:
                # backstop for inputs the probe missed (raced deletion):
                # recover them one level deeper, then retry this task
                if not is_lost_block_error(exc) or attempt >= planner.recovery_max_depth:
                    raise RecoveryError(
                        f"re-execution of the producing task for "
                        f"{_wanted[:3]} failed: {exc}"
                    ) from exc
                recover_blocks(planner, missing_ids(exc), depth + 1)
        new_blocks = result.blocks
        if len(new_blocks) != len(entry.block_ids) or any(
            (old is None) != (new is None)
            or (new is not None and new.size != size)
            for old, new, size in zip(entry.block_ids, new_blocks, entry.sizes)
        ):
            # determinism violated (nondeterministic UDF?): serving
            # differently-shaped bytes under the old refs would corrupt
            # range reads silently — refuse instead
            planner._delete_blocks([b for b in new_blocks if b is not None])
            raise RecoveryError(
                f"re-executed task produced a divergent result for "
                f"{_wanted[:3]} (block count/size mismatch); refusing to "
                "rebind — is the producing task deterministic?"
            )
        mapping = {
            old: new.object_id
            for old, new in zip(entry.block_ids, new_blocks)
            if old is not None and new is not None
        }
        rebound = cluster_api.head_rpc("object_rebind", mapping=mapping)
        if rebound != len(mapping):
            raise RecoveryError(
                f"head rebound {rebound}/{len(mapping)} regenerated blocks "
                f"for {_wanted[:3]} (racing deletion?)"
            )
        # local cache: the OLD ids now live at the NEW blocks' locations;
        # the recovery task's result carries the writer's location records
        metas = result.block_metas or []
        for j, (old, new) in enumerate(zip(entry.block_ids, new_blocks)):
            if old is None or new is None:
                continue
            store.evict_location(old)
            wire = metas[j] if j < len(metas) else None
            if wire is not None:
                meta, age = wire
                meta = dict(meta)
                meta["object_id"] = old
                import time as _time

                store.cache_location(
                    old, meta, stamp=_time.monotonic() - max(0.0, float(age))
                )
        # the interim entries recorded for the new ids point at the same
        # spec; the new ids no longer exist at the head — drop them
        registry.forget(list(mapping.values()))
        recovered += len(mapping)
        obs.metrics.counter("lineage.reexecuted_tasks").inc()
        obs.metrics.counter("lineage.recovered_blocks").inc(len(mapping))
        tenant = getattr(planner, "tenant", "") or ""
        if tenant:
            # tenant-scoped attribution: concurrent
            # queries from DIFFERENT tenants share one driver process, so
            # per-query recovery stats delta these instead of the global
            # counters — tenant A's recovery must never show up in tenant
            # B's last_query_stats
            obs.metrics.counter(
                f"tenant.{tenant}.lineage_reexecuted_tasks"
            ).inc()
            obs.metrics.counter(
                f"tenant.{tenant}.lineage_recovered_blocks"
            ).inc(len(mapping))
        obs.instant(
            "lineage.recovered",
            blocks=len(mapping),
            depth=depth,
            task_partition=getattr(spec, "partition_index", -1),
        )
    return recovered
