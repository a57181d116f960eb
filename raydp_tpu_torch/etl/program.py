"""Compiled query programs: the millisecond control plane's plan IR.

A ``CompiledProgram`` is a logical plan lowered ONCE into the exact physical
pieces the executors run — prepared (stripped + fused) narrow chains, shuffle
output routing, reduce prototypes — with the per-query *parameters* (input
block refs, expression literals) factored out into slots. Repeated query
shapes then skip planning/lowering entirely: the planner fingerprints the
plan (op tree + schemas + the session confs that affect lowering), hits its
plan cache, rebinds the slots, and ships the program in a single ``run_plan``
dispatch per executor. Executors cache programs by fingerprint, so a warm
dispatch carries only the binding (block refs + literal values), not the
plan.

The fingerprint walk and the literal-slot walk are the same traversal: the
slot order is defined by one function (``chain_literals``), so compile-time
templates and bind-time values can never disagree about which literal is
which. Fusion (``merge_projects``/``substitute``) preserves ``Literal``
object identity, which is what lets the compiled (fused) chain's literals be
mapped back to source-plan slot indices.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from raydp_tpu_torch.cluster.common import ProgramCacheMiss  # noqa: F401 (canonical home: crosses the executor RPC boundary, so it lives with the cluster errors; re-exported here for compatibility)
from raydp_tpu_torch.etl import plan as lp
from raydp_tpu_torch.etl import tasks as T
from raydp_tpu_torch.etl.expressions import (
    Alias,
    BinaryOp,
    Cast,
    ColumnRef,
    Function,
    IsIn,
    Literal,
    SharedExpr,
    UnaryOp,
    Udf,
    When,
)


# ---------------------------------------------------------------------------
# plan fingerprinting
# ---------------------------------------------------------------------------


@dataclass
class PlanKey:
    """Cache key + per-query parameters of one fingerprint walk."""

    fingerprint: str
    literals: List[Literal]  # literal OBJECTS in walk order (slot values)
    block_slots: List[List[Any]]  # ArrowSource block lists in walk order


class _Fp:
    def __init__(self):
        self.h = hashlib.blake2b(digest_size=16)
        self.literals: List[Literal] = []
        self.block_slots: List[List[Any]] = []
        self.ok = True

    def add(self, token) -> None:
        if isinstance(token, bytes):
            self.h.update(token)
        else:
            self.h.update(str(token).encode())
        self.h.update(b"\x1f")


def _fp_callable(fn, f: _Fp) -> None:
    """Callables (MapBatches fns, UDFs) fingerprint by their cloudpickle
    bytes — the same serialization that ships them, so two queries hash equal
    exactly when the executor would receive the same code + closure."""
    import cloudpickle

    try:
        f.add(hashlib.blake2b(cloudpickle.dumps(fn), digest_size=16).digest())
    except Exception:  # unpicklable fn: the plan cannot ship, mark plan uncacheable
        f.ok = False


def _fp_expr(expr, f: _Fp) -> None:
    if isinstance(expr, Literal):
        # value EXCLUDED from the fingerprint: literals are parameter slots
        # (a changed filter constant rebinds; it must not recompile)
        f.add("Lit")
        f.add(type(expr.value).__name__)
        f.literals.append(expr)
        return
    f.add(type(expr).__name__)
    if isinstance(expr, ColumnRef):
        f.add(expr.name)
    elif isinstance(expr, Alias):
        f.add(expr.name)
        _fp_expr(expr.child, f)
    elif isinstance(expr, Cast):
        f.add(str(expr.dtype))
        _fp_expr(expr.child, f)
    elif isinstance(expr, BinaryOp):
        f.add(expr.op)
        _fp_expr(expr.left, f)
        _fp_expr(expr.right, f)
    elif isinstance(expr, UnaryOp):
        f.add(expr.op)
        _fp_expr(expr.child, f)
    elif isinstance(expr, IsIn):
        # the value SET is shape, not a slot (it feeds pa.array at eval)
        f.add(repr(expr.values))
        _fp_expr(expr.child, f)
    elif isinstance(expr, Function):
        f.add(expr.fn)
        f.add(repr(expr.options))
        for a in expr.args:
            _fp_expr(a, f)
    elif isinstance(expr, When):
        f.add(len(expr.branches))
        for c, v in expr.branches:
            _fp_expr(c, f)
            _fp_expr(v, f)
        if expr.default is not None:
            f.add("default")
            _fp_expr(expr.default, f)
    elif isinstance(expr, Udf):
        f.add(str(expr.dtype))
        _fp_callable(expr.func, f)
        for a in expr.args:
            _fp_expr(a, f)
    elif isinstance(expr, SharedExpr):
        _fp_expr(expr.child, f)
    else:
        f.ok = False  # user-defined Expr subclass: shape unknown


def _fp_node(node: lp.PlanNode, f: _Fp) -> None:
    f.add(type(node).__name__)
    if isinstance(node, lp.ArrowSource):
        # blocks are a parameter slot (same shape over fresh data must HIT);
        # the schema is shape — a schema change recompiles
        f.add(node.schema.serialize().to_pybytes())
        f.block_slots.append(list(node.blocks))
        return
    if isinstance(node, lp.RangeSource):
        f.add((node.start, node.end, node.step, node.num_partitions))
        return
    if isinstance(node, (lp.ParquetSource, lp.CsvSource)):
        if isinstance(node, lp.ParquetSource):
            f.add(repr((node.file_groups, node.columns)))
        else:
            f.add(repr((node.file_groups, sorted(node.read_options.items()))))
        return
    if isinstance(node, lp.Project):
        for name, expr in node.columns:
            f.add(name)
            _fp_expr(expr, f)
    elif isinstance(node, lp.Filter):
        _fp_expr(node.predicate, f)
    elif isinstance(node, lp.MapBatches):
        _fp_callable(node.fn, f)
    elif isinstance(node, lp.Sample):
        f.add((node.fraction, node.seed))
    elif isinstance(node, (lp.PartitionHead, lp.GlobalLimit)):
        f.add(node.n)
    elif isinstance(node, lp.Repartition):
        f.add((node.num_partitions, node.by, node.shuffle_seed))
    elif isinstance(node, lp.GroupByAgg):
        f.add((node.keys, node.num_partitions))
        for a in node.aggs:
            f.add((a.agg, a.column, a.out_name))
    elif isinstance(node, lp.Join):
        f.add((node.on, node.how, node.num_partitions, node.broadcast))
    elif isinstance(node, lp.Sort):
        f.add((node.keys, node.ascending, node.num_partitions))
    elif isinstance(node, lp.Distinct):
        f.add(node.num_partitions)
    elif isinstance(node, lp.Window):
        f.add(
            (
                node.partition_by, node.order_by, node.ascending,
                node.num_partitions,
            )
        )
        for name, e in node.exprs:
            f.add((name, e.kind, e.column, e.offset, repr(e.default)))
    elif isinstance(node, lp.Union):
        f.add(len(node.inputs))
    else:
        f.ok = False
        return
    for child in node.children():
        _fp_node(child, f)


def fingerprint_plan(
    node: lp.PlanNode, output_desc: Tuple, confs: Tuple
) -> Optional[PlanKey]:
    """(fingerprint, literal objects, block slot lists) for a plan + the
    action's output shape + the lowering-relevant session confs — or None
    when the plan contains something we cannot fingerprint (unpicklable fn,
    unknown node/expr type). Literal VALUES and ArrowSource block refs are
    excluded: they are the rebindable parameters."""
    f = _Fp()
    f.add(repr(output_desc))
    f.add(repr(confs))
    _fp_node(node, f)
    if not f.ok:
        return None
    return PlanKey(f.h.hexdigest(), f.literals, f.block_slots)


# ---------------------------------------------------------------------------
# literal slots over compiled chains
# ---------------------------------------------------------------------------


def _expr_literals(expr, out: List[Literal], seen: set) -> None:
    if isinstance(expr, Literal):
        if id(expr) not in seen:  # fused chains may share one Literal object
            seen.add(id(expr))
            out.append(expr)
        return
    if isinstance(expr, (Alias, Cast, UnaryOp, IsIn, SharedExpr)):
        _expr_literals(expr.child, out, seen)
    elif isinstance(expr, BinaryOp):
        _expr_literals(expr.left, out, seen)
        _expr_literals(expr.right, out, seen)
    elif isinstance(expr, (Function, Udf)):
        for a in expr.args:
            _expr_literals(a, out, seen)
    elif isinstance(expr, When):
        for c, v in expr.branches:
            _expr_literals(c, out, seen)
            _expr_literals(v, out, seen)
        if expr.default is not None:
            _expr_literals(expr.default, out, seen)


def chain_literals(chain: Sequence[lp.PlanNode]) -> List[Literal]:
    """Every distinct Literal object reachable from a (prepared) narrow
    chain, in deterministic traversal order — THE slot ordering shared by
    compile (template recording) and bind (value substitution)."""
    out: List[Literal] = []
    seen: set = set()
    for node in chain:
        if isinstance(node, lp.Project):
            for _, expr in node.columns:
                _expr_literals(expr, out, seen)
        elif isinstance(node, lp.Filter):
            _expr_literals(node.predicate, out, seen)
    return out


def slot_map_for(
    chains: Sequence[Sequence[lp.PlanNode]], key: PlanKey
) -> Optional[List[List[int]]]:
    """Map each compiled chain's literal objects back to source-plan slot
    indices (fusion preserves Literal identity). None when any compiled
    literal is not a source literal — the caller then falls back to
    value-identity caching (a literal change recompiles instead of
    rebinding)."""
    src_index = {id(lit): i for i, lit in enumerate(key.literals)}
    maps: List[List[int]] = []
    for chain in chains:
        m: List[int] = []
        for lit in chain_literals(chain):
            idx = src_index.get(id(lit))
            if idx is None:
                return None
            m.append(idx)
        maps.append(m)
    return maps


def bind_chain(
    chain: List[lp.PlanNode], slot_map: List[int], values: List[Any]
) -> List[lp.PlanNode]:
    """A copy of the chain template with slot literals replaced by this
    query's values. No-op (no copy) when the chain holds no literal slots."""
    if not slot_map:
        return chain
    import copy

    bound = copy.deepcopy(chain)
    lits = chain_literals(bound)
    for lit, src_idx in zip(lits, slot_map):
        lit.value = values[src_idx]
    return bound


# ---------------------------------------------------------------------------
# compiled programs
# ---------------------------------------------------------------------------


@dataclass
class SimpleProgram:
    """One narrow stage: source reads → fused chain → output. The whole
    query ships as one ``run_plan`` per executor."""

    program_id: str
    chain: List[lp.PlanNode]
    slot_map: List[int]  # compiled-chain literal -> source slot index
    # literal values at compile time: compared at bind when slot mapping was
    # not possible (value change then recompiles instead of mis-binding)
    template_literals: Optional[List[Any]]
    source_reads: Optional[List[T.ReadSpec]]  # fixed reads (range/file srcs)
    schema_ipc: Optional[bytes]  # ArrowSource schema for block reads
    output: T.OutputSpec  # owner/storage rebound per query
    # fusion decisions recorded at compile, re-emitted per execution so a
    # cache hit reports the same etl.fusion stats a fresh compile does
    fusion: List[dict] = field(default_factory=list)

    kind = "simple"


@dataclass
class ExchangeProgram:
    """One map→shuffle→reduce exchange with a simple map side: the shapes
    behind repartition / groupBy / distinct / window. Single-executor pools
    run the whole graph from one ``run_plan``; wider pools reuse the staged
    barrier-free launcher with every piece prebuilt here."""

    program_id: str
    map_chain: List[lp.PlanNode]
    map_slot_map: List[int]
    reduce_chain: List[lp.PlanNode]
    reduce_slot_map: List[int]
    template_literals: Optional[List[Any]]
    source_reads: Optional[List[T.ReadSpec]]
    schema_ipc: Optional[bytes]  # map-side source schema (block reads)
    map_out: T.OutputSpec  # *_split spec; indexed_splits rebound per session
    merge: T.MergeSpec
    child_schema_ipc: bytes  # shuffle-read schema (map OUTPUT rows)
    num_reducers: int
    output: T.OutputSpec
    fusion: List[dict] = field(default_factory=list)

    kind = "exchange"


Program = Any  # SimpleProgram | ExchangeProgram


def wire_blob(program: Program) -> bytes:
    """The program's shipped form, pickled ONCE at compile (cached on the
    program object): warm dispatches re-send these bytes without re-walking
    the plan, and cloudpickle treats a bytes payload as a straight copy."""
    blob = getattr(program, "_wire_blob", None)
    if blob is None:
        import cloudpickle

        blob = cloudpickle.dumps(program)
        program._wire_blob = blob  # type: ignore[attr-defined]
    return blob


def build_simple_specs(
    program: SimpleProgram, binding: Dict[str, Any]
) -> List[T.TaskSpec]:
    chain = bind_chain(
        program.chain, program.slot_map, binding.get("literals") or []
    )
    output = replace(
        program.output,
        owner=binding.get("owner"),
        storage=binding.get("storage", program.output.storage),
    )
    reads = binding["reads"]
    indices = binding["indices"]
    return [
        T.TaskSpec(reads=[r], chain=chain, output=output, partition_index=i)
        for r, i in zip(reads, indices)
    ]


def build_exchange_stages(
    program: ExchangeProgram, binding: Dict[str, Any]
) -> Tuple[List[T.TaskSpec], Callable[[int, T.ReadSpec], T.TaskSpec]]:
    """(map specs, reduce spec factory) for one bound exchange. The factory
    mirrors the legacy ``spec_fn`` closures so the staged launcher path and
    the fused single-dispatch path build byte-identical reduce tasks."""
    literals = binding.get("literals") or []
    map_chain = bind_chain(program.map_chain, program.map_slot_map, literals)
    reduce_chain = bind_chain(
        program.reduce_chain, program.reduce_slot_map, literals
    )
    map_out = program.map_out
    if map_out.kind.endswith("_split"):
        # the indexed-vs-legacy decision is the SESSION's, rebound per
        # dispatch; non-split map outputs (keyless groupby/window) never
        # carry it
        map_out = replace(
            map_out, indexed_splits=bool(binding.get("indexed", True))
        )
    output = replace(
        program.output,
        owner=binding.get("owner"),
        storage=binding.get("storage", program.output.storage),
    )
    map_specs = [
        T.TaskSpec(reads=[r], chain=map_chain, output=map_out, partition_index=i)
        for r, i in zip(binding["reads"], binding["indices"])
    ]

    def reduce_spec(r: int, read: T.ReadSpec) -> T.TaskSpec:
        return T.TaskSpec(
            reads=[read],
            merge=program.merge,
            chain=reduce_chain,
            output=output,
            partition_index=binding.get("offset", 0) + r,
        )

    return map_specs, reduce_spec


def execute_program(
    program: Program, binding: Dict[str, Any], fanout
) -> Any:
    """Run a bound program locally — the executor-resident half of
    ``run_plan`` (also used by the driver's in-process fallback). ``fanout``
    runs a list of TaskSpecs and returns their TaskResults. Returns the
    final results for simple programs; ``(map_results, reduce_results)``
    for exchanges (the caller owns intermediate-block cleanup, exactly like
    ``run_shuffle``)."""
    if program.kind == "simple":
        return fanout(build_simple_specs(program, binding))
    map_specs, reduce_spec = build_exchange_stages(program, binding)
    map_results = fanout(map_specs)
    reads = T.build_shuffle_reads(
        map_results, program.num_reducers, program.child_schema_ipc
    )
    reduce_specs = [
        reduce_spec(r, reads[r]) for r in range(program.num_reducers)
    ]
    return map_results, fanout(reduce_specs)


# ---------------------------------------------------------------------------
# cross-tenant shared plan cache (raydp_tpu_torch.tenancy)
#
# Compiled programs are already keyed by plan FINGERPRINT — nothing about a
# program binds it to the session that compiled it (block refs and literals
# are parameter slots; the output owner rides the per-query binding). This
# process-wide LRU therefore lets every planner in the driver share one
# compile: identical feature queries from different tenants (the
# dashboards-everywhere workload) lower ONCE, and the executor-resident
# cache sees one program id no matter which tenant ships it. Entries are
# tagged with the compiling tenant so a hit from a DIFFERENT tenant is
# counted (``plan_cache.cross_tenant_hits`` — the bench/perf-smoke
# evidence). Probed only by planners with ``shared_plan_cache`` on (the
# tenancy arm); the per-planner LRU in front of it is unchanged.
# ---------------------------------------------------------------------------

import collections as _collections
import threading as _threading

from raydp_tpu_torch.sanitize import named_lock as _named_lock

SHARED_PLAN_CACHE_CAP = 128
_shared_plan_lock = _named_lock("tenancy.plan_cache", _threading.Lock())
_shared_plans: "_collections.OrderedDict" = _collections.OrderedDict()  # fingerprint -> (program, tenant); guarded-by: _shared_plan_lock


def shared_plan_get(fingerprint: str, tenant: str):
    """``(program, compiled_by_tenant)`` for a fingerprint, or None. The
    CALLER counts the cross-tenant hit — and only after actually adopting
    the program (a template-literal mismatch rejects it post-probe, and a
    counted-but-unused probe would fake the sharing evidence the
    perf-smoke gate exists for)."""
    with _shared_plan_lock:
        entry = _shared_plans.get(fingerprint)
        if entry is None:
            return None
        _shared_plans.move_to_end(fingerprint)
        return entry


def note_cross_tenant_hit(tenant: str) -> None:
    """Record one ADOPTED cross-tenant shared-plan hit."""
    from raydp_tpu_torch.obs import metrics

    metrics.counter("plan_cache.cross_tenant_hits").inc()
    if tenant:
        metrics.counter(f"tenant.{tenant}.plan_cache_cross_hits").inc()


def shared_plan_put(fingerprint: str, program, tenant: str) -> None:
    """Publish a freshly compiled program under its fingerprint, tagged with
    the compiling tenant (first compiler wins the tag — a recompile race
    must not flip attribution under a concurrent reader)."""
    with _shared_plan_lock:
        if fingerprint not in _shared_plans:
            _shared_plans[fingerprint] = (program, tenant or "")
        _shared_plans.move_to_end(fingerprint)
        while len(_shared_plans) > SHARED_PLAN_CACHE_CAP:
            _shared_plans.popitem(last=False)


def shared_plan_clear() -> None:
    """Drop every shared program (tests)."""
    with _shared_plan_lock:
        _shared_plans.clear()
