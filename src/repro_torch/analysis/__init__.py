"""repro_torch.analysis — static analyzer for coloring plans (the PyTorch
port of ``repro.analysis``).

The reference walks the jaxpr of every compiled plan program. The port's
programs are eager PyTorch with host loops, so the analyzer's trace is a
**recording of one run** of the plan's program (:mod:`.record`): every
aten op with its dtypes, shapes, site and provenance, every kernel launch
and every ``ProcessMesh`` collective. It records on the graph
``compile_plan`` was given, or — for a :class:`PlanShape` — on a seeded
graph it builds inside the envelope; it records again on a second graph
of the envelope (shape stability), and on seeded graphs built to reach
each program path the first run missed (a frontier round, a slab spill,
DATAFLOW's active sweep, the frontier-slab wire). A path it still cannot
reach is ``ANALYSIS000``: the cell is unverified, not clean. Passes:

* **race classifier** (:mod:`.races`) — every recorded store, classified
  against the paper's benign-speculation model;
* **cache-key lint** (:mod:`.retrace`) — sentinel and non-hashable cache
  keys (AST), graph values leaking into the program (recordings);
* **budget checker** (:mod:`.budgets`) — packed-entry bit fields, int32
  index arithmetic, per-block shared memory and, on the card, each
  kernel's registers and block size.

Distributed (host-strategy) plans additionally run the SPMD verifier over
the recordings of every rank of the launch (pooled over the mesh's group):

* **collective safety** (:mod:`.collectives`);
* **wire-cost model** (:mod:`.wirecost`) — recorded bytes-on-wire against
  the closed-form tier accounting (DESIGN.md §Perf);
* **halo exactness** (:mod:`.halo`).

Front doors:

* ``compile_plan(spec, graph_or_shape, verify="warn"|"error")`` —
  per-plan gate (:func:`verify_plan`);
* ``python -m repro_torch.analysis`` — full registry sweep + source lint +
  dead-code scan against the committed baseline (:mod:`.__main__`).

Like every entry point of the port, the analyzer records on the card
unless asked for the CPU (``device="cpu"``); a recording on the CPU and
one on the card give the same findings, because a kernel's plain version
runs inside its launch scope.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .findings import (CODES, AnalysisError, Finding, dedupe, gating,
                       split_by_severity)
from .baseline import (compare, default_baseline_path, load_baseline,
                       save_baseline)
from . import budgets as _budgets
from . import collectives as _collectives
from . import deadcode as _deadcode
from . import halo as _halo
from . import races as _races
from . import retrace as _retrace
from . import wirecost as _wirecost
from .record import Recording, record
from .spmd import SpmdGeometry, distributed_geometry
from .collectives import check_collectives
from .halo import check_halo_exactness
from .wirecost import check_wire_cost, closed_form_table, wire_cost_table

__all__ = [
    "AnalysisConfig", "AnalysisError", "Finding", "CODES",
    "analyze_plan", "analyze_spec", "lint_tree", "sweep_registry",
    "sweep_distributed", "verify_findings", "verify_plan", "dedupe",
    "gating", "split_by_severity", "compare", "load_baseline",
    "save_baseline", "default_baseline_path", "SpmdGeometry",
    "distributed_geometry", "check_collectives", "check_wire_cost",
    "check_halo_exactness", "closed_form_table", "wire_cost_table",
    "record_plan", "seeded_graph", "Recording",
]

# the registry axes a sweep covers by default (every shipping combination)
SWEEP_STRATEGIES = ("iterative", "dataflow", "distributed", "recolor")
SWEEP_ENGINES = ("sort", "bitmap", "ell_pallas", "fused_pallas")
SWEEP_MODELS = ("d1", "d2", "pd2")
# the distributed-sweep axes (--distributed): every wire x partition cell
SWEEP_WIRES = ("boundary", "full", "auto")
SWEEP_SCHEMES = ("1d", "2d")
# the reference's default envelope
DEFAULT_SHAPE = dict(num_vertices=48, padded_edges=512, max_degree=8)
# one rank has no cross-shard race, so the sweeps' distributed cells run
# two lockstep threads per rank: that reaches the frontier round and the
# frontier-slab wire on one rank
SWEEP_LOCAL_CONCURRENCY = 2


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Knobs shared by every front door.

    vmem_ceiling_bytes  per-block shared-memory budget of a kernel (None =
                        the card's opt-in limit on the card, Hopper's
                        232,448 B on the CPU, or the
                        REPRO_ANALYSIS_VMEM_CEILING env var);
    baseline_path       allowlist location (None = the committed
                        ``repro_torch/analysis/baseline.json``).
    """

    vmem_ceiling_bytes: Optional[int] = None
    baseline_path: Optional[str] = None


# --------------------------------------------------------------------------
# graphs inside an envelope
# --------------------------------------------------------------------------
def _capped_edges(u: np.ndarray, v: np.ndarray, V: int, max_degree: int,
                  max_pairs: int) -> np.ndarray:
    """Distinct undirected pairs from ``(u, v)`` (self loops dropped), in
    order, keeping each endpoint at most ``max_degree // 2`` times per side
    so no vertex exceeds ``max_degree``; at most ``max_pairs`` pairs."""
    keep = u != v
    u, v = np.minimum(u, v)[keep], np.maximum(u, v)[keep]
    key = u.astype(np.int64) * V + v
    _, first = np.unique(key, return_index=True)
    first.sort()
    u, v = u[first], v[first]
    side = max(1, max_degree // 2)

    def occurrence(x):
        order = np.argsort(x, kind="stable")
        xs = x[order]
        starts = np.r_[0, np.flatnonzero(np.diff(xs)) + 1]
        rank = np.arange(xs.size) - np.repeat(starts, np.diff(
            np.r_[starts, xs.size]))
        out = np.empty_like(rank)
        out[order] = rank
        return out

    if max_degree < 1:
        return np.zeros((0, 2), np.int64)
    ok = (occurrence(u) < side) & (occurrence(v) < side)
    if max_degree < 2:    # a matching: every vertex in at most one pair
        ok &= ~np.isin(u, v[ok]) & ~np.isin(v, u[ok])
    return np.stack([u[ok], v[ok]], axis=1)[:max_pairs]


def _to_original(spec, statics, pairs: np.ndarray) -> np.ndarray:
    """Pairs given in distributed partition space -> original vertex ids
    (the ``"2d"`` scheme relabels; ``"1d"`` is the identity)."""
    if spec.partition != "2d" or pairs.size == 0:
        return pairs
    from ..core.distributed import _grid_shape
    D = spec.mesh.num_devices if spec.mesh is not None else 1
    V = int(statics.num_vertices)
    Vl = -(-V // D)
    Pr, Pc = _grid_shape(D)
    ids = np.arange(V, dtype=np.int64)
    perm = (((ids % Pr) * Pc + (ids // Pr) % Pc) * Vl + ids // D)
    inv = np.full(Vl * D, -1, np.int64)
    inv[perm] = ids
    out = inv[pairs]
    return out[(out >= 0).all(axis=1)]


def seeded_graph(spec, statics, *, seed: int = 0, purpose: str = "base"):
    """A host constraint :class:`Graph` inside ``statics`` (exactly its
    vertex count, at most its directed edges and max degree), made from
    ``seed``. ``purpose``: ``"base"`` a sparse random graph (for the
    distributed strategy: random edges inside each shard, plus a chain of
    cross-shard edges that keeps every shard at two boundary vertices);
    ``"frontier round"`` / ``"frontier-slab wire"`` a few same-round
    conflicts, so a later round's pending set fits the frontier slab;
    ``"slab spill"`` more conflicts than the slab holds; ``"active sweep"``
    a path, so DATAFLOW's changed set shrinks to a slab."""
    from ..core.graph import Graph
    V = int(statics.num_vertices)
    dmax = int(statics.max_degree)
    max_pairs = max(0, int(statics.padded_edges) // 2)
    rng = np.random.default_rng(seed)
    distributed = spec.strategy == "distributed"
    D = spec.mesh.num_devices if (distributed and spec.mesh is not None) \
        else 1
    Vl = -(-V // D)
    if purpose == "active sweep":
        pairs = np.array([[i, i + 1] for i in range(min(V - 1, 2))],
                         np.int64).reshape(-1, 2)
    elif purpose in ("frontier round", "frontier-slab wire",
                     "slab spill") and not (distributed and D > 1):
        conc = int(spec.local_concurrency if distributed
                   else spec.concurrency)
        bs = -(-V // max(1, conc))
        n = max(0, V - bs)
        n = min(n, 4) if purpose != "slab spill" else n
        u = np.arange(n, dtype=np.int64)
        pairs = np.stack([u, u + bs], axis=1)
    elif distributed and D > 1:
        # cross edges (d*Vl + 1, (d+1)*Vl): two boundary vertices a shard,
        # one same-round conflict per shard pair (the higher id recolors)
        d = np.arange(D - 1, dtype=np.int64)
        pairs = np.stack([d * Vl + 1, (d + 1) * Vl], axis=1)
        pairs = pairs[(pairs < V).all(axis=1)]
        if purpose == "base":
            m = min(max_pairs, 2 * V)
            loc = rng.integers(0, max(1, Vl), size=(m, 2))
            own = rng.integers(0, D, size=(m, 1)) * Vl
            inner = loc + own
            inner = inner[(inner < V).all(axis=1)]
            pairs = np.concatenate([pairs, inner])
        pairs = _to_original(spec, statics, pairs)
    else:
        m = min(max_pairs, 2 * V)
        pairs = rng.integers(0, max(1, V), size=(m, 2))
    edges = _capped_edges(pairs[:, 0], pairs[:, 1], V, dmax, max_pairs) \
        if len(pairs) else np.zeros((0, 2), np.int64)
    return Graph.from_edges(V, edges.astype(np.int64))


def _frontier_caps(spec, statics) -> Tuple[int, int]:
    from ..core.frontier import resolve_frontier
    if spec.strategy == "distributed":
        g = distributed_geometry(spec, statics)
        return g.frontier_cap_v, g.frontier_cap_e
    return resolve_frontier(
        spec.frontier, int(spec.frontier_capacity),
        num_vertices=int(statics.num_vertices),
        padded_edges=int(statics.padded_edges),
        max_degree=int(statics.max_degree), has_inc=True)


def required_paths(spec, statics) -> Tuple[str, ...]:
    """The program paths a verify must have recorded for ``spec`` at
    ``statics``: only paths the program can reach. A second round needs
    two pending vertices of one round racing — lockstep threads
    (``concurrency > 1``) or, distributed, two ranks; a slab spill needs
    more pending vertices than the slab holds."""
    V, E = int(statics.num_vertices), int(statics.padded_edges)
    dmax = int(statics.max_degree)
    cap_v, cap_e = _frontier_caps(spec, statics)
    if cap_v <= 0 or V < 2 or E < 2 or dmax < 1:
        return ()
    if spec.strategy == "dataflow":
        return ("active sweep",) if V >= 3 and dmax >= 2 else ()
    if spec.strategy == "distributed":
        D = spec.mesh.num_devices if spec.mesh is not None else 1
        if D > 1 or int(spec.local_concurrency) > 1:
            return ("frontier round", "frontier-slab wire")
        return ()
    conc = max(1, int(spec.concurrency))
    bs = -(-V // conc)
    if conc < 2 or bs >= V:
        return ()
    paths = ("frontier round",)
    if dmax >= 2 and cap_v < min(V - bs, E // 2):
        paths += ("slab spill",)
    return paths


# --------------------------------------------------------------------------
# recording a plan's program
# --------------------------------------------------------------------------
def _device_tensors(dg) -> list:
    import torch
    return [getattr(dg, f.name) for f in dataclasses.fields(dg)
            if isinstance(getattr(dg, f.name), torch.Tensor)]


def record_plan(spec, statics, graph, device=None, *,
                state: Optional[dict] = None) -> Recording:
    """Record one run of the program a plan with ``spec``/``statics`` runs,
    on the host constraint graph ``graph``, on ``device`` (None = the
    card; a mesh-bound spec runs on its mesh's device). ``state`` is
    per-call state (``"recolor"``'s ``colors=``/``seed=``). Distributed
    specs record this rank's program with the analyzer's geometry
    (:func:`distributed_geometry`); every rank of the mesh must call this
    together."""
    from ..core.api import ColoringPlan, get_strategy
    from ..core.engine import get_backend
    spec1 = dataclasses.replace(spec, model="d1")
    plan = ColoringPlan(spec1, statics, device)
    canon, _ = plan._canonicalize(graph)
    strategy = get_strategy(spec.strategy)
    dev = plan.device.type
    if strategy.wants == "host":
        return _record_distributed(spec1, statics, canon, plan.device)
    prog = strategy.device_program(spec1, get_backend(spec.engine))
    args = strategy.plan_state(spec1, statics, **(state or {}))
    rec, _ = record(lambda: prog(canon, *args),
                    static_inputs=_device_tensors(canon), data_inputs=args,
                    device=dev)
    return rec


def _record_distributed(spec, statics, host, device) -> Recording:
    from ..core.api import DistributedStrategy, get_strategy
    from ..core.distributed import partition_graph
    g = distributed_geometry(spec, statics)
    mesh = DistributedStrategy._mesh(spec, device)
    fn = get_strategy("distributed")._build(
        spec, mesh, verts_local=g.verts_local, edges_local=g.edges_local,
        max_colors=g.max_colors, ell_width=int(statics.max_degree),
        wire=g.wire, wire_colors=g.wire_colors)
    layout = partition_graph(host, g.num_devices, pad_edges_to=g.edges_local,
                             scheme=spec.partition)
    if g.wire == "boundary":
        bnd = layout.padded_boundary(g.boundary_cap)
    else:
        bnd = np.full((g.num_devices, 1), layout.verts_local, np.int32)
    rec, _ = record(lambda: fn(layout.lsrc, layout.ldst, bnd),
                    static_inputs=(layout.lsrc, layout.ldst, bnd),
                    device=mesh.device.type, rank=mesh.rank,
                    num_devices=g.num_devices, vp=g.verts_global, spmd=True)
    return rec


def _pool(rec: Recording, spec) -> List[Recording]:
    """Every rank's recording of one run, in rank order (a one-rank spec:
    just ``rec``)."""
    mesh = spec.mesh
    if mesh is None or mesh.group is None:
        return [rec]
    import torch.distributed as dist
    out = [None] * mesh.num_devices
    dist.all_gather_object(out, rec.to_json(), group=mesh.group)
    return [Recording.from_json(r) for r in out]


def _reached(recs: Sequence[Recording], spec) -> set:
    """The paths any rank's recordings reached: every rank takes the same
    coverage decisions, so every rank runs the same recordings."""
    mine = sorted({p for r in recs for p in r.paths})
    mesh = spec.mesh
    if mesh is None or mesh.group is None:
        return set(mine)
    import torch.distributed as dist
    out = [None] * mesh.num_devices
    dist.all_gather_object(out, mine, group=mesh.group)
    return {p for ps in out for p in ps}


def _recordings(spec, statics, graph, device, context):
    """Record the program on ``graph`` (or a seeded base graph), on a
    second graph of the envelope, and on graphs built for the paths the
    runs missed. Returns (recordings, ANALYSIS000 findings)."""
    from ..core.distance2 import constraint_host_graph
    from ..core.graph import BipartiteGraph, Graph
    if isinstance(graph, (Graph, BipartiteGraph)):
        base = constraint_host_graph(graph, spec.model, side=spec.side)
    else:
        base = seeded_graph(spec, statics, seed=0)
    recs = [record_plan(spec, statics, base, device),
            record_plan(spec, statics, seeded_graph(spec, statics, seed=1),
                        device)]
    missing: List[Finding] = []
    for path in required_paths(spec, statics):
        if path in _reached(recs, spec):
            continue
        recs.append(record_plan(spec, statics,
                                seeded_graph(spec, statics, seed=2,
                                             purpose=path), device))
        if path not in _reached(recs, spec):
            missing.append(Finding(
                "ANALYSIS000", f"plan:{spec.strategy}",
                f"no recorded run reached the {path!r} path of the "
                "program: that path is unverified", context))
    return recs, missing


def _context(spec) -> str:
    from ..core.engine import get_backend
    eng = spec.engine if isinstance(spec.engine, str) else \
        get_backend(spec.engine).name
    return f"{spec.strategy}/{eng}/{spec.model}"


def analyze_spec(spec, graph_or_shape, *,
                 config: Optional[AnalysisConfig] = None,
                 context: Optional[str] = None, device=None,
                 graph=None) -> List[Finding]:
    """All plan-scoped passes for one spec: spec-level budgets, then record
    the program (:func:`record_plan`) and run the race classifier, the
    envelope-leak and shape-stability checks and the kernel shared-memory
    audit. Distributed plans additionally run the SPMD verifier over every
    rank's recordings. ``graph_or_shape``: the graph to record on, or a
    :class:`PlanShape` (seeded graphs are built inside it); ``graph``
    overrides the graph recorded when a shape is given. A program that
    cannot be recorded yields ANALYSIS000 (the cell is *unverified*, not
    clean)."""
    from ..core.api import _plan_shape, get_strategy

    from ..core.api import _spec_device
    from ..core.graph import resolve_device

    config = config or AnalysisConfig()
    statics = _plan_shape(spec, graph_or_shape)
    if graph is None and not hasattr(graph_or_shape, "boundary_cap"):
        graph = graph_or_shape
    device = resolve_device(_spec_device(spec, device))
    ctx = context if context is not None else _context(spec)
    ceiling = config.vmem_ceiling_bytes
    if ceiling is None:
        ceiling = _budgets.default_smem_ceiling(device)
    findings = _budgets.check_spec_budgets(
        spec, statics, vmem_ceiling=ceiling, context=ctx)
    if statics.num_vertices == 0 or statics.padded_edges == 0:
        return findings  # degenerate envelope: no program exists to run
    try:
        recs, missing = _recordings(spec, statics, graph, device, ctx)
    except Exception as e:  # noqa: BLE001 — any recording failure is a finding
        findings.append(Finding(
            "ANALYSIS000", f"plan:{spec.strategy}",
            f"program could not be recorded: {type(e).__name__}: {e}", ctx))
        return findings
    findings += missing
    findings += _races.classify_scatters(recs, context=ctx)
    findings += _retrace.check_trace_constants(
        recs, context=ctx, site=f"plan:{spec.strategy}")
    findings += _retrace.check_shape_stability(
        recs[0], recs[1], context=ctx, site=f"plan:{spec.strategy}")
    findings += _budgets.check_kernel_smem(
        recs, vmem_ceiling=ceiling, context=ctx, attributes={})
    if get_strategy(spec.strategy).wants == "host":
        g = distributed_geometry(spec, statics)
        for rec in recs:
            ranks = _pool(rec, spec)
            findings += _collectives.check_collectives(ranks, context=ctx)
            findings += _wirecost.check_wire_cost(ranks, g, context=ctx)
            findings += _halo.check_halo_exactness(ranks, g, context=ctx)
    return findings


def analyze_plan(plan, *, config: Optional[AnalysisConfig] = None,
                 graph=None) -> List[Finding]:
    """:func:`analyze_spec` over an already-built plan's envelope, on its
    device."""
    return analyze_spec(plan.spec, plan.statics, config=config,
                        device=plan.device, graph=graph)


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_tree(package_root: Optional[str] = None,
              repo_root: Optional[str] = None) -> List[Finding]:
    """Source-level passes (no recording): the cache-key AST lint over
    every module in the package, plus the dead-export scan."""
    pkg = package_root or _package_root()
    repo = repo_root or os.path.dirname(os.path.dirname(pkg))
    findings = _retrace.lint_package(pkg)
    findings += _deadcode.scan_package(pkg, repo)
    return findings


def _default_shape():
    from ..core.api import PlanShape
    return PlanShape(**DEFAULT_SHAPE)


def sweep_registry(statics=None, *,
                   strategies: Sequence[str] = SWEEP_STRATEGIES,
                   engines: Sequence[str] = SWEEP_ENGINES,
                   models: Sequence[str] = SWEEP_MODELS,
                   config: Optional[AnalysisConfig] = None,
                   progress=None, device=None) -> List[Finding]:
    """Analyze every strategy x engine x model combination, deduped by
    fingerprint (distributed cells with
    ``local_concurrency=SWEEP_LOCAL_CONCURRENCY``, see there). Plan
    programs run on the *constraint* graph, so the model
    axis only changes the host-side lowering: the program of (strategy,
    engine) is recorded once; the model axis still runs the (cheap)
    spec-budget pass per combination."""
    from ..core.api import ColoringSpec

    config = config or AnalysisConfig()
    statics = statics or _default_shape()
    findings: List[Finding] = []
    for strat in strategies:
        for eng in engines:
            for i, model in enumerate(models):
                spec = ColoringSpec(strategy=strat, engine=eng, model=model,
                                    local_concurrency=SWEEP_LOCAL_CONCURRENCY)
                ctx = f"{strat}/{eng}/{model}"
                if progress is not None:
                    progress(ctx)
                if i == 0:
                    findings += analyze_spec(spec, statics, config=config,
                                             context=ctx, device=device)
                else:
                    findings += _budgets.check_spec_budgets(
                        spec, statics,
                        vmem_ceiling=config.vmem_ceiling_bytes, context=ctx)
    return dedupe(findings)


def sweep_distributed(statics=None, *,
                      wires: Sequence[str] = SWEEP_WIRES,
                      schemes: Sequence[str] = SWEEP_SCHEMES,
                      engines: Sequence[str] = SWEEP_ENGINES,
                      config: Optional[AnalysisConfig] = None,
                      progress=None, device=None,
                      mesh=None) -> List[Finding]:
    """The distributed sweep (``--distributed``): every wire x partition
    scheme x engine cell of the host strategy, deduped by fingerprint, on
    ``mesh`` (None = one rank). ``wire="auto"`` records the boundary
    program, so the program is recorded once per (engine, resolved wire,
    scheme); the remaining cells still run the spec-budget pass."""
    from ..core.api import ColoringSpec

    config = config or AnalysisConfig()
    statics = statics or _default_shape()
    findings: List[Finding] = []
    recorded = set()
    for wire in wires:
        for scheme in schemes:
            for eng in engines:
                spec = ColoringSpec(
                    strategy="distributed", engine=eng, wire=wire,
                    partition=scheme, mesh=mesh,
                    local_concurrency=SWEEP_LOCAL_CONCURRENCY)
                ctx = f"distributed/{eng}/wire={wire}/{scheme}"
                if progress is not None:
                    progress(ctx)
                cell = (eng, "full" if wire == "full" else "boundary",
                        scheme)
                if cell in recorded:
                    findings += _budgets.check_spec_budgets(
                        spec, statics,
                        vmem_ceiling=config.vmem_ceiling_bytes, context=ctx)
                else:
                    recorded.add(cell)
                    findings += analyze_spec(spec, statics, config=config,
                                             context=ctx, device=device)
    return dedupe(findings)


def verify_findings(findings: Iterable[Finding], *, mode: str = "warn",
                    config: Optional[AnalysisConfig] = None
                    ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Compare findings against the committed baseline and enforce ``mode``:
    ``"warn"`` emits a Python warning per new violation, ``"error"``
    raises :class:`AnalysisError`. Returns (new, allowlisted, stale)."""
    if mode not in ("warn", "error"):
        raise ValueError(f'verify mode must be "warn" or "error", '
                         f'got {mode!r}')
    config = config or AnalysisConfig()
    baseline = load_baseline(config.baseline_path)
    new, allowed, stale = compare(findings, baseline)
    if new:
        text = "\n".join(f.format() for f in new)
        if mode == "error":
            raise AnalysisError(
                f"{len(new)} non-allowlisted finding(s):\n{text}")
        warnings.warn(f"repro_torch.analysis: {len(new)} non-allowlisted "
                      f"finding(s):\n{text}", stacklevel=3)
    return new, allowed, stale


def verify_plan(spec, graph_or_shape, *, mode: str = "warn",
                config: Optional[AnalysisConfig] = None, device=None,
                graph=None) -> List[Finding]:
    """The ``compile_plan(..., verify=...)`` gate: analyze one plan and
    enforce the baseline. Returns the (deduped) findings when it does not
    raise."""
    if mode not in ("warn", "error"):
        raise ValueError(f'verify mode must be "warn" or "error", '
                         f'got {mode!r}')
    findings = dedupe(analyze_spec(spec, graph_or_shape, config=config,
                                   device=device, graph=graph))
    verify_findings(findings, mode=mode, config=config)
    return findings
