"""The front door: ``ColoringSpec`` -> ``ColoringPlan`` -> ``ColoringReport``
(PyTorch port of ``repro.core.api``).

Three ways in, strictest first:

* ``color(graph, spec, device=...)`` — one-shot: resolve the spec, run the
  strategy, return a :class:`ColoringReport`.
* ``compile_plan(spec, graph_or_shape, device=...)`` -> :class:`ColoringPlan`
  — build once, color many: the plan fixes every static shape (vertex
  count, bucket-padded edge capacity, color capacity, ELL width, frontier
  capacities) and serves any same-bucket graph with the same program.
* the legacy ``color_iterative`` / ``color_dataflow`` shims.

``device=None`` means the card; without one the entry points raise, and
only an explicit ``device="cpu"`` runs the plain path on the host.

Registered strategies: ``"iterative"`` (paper Alg. 2), ``"dataflow"``
(Alg. 3-5) and ``"recolor"`` (the ITERATIVE loop from a warm start, the
streaming repair), under models ``"d1"``, ``"d2"`` and ``"pd2"``
(``repro_torch.core.distance2`` lowers the last two into the engine's edge
space). The reference's ``"distributed"`` strategy raises
``NotImplementedError`` naming the ROADMAP item that ports it; the spec
never coerces it to something else.

Orderings are applied by relabeling the *constraint* graph before coloring
and un-relabeling the colors on the way out — reports are always in
original vertex ids.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .distance2 import MODELS, as_constraint_graph, constraint_host_graph
from .engine import EngineSpec, MexBackend, get_backend
from .frontier import FRONTIER_MODES, resolve_frontier
from .graph import (BipartiteGraph, DeviceGraph, DeviceSpec, Graph,
                    pad_bucket, resolve_device)
from .ordering import ORDERINGS

_LOWERINGS = ("auto", "wedge", "square")

# registry names of the reference that later port slices bring over
UNPORTED_STRATEGIES = {
    "distributed": "ROADMAP A11 (distributed: partition_graph + BSP wire)",
}
# reference spec fields read only by strategies not ported yet: a spec dict
# may carry them at their default; any other value is refused
REFERENCE_ONLY_FIELDS = {
    "local_concurrency": (1, UNPORTED_STRATEGIES["distributed"]),
    "wire": ("auto", UNPORTED_STRATEGIES["distributed"]),
    "partition": ("1d", UNPORTED_STRATEGIES["distributed"]),
}


# --------------------------------------------------------------------------
# the spec
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ColoringSpec:
    """Declarative description of a coloring run — the reference's fields
    and registry names, so one ``to_dict()`` means the same to both
    packages.

    strategy     registered :class:`ColoringStrategy` name (or instance):
                 ``"iterative"`` | ``"dataflow"`` | ``"recolor"``;
    model        coloring semantics: ``"d1"`` | ``"d2"`` | ``"pd2"``
                 (repro_torch.core.distance2);
    engine       first-fit mex backend name/instance (repro_torch.core.engine);
    ordering     vertex-visit priority, a ``ORDERINGS`` key, applied to the
                 constraint graph;
    ordering_seed  seed for stochastic orderings (``"random"``);
    lowering     D2/PD2 constraint lowering: ``"auto"`` | ``"wedge"`` |
                 ``"square"`` (plans always use the dedup'd square
                 lowering, so shapes are paddable);
    side         the colored class under ``model="pd2"``;
    concurrency  ITERATIVE's lockstep virtual-thread count;
    max_rounds / max_sweeps / color_bound  as on the legacy entry points;
    frontier     active-set execution: ``"auto"`` | ``"on"`` | ``"off"``
                 (bit-identical results either way);
    frontier_capacity  static vertex-slab capacity override (0 = ladder).

    The reference's other fields (:data:`REFERENCE_ONLY_FIELDS`) belong to
    the distributed strategy, not ported yet; ``to_dict``/``from_dict``
    carry them at their defaults.
    """

    strategy: Union[str, "ColoringStrategy"] = "iterative"
    model: str = "d1"
    engine: EngineSpec = "sort"
    ordering: str = "natural"
    ordering_seed: int = 0
    lowering: str = "auto"
    side: str = "left"
    concurrency: int = 64
    max_rounds: int = 64
    max_sweeps: int = 4096
    color_bound: int = 0
    frontier: str = "auto"
    frontier_capacity: int = 0

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"unknown coloring model {self.model!r}; "
                             f"choose from {MODELS}")
        if self.lowering not in _LOWERINGS:
            raise ValueError(f"unknown lowering {self.lowering!r}; "
                             f"choose from {_LOWERINGS}")
        if isinstance(self.strategy, str) \
                and self.strategy in UNPORTED_STRATEGIES:
            raise NotImplementedError(
                f"strategy={self.strategy!r} is not ported to repro_torch "
                f"yet: {UNPORTED_STRATEGIES[self.strategy]}")
        if self.frontier not in FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode {self.frontier!r}; "
                             f"choose from {FRONTIER_MODES}")

    def resolve(self) -> Tuple["ColoringStrategy", MexBackend]:
        """Resolve the registered pieces (strategy, mex backend) by name."""
        return get_strategy(self.strategy), get_backend(self.engine)

    def to_dict(self) -> dict:
        """JSON-able export: every field by registry *name*, plus the
        reference-only fields at their defaults."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        if not isinstance(d["strategy"], str):
            d["strategy"] = get_strategy(d["strategy"]).name
        if not isinstance(d["engine"], str):
            d["engine"] = get_backend(d["engine"]).name
        d.update({k: v for k, (v, _) in REFERENCE_ONLY_FIELDS.items()})
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ColoringSpec":
        """Inverse of :meth:`to_dict` (and of the reference's); unknown
        keys are rejected, and so is a reference-only field away from its
        default."""
        d = dict(d)
        for key, (default, item) in REFERENCE_ONLY_FIELDS.items():
            if key in d and d.pop(key) != default:
                raise NotImplementedError(
                    f"{key}= is read by a part not ported to repro_torch "
                    f"yet: {item}")
        return cls(**d)


# --------------------------------------------------------------------------
# the report
# --------------------------------------------------------------------------
class RawColoring(NamedTuple):
    """What every strategy returns: colors in the strategy's label space
    (a device tensor), per-round host histories ([max_rounds] int32), and
    an unconverged flag. :class:`ColoringPlan`/:func:`color` normalize it
    into a :class:`ColoringReport`."""

    colors: torch.Tensor              # [V] int32 >= 1
    rounds: int
    conflicts_per_round: np.ndarray   # [max_rounds] int32
    sweeps_per_round: np.ndarray      # [max_rounds] int32
    unconverged: bool
    frontier_per_round: np.ndarray    # [max_rounds] int32: active vertices
    # compacted in each round (0 = the round took the full-edge path; for
    # DATAFLOW, entry 0 counts the slab-compacted sweeps instead)


def _invert_order(order: np.ndarray) -> np.ndarray:
    """``order[k]`` = vertex visited k-th -> ``perm[v]`` = new id of v."""
    perm = np.empty_like(order)
    perm[order] = np.arange(order.shape[0], dtype=order.dtype)
    return perm


def _build_report(raw: RawColoring, spec: "ColoringSpec", strategy_name: str,
                  perm: Optional[np.ndarray], t0: float, *,
                  batch_denom: int = 1) -> "ColoringReport":
    """Normalize a RawColoring into the unified report: raise on
    non-convergence, move colors to the host, un-relabel to original
    vertex ids, trim histories, stamp (amortized) wall time."""
    if raw.unconverged:
        raise RuntimeError(
            f"{strategy_name} did not converge within "
            f"max_rounds={spec.max_rounds} / max_sweeps={spec.max_sweeps}")
    colors = raw.colors.cpu().numpy()
    if perm is not None:
        colors = colors[perm]  # back to original vertex ids
    rounds = int(raw.rounds)
    return ColoringReport(
        colors=colors, rounds=rounds,
        conflicts_per_round=raw.conflicts_per_round[:rounds].copy(),
        sweeps_per_round=raw.sweeps_per_round[:rounds].copy(),
        frontier_sizes_per_round=raw.frontier_per_round[:rounds].copy(),
        wall_time_s=(time.perf_counter() - t0) / max(1, batch_denom),
        spec=spec)


def _trivial_report(spec: "ColoringSpec", num_vertices: int, t0: float, *,
                    batch_denom: int = 1,
                    colors: Optional[np.ndarray] = None) -> "ColoringReport":
    """The degenerate result (V=0, or no constraint edges at all): every
    vertex takes color 1 — vacuously valid — in zero rounds; no engine
    runs. ``colors`` keeps a recolor warm start: committed (positive)
    entries pass through, only uncolored slots take color 1."""
    if colors is not None:
        carried = np.asarray(colors).astype(np.int32)
        carried = np.where(carried > 0, carried, 1).astype(np.int32)
    else:
        carried = np.ones(num_vertices, np.int32)
    empty = np.zeros(0, np.int32)
    return ColoringReport(
        colors=carried, rounds=0,
        conflicts_per_round=empty, sweeps_per_round=empty.copy(),
        frontier_sizes_per_round=empty.copy(),
        wall_time_s=(time.perf_counter() - t0) / max(1, batch_denom),
        spec=spec)


def _graph_extent(g, spec: "ColoringSpec") -> Tuple[int, int]:
    """(colored-class size, raw edge count) of an input graph, readable
    without lowering the coloring model — the degenerate-input check."""
    if isinstance(g, BipartiteGraph):
        n = g.num_left if spec.side == "left" else g.num_right
        return n, g.num_edges
    return g.num_vertices, g.num_directed_edges


@dataclasses.dataclass
class ColoringReport:
    """The one result type every strategy produces.

    ``colors`` is a host int32 array **in original vertex ids**. Histories
    are trimmed to ``rounds`` entries. ``frontier_sizes_per_round[r]`` is
    the number of active vertices round r swept through the compacted
    frontier slab (0 = full-edge path; DATAFLOW reports its slab-compacted
    sweep count in entry 0). ``wall_time_s`` covers layout + execution +
    host transfer (plan-batched runs report the amortized per-graph time).
    ``num_colors`` counts DISTINCT positive colors."""

    colors: np.ndarray
    rounds: int
    conflicts_per_round: np.ndarray
    sweeps_per_round: np.ndarray
    wall_time_s: float
    spec: ColoringSpec
    frontier_sizes_per_round: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))

    @functools.cached_property
    def num_colors(self) -> int:
        from .metrics import num_colors as _distinct
        return _distinct(self.colors)

    @functools.cached_property
    def total_conflicts(self) -> int:
        return int(self.conflicts_per_round.sum())

    @functools.cached_property
    def sweeps(self) -> int:
        return int(self.sweeps_per_round.sum())

    def __repr__(self) -> str:  # compact: reports get printed in loops
        s = self.spec
        return (f"ColoringReport(strategy={s.strategy!r}, model={s.model!r}, "
                f"colors={self.num_colors}, rounds={self.rounds}, "
                f"sweeps={self.sweeps}, conflicts={self.total_conflicts}, "
                f"wall_time_s={self.wall_time_s:.4f})")


# --------------------------------------------------------------------------
# the strategy layer
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ColoringStrategy:
    """Base class: a named, registered coloring algorithm.

    A strategy supplies ONE thing: how to turn a constraint
    :class:`DeviceGraph` into a :class:`RawColoring`
    (:meth:`device_program`). The base class derives one-shot execution
    (:meth:`oneshot`); :class:`ColoringPlan` builds the program once and
    feeds it per-call state through :meth:`plan_state`.
    """

    name = "abstract"
    supports_map = True    # plan.map() serves a batch

    def device_program(self, spec: ColoringSpec,
                       backend: MexBackend) -> Callable[..., RawColoring]:
        raise NotImplementedError

    def oneshot(self, spec: ColoringSpec, g, device: DeviceSpec = None) -> RawColoring:
        """Run once on ``g``: a host :class:`Graph`/``BipartiteGraph`` is
        lowered per ``spec.model`` (wedge by default for d2/pd2 on the
        edges layout, square for the ELL engines) onto ``device``
        (``None`` = the card); a :class:`DeviceGraph` runs where it lies."""
        backend = get_backend(spec.engine)
        if isinstance(g, DeviceGraph) and device is not None \
                and resolve_device(device).type != g.device.type:
            raise ValueError(f"DeviceGraph lies on {g.device}, not on "
                             f"the requested device {device!r}")
        dg = as_constraint_graph(g, spec.model, needs_ell=backend.needs_ell,
                                 strategy=spec.lowering, side=spec.side,
                                 device=device)
        return self.device_program(spec, backend)(dg)

    def plan_state(self, spec: ColoringSpec, statics: "PlanShape",
                   **runtime) -> Tuple:
        """Normalize per-call runtime state (``plan(g, key=value, ...)``)
        into the extra arguments this strategy's program takes. The base
        strategies are stateless — any runtime kwarg is an error; the
        ``"recolor"`` strategy accepts the (colors, seed) warm start."""
        if runtime:
            raise TypeError(
                f"strategy {self.name!r} takes no per-call state; got "
                f"{sorted(runtime)}")
        return ()


_REGISTRY: Dict[str, ColoringStrategy] = {}

StrategySpec = Union[str, ColoringStrategy]


def register_strategy(strategy: ColoringStrategy, *,
                      overwrite: bool = False) -> ColoringStrategy:
    """Register a strategy instance under ``strategy.name``."""
    if strategy.name in _REGISTRY and not overwrite:
        raise ValueError(f"coloring strategy {strategy.name!r} already "
                         "registered")
    _REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(strategy: StrategySpec) -> ColoringStrategy:
    """Resolve ``strategy`` — a registered name or an instance."""
    if isinstance(strategy, ColoringStrategy):
        return strategy
    try:
        return _REGISTRY[strategy]
    except KeyError:
        raise ValueError(
            f"unknown coloring strategy {strategy!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass(frozen=True)
class IterativeStrategy(ColoringStrategy):
    """The paper's Algorithm 2 (speculation + iteration) — iterative.py."""

    name = "iterative"

    def device_program(self, spec, backend):
        from .iterative import _iterative_impl

        def run(dg):
            fcv, fce = resolve_frontier(
                spec.frontier, int(spec.frontier_capacity),
                num_vertices=dg.num_vertices, padded_edges=dg.padded_edges,
                max_degree=dg.max_degree, has_inc=dg.has_frontier)
            colors, rnd, conf, sweeps, fronts, left = _iterative_impl(
                dg, concurrency=int(spec.concurrency),
                max_rounds=int(spec.max_rounds),
                max_sweeps=int(spec.max_sweeps), backend=backend,
                color_bound=int(spec.color_bound),
                frontier_cap_v=fcv, frontier_cap_e=fce)
            return RawColoring(colors, rnd, conf, sweeps, left, fronts)

        return run


@dataclasses.dataclass(frozen=True)
class DataflowStrategy(ColoringStrategy):
    """The paper's Algorithms 3-5 as a chaotic fixpoint — dataflow.py. One
    conflict-free round; ``sweeps_per_round`` holds the DAG-depth sweep
    count."""

    name = "dataflow"

    def device_program(self, spec, backend):
        from .dataflow import _dataflow_impl

        def run(dg):
            fcv, fce = resolve_frontier(
                spec.frontier, int(spec.frontier_capacity),
                num_vertices=dg.num_vertices, padded_edges=dg.padded_edges,
                max_degree=dg.max_degree, has_inc=dg.has_frontier)
            colors, n, changed, nslab = _dataflow_impl(
                dg, max_sweeps=int(spec.max_sweeps), backend=backend,
                color_bound=int(spec.color_bound),
                frontier_cap_v=fcv, frontier_cap_e=fce)
            return RawColoring(colors, 1, np.zeros(1, np.int32),
                               np.array([n], np.int32), changed,
                               np.array([nslab], np.int32))

        return run


@dataclasses.dataclass(frozen=True)
class RecolorStrategy(ColoringStrategy):
    """Detect-and-recolor (Rokos et al., arXiv:1505.04086): the paper's
    speculation loop run from a caller-supplied warm start instead of the
    cold one (no colors, all pending).

    ``plan(g, colors=, seed=)`` hands the program the committed colors and
    the seed mask of vertices to repair (the endpoints of newly
    conflicting edges under streaming deltas; repro_torch.core.dynamic
    builds exactly that). Phase 1 recolors only the seed set, committed
    neighbors forbidding their colors, and round 0 may take the compacted
    frontier path (``seed_frontier``), so a delta repair sweeps the seed's
    slab, not the whole edge list.

    With no state (``color(g, strategy="recolor")``, or a bare
    ``plan(g)``) the warm start is the cold start: colors, rounds and
    conflict history equal ``"iterative"``'s. Both arrays are [V] in the
    plan's vertex ids, so ``ordering`` must stay ``"natural"`` whenever
    state is passed. ``plan.map`` is unsupported (repairs are single
    latency-bound calls)."""

    name = "recolor"
    supports_map = False

    def device_program(self, spec, backend):
        from .iterative import _iterative_impl

        def run(dg, colors0=None, pending0=None):
            fcv, fce = resolve_frontier(
                spec.frontier, int(spec.frontier_capacity),
                num_vertices=dg.num_vertices, padded_edges=dg.padded_edges,
                max_degree=dg.max_degree, has_inc=dg.has_frontier)
            colors, rnd, conf, sweeps, fronts, left = _iterative_impl(
                dg, colors0, pending0, concurrency=int(spec.concurrency),
                max_rounds=int(spec.max_rounds),
                max_sweeps=int(spec.max_sweeps), backend=backend,
                color_bound=int(spec.color_bound),
                frontier_cap_v=fcv, frontier_cap_e=fce,
                seed_frontier=True)
            return RawColoring(colors, rnd, conf, sweeps, left, fronts)

        return run

    def plan_state(self, spec, statics, colors=None, seed=None):
        """Host arrays ``(colors [V] int32, seed [V] bool)``: no colors is
        all zeros, no seed is all pending."""
        if (colors is not None or seed is not None) \
                and spec.ordering != "natural":
            # cold starts are ordering-invariant (the plan relabels and
            # un-relabels as usual); only a WARM start pins vertex ids
            raise ValueError(
                "recolor repairs an existing coloring in place: state "
                "arrays are in plan vertex ids, so ordering must be "
                "'natural' (got {!r})".format(spec.ordering))
        V = statics.num_vertices
        if colors is None:
            colors = np.zeros((V,), np.int32)
        else:
            colors = np.asarray(colors)
            if colors.shape != (V,):
                raise ValueError(f"recolor state: colors shape "
                                 f"{colors.shape} != ({V},)")
            colors = colors.astype(np.int32)
        if seed is None:
            seed = np.ones((V,), np.bool_)
        else:
            seed = np.asarray(seed)
            if seed.shape != (V,):
                raise ValueError(f"recolor state: seed shape "
                                 f"{seed.shape} != ({V},)")
            seed = seed.astype(np.bool_)
        return colors, seed


register_strategy(IterativeStrategy())
register_strategy(DataflowStrategy())
register_strategy(RecolorStrategy())


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanShape:
    """The static envelope a :class:`ColoringPlan` specializes on, in
    *constraint-graph* space (after the d2/pd2 lowering, where applicable).

    num_vertices   exact vertex count every served graph must match;
    padded_edges   directed-edge capacity (graphs pad up to it);
    max_degree     max-degree bound: sizes the table backends' color
                   capacity and the ELL slab width. Graphs above it are
                   rejected (a too-small table silently drops forbids).
    """

    num_vertices: int
    padded_edges: int
    max_degree: int


def _plan_shape(spec: ColoringSpec, graph_or_shape) -> PlanShape:
    if isinstance(graph_or_shape, PlanShape):
        return graph_or_shape
    if not isinstance(graph_or_shape, (Graph, BipartiteGraph)):
        raise TypeError(
            "compile_plan needs a host Graph/BipartiteGraph (plans lower, "
            "relabel and pad on host) or an explicit PlanShape")
    host = constraint_host_graph(graph_or_shape, spec.model, side=spec.side)
    return PlanShape(num_vertices=host.num_vertices,
                     padded_edges=pad_bucket(host.num_directed_edges),
                     max_degree=host.max_degree())


class ColoringPlan:
    """A built coloring program: spec + static shape envelope + device,
    serving any same-bucket graph with the same program.

    ``plan(graph, **runtime)`` -> :class:`ColoringReport` (``runtime`` is
    per-call state for strategies that take it: ``"recolor"``'s
    ``colors=``/``seed=``);
    ``plan.map([g0, g1, ...])`` -> one report per graph (strategies with
    ``supports_map``). In this port
    ``map`` runs the plan's program once per graph (reports as the
    reference's vmapped ``map`` returns them, wall time amortized over the
    batch); a batched program is later work (ROADMAP A16).

    ``plan.traces`` counts program builds. The program is built at the
    first call and pinned to the envelope: every served graph is laid out
    with the same shapes and static fields, so the count stays at 1 however
    many same-bucket graphs are served (``map`` included); the tests pin
    this.
    """

    def __init__(self, spec: ColoringSpec, graph_or_shape,
                 device: DeviceSpec = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.strategy, self._backend = spec.resolve()
        self.statics = _plan_shape(spec, graph_or_shape)
        if spec.ordering not in ORDERINGS:
            raise ValueError(f"unknown ordering {spec.ordering!r}; "
                             f"choose from {sorted(ORDERINGS)}")
        # a degenerate envelope never builds or runs a program: every
        # served graph is vacuously colored with color 1
        self._degenerate = (self.statics.num_vertices == 0
                            or self.statics.padded_edges == 0)
        self._program: Optional[Callable[[DeviceGraph], RawColoring]] = None

    @property
    def traces(self) -> int:
        """Number of program builds taken by this plan (0 or 1)."""
        return int(self._program is not None)

    def _run(self, dg: DeviceGraph, *state) -> RawColoring:
        if self._program is None:
            self._program = self.strategy.device_program(self.spec,
                                                         self._backend)
        return self._program(dg, *state)

    def _canonicalize(self, g) -> Tuple[DeviceGraph, Optional[np.ndarray]]:
        """Host graph -> (canonical DeviceGraph, relabel perm or None):
        lower the model (square lowering: paddable, dedup'd), apply the
        ordering relabel, pad edges to the bucket, and pin the static
        DeviceGraph fields to the plan envelope so every served graph has
        the same static signature."""
        spec, st = self.spec, self.statics
        host = constraint_host_graph(g, spec.model, side=spec.side)
        if host.num_vertices != st.num_vertices:
            raise ValueError(
                f"plan compiled for {st.num_vertices} vertices, got a graph "
                f"with {host.num_vertices}; compile a new plan")
        perm = None
        if spec.ordering != "natural":
            perm = _invert_order(ORDERINGS[spec.ordering](host,
                                                          spec.ordering_seed))
            host = host.relabel(perm)
        if host.num_directed_edges > st.padded_edges:
            raise ValueError(
                f"graph has {host.num_directed_edges} constraint edges, "
                f"above the plan bucket {st.padded_edges}; compile a plan "
                "from this graph (or a larger PlanShape)")
        if host.max_degree() > st.max_degree:
            raise ValueError(
                f"graph max degree {host.max_degree()} exceeds the plan "
                f"bound {st.max_degree}; compile a plan with a larger "
                "PlanShape.max_degree (the color tables would drop forbids)")
        layout = ("edges", "ell") if self._backend.needs_ell else "edges"
        dg = host.to_device(layout=layout, pad_edges_to=st.padded_edges,
                            ell_width=max(1, st.max_degree),
                            device=self.device)
        # the envelope bound sizes the color tables exactly as correctly
        # as the per-graph value, and keeps the signature constant
        dg = dataclasses.replace(dg, num_directed_edges=st.padded_edges,
                                 max_degree=st.max_degree)
        return dg, perm

    def __call__(self, g, **runtime) -> ColoringReport:
        """Color ``g`` through the plan's program. ``runtime`` kwargs are
        per-call state for strategies that take it (``"recolor"``:
        ``colors=``, ``seed=``); stateless strategies reject any."""
        t0 = time.perf_counter()
        canon, perm = self._canonicalize(g)
        state = self.strategy.plan_state(self.spec, self.statics, **runtime)
        if self._degenerate:
            # nothing to run, but a recolor warm start keeps its committed
            # colors (non-seed vertices never change)
            return _trivial_report(self.spec, self.statics.num_vertices, t0,
                                   colors=runtime.get("colors"))
        return _build_report(self._run(canon, *state), self.spec,
                             self.strategy.name, perm, t0)

    def map(self, graphs: Sequence) -> list:
        """Color a batch of same-bucket graphs; one report per graph
        (original vertex ids, per-graph histories, wall time amortized
        over the batch)."""
        if not self.strategy.supports_map:
            raise NotImplementedError(
                f"strategy {self.strategy.name!r} does not support batched "
                "plan.map execution")
        graphs = list(graphs)
        if not graphs:
            return []
        t0 = time.perf_counter()
        canons = [self._canonicalize(g) for g in graphs]
        if self._degenerate:
            return [_trivial_report(self.spec, self.statics.num_vertices,
                                    t0, batch_denom=len(graphs))
                    for _ in graphs]
        raws = [(self._run(dg), perm) for dg, perm in canons]
        return [_build_report(raw, self.spec, self.strategy.name, perm, t0,
                              batch_denom=len(graphs))
                for raw, perm in raws]


def compile_plan(spec: ColoringSpec, graph_or_shape,
                 device: DeviceSpec = None) -> ColoringPlan:
    """Build ``spec`` against a host graph (or an explicit
    :class:`PlanShape`) into a reusable :class:`ColoringPlan` on ``device``
    (``None`` = the card).

    From a graph, the envelope is read off its *constraint* form (the
    square lowering under d2/pd2): the vertex count, the directed-edge
    count rounded up the :func:`pad_bucket` grid, and the max degree. Any
    later graph inside the envelope is served by the same program."""
    return ColoringPlan(spec, graph_or_shape, device)


# --------------------------------------------------------------------------
# one-shot front door
# --------------------------------------------------------------------------
def color(g, spec: Optional[ColoringSpec] = None, device: DeviceSpec = None,
          **overrides) -> ColoringReport:
    """One-shot front door: ``color(graph, spec)`` or
    ``color(graph, strategy="dataflow", model="d2", ...)`` on ``device``
    (``None`` = the card; a DeviceGraph runs where it lies).

    Resolves the spec, applies the ordering to the constraint graph
    (relabel in, un-relabel out), runs the strategy and returns a
    :class:`ColoringReport`."""
    spec = ColoringSpec() if spec is None else spec
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    if not isinstance(g, DeviceGraph):
        resolve_device(device)
    strategy = get_strategy(spec.strategy)
    if spec.ordering not in ORDERINGS:
        raise ValueError(f"unknown ordering {spec.ordering!r}; "
                         f"choose from {sorted(ORDERINGS)}")
    t0 = time.perf_counter()
    num_colored, num_edges = _graph_extent(g, spec)
    if num_colored == 0 or num_edges == 0:
        # degenerate input: nothing constrains anything — color 1
        # everywhere is valid under every model, and no engine runs
        return _trivial_report(spec, num_colored, t0)
    perm = None
    if spec.ordering != "natural":
        if isinstance(g, DeviceGraph):
            raise ValueError(
                "ordering != 'natural' relabels on host: pass a Graph/"
                "BipartiteGraph (or pre-apply repro_torch.core.ordering.apply)")
        host = constraint_host_graph(g, spec.model, side=spec.side)
        perm = _invert_order(ORDERINGS[spec.ordering](host,
                                                      spec.ordering_seed))
        # the constraint graph IS the d1 encoding of the model
        raw = strategy.oneshot(dataclasses.replace(spec, model="d1"),
                               host.relabel(perm), device)
    else:
        raw = strategy.oneshot(spec, g, device)
    return _build_report(raw, spec, strategy.name, perm, t0)
