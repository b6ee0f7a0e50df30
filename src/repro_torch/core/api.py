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
(Alg. 3-5), ``"distributed"`` (the BSP round loop over the ranks of a
``ProcessMesh``, one process per shard: ``repro_torch.core.distributed``)
and ``"recolor"`` (the ITERATIVE loop from a warm start, the streaming
repair), under models ``"d1"``, ``"d2"`` and ``"pd2"``
(``repro_torch.core.distance2`` lowers the last two into the engine's edge
space). A distributed spec runs on its mesh's device.

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

from ..kernels.ops import request_ids, span
from .distance2 import MODELS, as_constraint_graph, constraint_host_graph
from .engine import EngineSpec, MexBackend, get_backend
from .distributed import PARTITION_SCHEMES, ProcessMesh
from .frontier import (FRONTIER_MODES, frontier_capacities,
                       resolve_frontier)
from .graph import (BipartiteGraph, DeviceGraph, DeviceSpec, Graph,
                    pad_bucket, resolve_device, stack_device_graphs)
from .ordering import ORDERINGS

_LOWERINGS = ("auto", "wedge", "square")
WIRE_MODES = ("auto", "boundary", "full")


# --------------------------------------------------------------------------
# the spec
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ColoringSpec:
    """Declarative description of a coloring run — the reference's fields
    and registry names, so one ``to_dict()`` means the same to both
    packages.

    strategy     registered :class:`ColoringStrategy` name (or instance):
                 ``"iterative"`` | ``"dataflow"`` | ``"distributed"`` |
                 ``"recolor"``;
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
    mesh         the :class:`repro_torch.core.distributed.ProcessMesh` of
                 the distributed strategy (None = one shard, no group);
    local_concurrency  distributed per-rank concurrency (C=1 is the
                 classic Bozdag scheme);
    frontier     active-set execution: ``"auto"`` | ``"on"`` | ``"off"``
                 (bit-identical results either way);
    frontier_capacity  static vertex-slab capacity override (0 = ladder);
    wire         the distributed round exchange: ``"auto"`` (boundary
                 wire; a plan whose served graph overflows its halo
                 capacity spills to a full-wire program built on demand),
                 ``"boundary"`` (halo overflow raises) or ``"full"``; all
                 three give the same result;
    partition    distributed vertex ownership: ``"1d"`` blocks or ``"2d"``
                 block-cyclic over a rank grid.
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
    mesh: Optional[ProcessMesh] = None
    local_concurrency: int = 1
    frontier: str = "auto"
    frontier_capacity: int = 0
    wire: str = "auto"
    partition: str = "1d"

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"unknown coloring model {self.model!r}; "
                             f"choose from {MODELS}")
        if self.lowering not in _LOWERINGS:
            raise ValueError(f"unknown lowering {self.lowering!r}; "
                             f"choose from {_LOWERINGS}")
        if self.frontier not in FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode {self.frontier!r}; "
                             f"choose from {FRONTIER_MODES}")
        if self.wire not in WIRE_MODES:
            raise ValueError(f"unknown wire mode {self.wire!r}; "
                             f"choose from {WIRE_MODES}")
        if self.partition not in PARTITION_SCHEMES:
            raise ValueError(f"unknown partition scheme {self.partition!r}; "
                             f"choose from {PARTITION_SCHEMES}")

    def resolve(self) -> Tuple["ColoringStrategy", MexBackend]:
        """Resolve the registered pieces (strategy, mex backend) by name."""
        return get_strategy(self.strategy), get_backend(self.engine)

    def to_dict(self) -> dict:
        """JSON-able export (the reference's format): every field by
        registry *name*. Mesh-bound specs are process-local (process
        groups don't serialize) and are rejected."""
        if self.mesh is not None:
            raise ValueError(
                "mesh-bound specs are process-local and cannot be "
                "serialized; rebuild the spec with the restoring "
                "process's mesh instead")
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "mesh"}
        if not isinstance(d["strategy"], str):
            d["strategy"] = get_strategy(d["strategy"]).name
        if not isinstance(d["engine"], str):
            d["engine"] = get_backend(d["engine"]).name
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ColoringSpec":
        """Inverse of :meth:`to_dict` (and of the reference's); unknown
        keys are rejected by the constructor, so a stale checkpoint fails
        loudly."""
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
    with span("sync.colors"):
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
    feeds it per-call state through :meth:`plan_state`, and builds
    ``plan.map``'s program through :meth:`compile_batched`. Host-level
    strategies (the distributed strategy partitions on the host) override
    :meth:`oneshot` and :meth:`compile` instead and set ``wants = "host"``.
    """

    name = "abstract"
    supports_map = True    # plan.map() serves a batch
    wants = "device"       # "device": the plan hands the program a
                           # DeviceGraph; "host": the host constraint Graph

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

    def compile(self, spec: ColoringSpec, statics: "PlanShape",
                device: torch.device,
                trace_hook: Callable[[], None]) -> Callable:
        """Plan-time build of a host strategy: returns the executor
        ``host Graph -> RawColoring``; ``trace_hook`` runs once per program
        the executor builds (the plan counts them)."""
        raise NotImplementedError(
            f"strategy {self.name!r} consumes a DeviceGraph; plans build "
            "its device_program")

    def compile_batched(self, spec: ColoringSpec, statics: "PlanShape",
                        trace_hook: Callable[[], None]) -> Callable:
        """The ``plan.map`` program: canonical DeviceGraphs of one
        envelope -> one :class:`RawColoring` per graph. ``trace_hook`` runs
        once, when the program is built (the plan counts it). The
        reference vmaps :meth:`device_program`; this default serves the
        batch with it graph by graph, and ``"iterative"`` and
        ``"dataflow"`` override it with one batched program."""
        trace_hook()
        prog = self.device_program(spec, get_backend(spec.engine))
        return lambda graphs: [prog(dg) for dg in graphs]


def _iterative_program(spec: ColoringSpec, backend: MexBackend,
                       seed_frontier: bool = False) -> Callable:
    """``(graphs[, colors0, pending0]) -> [RawColoring]``: the round loop
    of iterative.py over the stack of same-envelope DeviceGraphs (one
    graph is a batch of one); the warm start is ``[B, V]`` or, for one
    graph, ``[V]``."""
    from .iterative import _iterative_impl

    def run(graphs, colors0=None, pending0=None):
        bg = stack_device_graphs(graphs)
        fcv, fce = _frontier_caps(spec, bg)
        colors, rnd, conf, sweeps, fronts, left = _iterative_impl(
            bg, colors0, pending0, concurrency=int(spec.concurrency),
            max_rounds=int(spec.max_rounds),
            max_sweeps=int(spec.max_sweeps), backend=backend,
            color_bound=int(spec.color_bound),
            frontier_cap_v=fcv, frontier_cap_e=fce,
            seed_frontier=seed_frontier)
        return [RawColoring(colors[b], int(rnd[b]), conf[b], sweeps[b],
                            bool(left[b]), fronts[b])
                for b in range(bg.batch)]

    return run


def _dataflow_program(spec: ColoringSpec, backend: MexBackend) -> Callable:
    """``graphs -> [RawColoring]``: the fixpoint of dataflow.py over the
    stack of same-envelope DeviceGraphs (one graph is a batch of one)."""
    from .dataflow import _dataflow_impl

    def run(graphs):
        bg = stack_device_graphs(graphs)
        fcv, fce = _frontier_caps(spec, bg)
        colors, n, changed, nslab = _dataflow_impl(
            bg, max_sweeps=int(spec.max_sweeps), backend=backend,
            color_bound=int(spec.color_bound),
            frontier_cap_v=fcv, frontier_cap_e=fce)
        return [RawColoring(colors[b], 1, np.zeros(1, np.int32),
                            np.array([n[b]], np.int32), bool(changed[b]),
                            np.array([nslab[b]], np.int32))
                for b in range(bg.batch)]

    return run


def _frontier_caps(spec: ColoringSpec, g) -> Tuple[int, int]:
    """The static frontier slab capacities of ``spec`` on a graph's
    envelope (a BatchedGraph's is each member's)."""
    return resolve_frontier(
        spec.frontier, int(spec.frontier_capacity),
        num_vertices=g.num_vertices, padded_edges=g.padded_edges,
        max_degree=g.max_degree, has_inc=g.has_frontier)


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
        prog = _iterative_program(spec, backend)
        return lambda dg: prog([dg])[0]

    def compile_batched(self, spec, statics, trace_hook):
        """One batched round loop over the stacked graphs."""
        trace_hook()
        return _iterative_program(spec, get_backend(spec.engine))


@dataclasses.dataclass(frozen=True)
class DataflowStrategy(ColoringStrategy):
    """The paper's Algorithms 3-5 as a chaotic fixpoint — dataflow.py. One
    conflict-free round; ``sweeps_per_round`` holds the DAG-depth sweep
    count."""

    name = "dataflow"

    def device_program(self, spec, backend):
        prog = _dataflow_program(spec, backend)
        return lambda dg: prog([dg])[0]

    def compile_batched(self, spec, statics, trace_hook):
        """One batched sweep loop over the stacked graphs."""
        trace_hook()
        return _dataflow_program(spec, get_backend(spec.engine))


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
        prog = _iterative_program(spec, backend, seed_frontier=True)
        return lambda dg, colors0=None, pending0=None: prog(
            [dg], colors0, pending0)[0]

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


@dataclasses.dataclass(frozen=True)
class DistributedStrategy(ColoringStrategy):
    """The Bozdag-style BSP coloring over the ranks of a process mesh —
    distributed.py. A host strategy: every rank partitions the constraint
    graph itself, so plans hand it the host graph. ``plan.map`` is
    unsupported (one mesh program is already the batch)."""

    name = "distributed"
    supports_map = False
    wants = "host"

    @staticmethod
    def _mesh(spec: ColoringSpec, device: DeviceSpec = None) -> ProcessMesh:
        return spec.mesh if spec.mesh is not None else ProcessMesh(None, device)

    def _build(self, spec: ColoringSpec, mesh: ProcessMesh, *,
               verts_local: int, edges_local: int, max_colors: int,
               ell_width: int, wire: str = "boundary", wire_colors: int = 0):
        from .distributed import build_distributed_coloring
        fcv = fce = 0
        if spec.frontier != "off":
            # per-shard slabs: the round loop recovers incident-edge
            # pointers on the device, so the frontier is always available
            fcv, fce = frontier_capacities(
                verts_local, edges_local, ell_width,
                capacity=int(spec.frontier_capacity))
        return build_distributed_coloring(
            mesh, verts_local, edges_local,
            local_concurrency=int(spec.local_concurrency),
            max_rounds=int(spec.max_rounds),
            max_sweeps=int(spec.max_sweeps),
            engine=spec.engine, max_colors=max_colors, ell_width=ell_width,
            frontier_cap_v=fcv, frontier_cap_e=fce,
            wire=wire, wire_colors=wire_colors)

    @staticmethod
    def _max_colors(spec: ColoringSpec, max_degree: int) -> int:
        max_colors = max_degree + 1
        if spec.color_bound > 0:
            max_colors = min(max_colors, int(spec.color_bound))
        return max_colors

    def _raw(self, spec: ColoringSpec, layout, out) -> RawColoring:
        colors, rounds, conf, sweeps, fronts = out
        colors = layout.unpermute(colors.cpu().numpy())
        unconverged = bool(rounds >= int(spec.max_rounds)
                           and rounds > 0 and conf[rounds - 1] > 0)
        return RawColoring(torch.from_numpy(colors), rounds, conf, sweeps,
                           unconverged, fronts)

    def oneshot(self, spec, g, device=None) -> RawColoring:
        from .distributed import partition_graph
        if isinstance(g, DeviceGraph):
            raise TypeError("the distributed strategy partitions on the "
                            "host: pass a Graph/BipartiteGraph")
        host = constraint_host_graph(g, spec.model, side=spec.side)
        mesh = self._mesh(spec, device)
        layout = partition_graph(host, mesh.num_devices,
                                 scheme=spec.partition)
        # one-shot slabs fit the graph exactly, so "auto" never spills
        wire = "full" if spec.wire == "full" else "boundary"
        fn = self._build(spec, mesh, verts_local=layout.verts_local,
                         edges_local=layout.edges_local,
                         max_colors=self._max_colors(spec, host.max_degree()),
                         ell_width=host.max_degree(), wire=wire,
                         wire_colors=host.max_degree() + 1)
        return self._raw(spec, layout,
                         fn(layout.lsrc, layout.ldst, layout.bnd))

    def compile(self, spec, statics, device, trace_hook):
        from .distributed import partition_graph
        mesh = self._mesh(spec, device)
        D = mesh.num_devices
        Vl = -(-statics.num_vertices // D)
        # slab capacity: even-split share + R-MAT-skew headroom, bucketed;
        # a graph whose densest partition overflows it raises at call time
        slab = pad_bucket(int(-(-statics.padded_edges // D) * 1.35))
        use_boundary = spec.wire != "full"
        # wire_colors is the UNCAPPED Delta+1: packed entries must hold any
        # color the solve can assign; color_bound caps only the tables
        bcap = int(statics.boundary_cap) if use_boundary else 0
        kw = dict(verts_local=Vl, edges_local=slab,
                  max_colors=self._max_colors(spec, statics.max_degree),
                  ell_width=statics.max_degree,
                  wire_colors=statics.max_degree + 1)
        programs: Dict[str, Callable] = {}

        def program(wire: str) -> Callable:
            # built at its first call, counted once; the spill program
            # (wire="auto" halo overflow) is built only if a graph needs it
            if wire not in programs:
                trace_hook()
                programs[wire] = self._build(spec, mesh, wire=wire, **kw)
            return programs[wire]

        def executor(host: Graph) -> RawColoring:
            layout = partition_graph(host, D, pad_edges_to=slab,
                                     scheme=spec.partition)
            # the full wire never reads bnd: a fixed [D, 1] dummy
            dummy = np.full((D, 1), layout.verts_local, np.int32)
            if not use_boundary:
                run, bnd = program("full"), dummy
            elif layout.boundary_local <= bcap:
                run, bnd = program("boundary"), layout.padded_boundary(bcap)
            elif spec.wire == "boundary":
                raise ValueError(
                    f"graph has {layout.boundary_local} boundary vertices "
                    f"on its densest shard, above the plan halo capacity "
                    f"{bcap}; compile a plan from this graph, or use "
                    "wire='auto' to spill to the full-gather wire")
            else:
                run, bnd = program("full"), dummy
            return self._raw(spec, layout, run(layout.lsrc, layout.ldst, bnd))

        return executor


register_strategy(IterativeStrategy())
register_strategy(DataflowStrategy())
register_strategy(DistributedStrategy())
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
                   rejected (a too-small table silently drops forbids);
    boundary_cap   distributed halo capacity: the per-shard boundary slab
                   width the plan's boundary wire pins (``_plan_shape``
                   derives it, with headroom, by partitioning the compile
                   graph). 0 = no halo slab — right for device-strategy
                   plans and one-shard meshes; a served graph overflowing
                   it spills to the full wire (``wire="auto"``) or is
                   rejected (``wire="boundary"``).
    """

    num_vertices: int
    padded_edges: int
    max_degree: int
    boundary_cap: int = 0


def _plan_shape(spec: ColoringSpec, graph_or_shape) -> PlanShape:
    if isinstance(graph_or_shape, PlanShape):
        return graph_or_shape
    if not isinstance(graph_or_shape, (Graph, BipartiteGraph)):
        raise TypeError(
            "compile_plan needs a host Graph/BipartiteGraph (plans lower, "
            "relabel and pad on host) or an explicit PlanShape")
    host = constraint_host_graph(graph_or_shape, spec.model, side=spec.side)
    boundary_cap = 0
    D = spec.mesh.num_devices if spec.mesh is not None else 1
    if get_strategy(spec.strategy).wants == "host" and spec.wire != "full" \
            and D > 1:
        # halo envelope of the boundary wire: partition the compile graph
        # and give the densest shard's boundary count the edge slab's skew
        # headroom, capped at Vl (every vertex boundary)
        from .distributed import partition_graph
        Bl = partition_graph(host, D, scheme=spec.partition).boundary_local
        if Bl:
            Vl = -(-host.num_vertices // D)
            boundary_cap = min(Vl, pad_bucket(int(Bl * 1.35)))
    return PlanShape(num_vertices=host.num_vertices,
                     padded_edges=pad_bucket(host.num_directed_edges),
                     max_degree=host.max_degree(),
                     boundary_cap=boundary_cap)


class ColoringPlan:
    """A built coloring program: spec + static shape envelope + device,
    serving any same-bucket graph with the same program.

    ``plan(graph, **runtime)`` -> :class:`ColoringReport` (``runtime`` is
    per-call state for strategies that take it: ``"recolor"``'s
    ``colors=``/``seed=``);
    ``plan.map([g0, g1, ...])`` -> one report per graph (strategies with
    ``supports_map``), through ONE batched program
    (:meth:`ColoringStrategy.compile_batched`): the graphs are stacked into
    one block-diagonal :class:`repro_torch.core.graph.BatchedGraph` and
    each sweep launches each kernel once for the whole batch. Reports
    equal the reference's vmapped ``map`` (and the per-graph calls); wall
    time is amortized over the batch.

    ``plan.findings`` holds the analyzer's findings when
    ``compile_plan(verify=...)`` built the plan (None otherwise).

    ``plan.traces`` counts program builds. Each program is built at its
    first use and pinned to the envelope: every served graph is laid out
    with the same shapes and static fields, so the count stays at 1 however
    many same-bucket graphs are served, and at 2 once ``map`` has built the
    batched program too, whatever the batch sizes (the reference's jit
    traces once per batch size); the tests pin this. A distributed
    ``wire="auto"`` plan builds its full-wire spill program once, the
    first time a served graph overflows the halo capacity (2 builds).
    """

    def __init__(self, spec: ColoringSpec, graph_or_shape,
                 device: DeviceSpec = None):
        self.spec = spec
        self.device = resolve_device(_spec_device(spec, device))
        self.strategy, self._backend = spec.resolve()
        self.statics = _plan_shape(spec, graph_or_shape)
        if spec.ordering not in ORDERINGS:
            raise ValueError(f"unknown ordering {spec.ordering!r}; "
                             f"choose from {sorted(ORDERINGS)}")
        # a degenerate envelope never builds or runs a program: every
        # served graph is vacuously colored with color 1
        self._degenerate = (self.statics.num_vertices == 0
                            or self.statics.padded_edges == 0)
        self._traces = 0
        # what compile_plan(verify=...) found (None: not verified)
        self.findings: Optional[list] = None
        self._program: Optional[Callable[[DeviceGraph], RawColoring]] = None
        self._batched: Optional[Callable] = None
        self._executor: Optional[Callable] = None
        if self.strategy.wants == "host" and not self._degenerate:
            self._executor = self.strategy.compile(
                spec, self.statics, self.device, self._count_trace)

    def _count_trace(self):
        self._traces += 1

    @property
    def traces(self) -> int:
        """Number of program builds taken by this plan."""
        return self._traces

    def _run(self, canon, *state) -> RawColoring:
        with span("plan.run"):
            if self._executor is not None:
                return self._executor(canon, *state)
            if self._program is None:
                self._count_trace()
                self._program = self.strategy.device_program(self.spec,
                                                             self._backend)
            return self._program(canon, *state)

    def _canonicalize(self, g) -> Tuple[object, Optional[np.ndarray]]:
        """Host graph -> (canonical input, relabel perm or None): lower the
        model (square lowering: paddable, dedup'd), apply the ordering
        relabel, and — for device strategies — pad edges to the bucket and
        pin the static DeviceGraph fields to the plan envelope so every
        served graph has the same static signature. Host strategies get the
        checked host constraint graph. One graph's layout is the span
        ``plan.layout``, carrying its request's id."""
        spec, st = self.spec, self.statics
        with span("plan.layout", request=request_ids(1)):
            with span("layout.lower"):
                host = constraint_host_graph(g, spec.model, side=spec.side)
                if host.num_vertices != st.num_vertices:
                    raise ValueError(
                        f"plan compiled for {st.num_vertices} vertices, got "
                        f"a graph with {host.num_vertices}; compile a new "
                        "plan")
                perm = None
                if spec.ordering != "natural":
                    perm = _invert_order(ORDERINGS[spec.ordering](
                        host, spec.ordering_seed))
                    host = host.relabel(perm)
                if host.num_directed_edges > st.padded_edges:
                    raise ValueError(
                        f"graph has {host.num_directed_edges} constraint "
                        f"edges, above the plan bucket {st.padded_edges}; "
                        "compile a plan from this graph (or a larger "
                        "PlanShape)")
                if host.max_degree() > st.max_degree:
                    raise ValueError(
                        f"graph max degree {host.max_degree()} exceeds the "
                        f"plan bound {st.max_degree}; compile a plan with a "
                        "larger PlanShape.max_degree (the color tables "
                        "would drop forbids)")
            if self.strategy.wants == "host":
                return host, perm
            layout = ("edges", "ell") if self._backend.needs_ell else "edges"
            dg = host.to_device(layout=layout, pad_edges_to=st.padded_edges,
                                ell_width=max(1, st.max_degree),
                                device=self.device)
        # the envelope bound sizes the color tables exactly as correctly
        # as the per-graph value, and keeps the signature constant
        dg = dataclasses.replace(dg, num_directed_edges=st.padded_edges,
                                 max_degree=st.max_degree)
        return dg, perm

    def wire_cost(self) -> Optional[dict]:
        """The closed-form bytes-on-wire cost table for this plan's
        envelope (distributed plans only; ``None`` otherwise): the same
        per-tier accounting the SPMD verifier holds recorded runs against
        (``repro_torch.analysis.wirecost``) —
        ``{"tiers": {"halo": {...}, "setup": {...}, ...}, ...}`` keyed by
        the plan's resolved wire, with the formula strings beside the
        numbers. The final colors gather is the program's output and is
        not priced."""
        if self.strategy.wants != "host":
            return None
        from ..analysis.wirecost import wire_cost_table
        return wire_cost_table(self.spec, self.statics)

    def __call__(self, g, **runtime) -> ColoringReport:
        """Color ``g`` through the plan's program. ``runtime`` kwargs are
        per-call state for strategies that take it (``"recolor"``:
        ``colors=``, ``seed=``); stateless strategies reject any."""
        t0 = time.perf_counter()
        with span("plan.call", request=request_ids(1)):
            canon, perm = self._canonicalize(g)
            state = self.strategy.plan_state(self.spec, self.statics,
                                             **runtime)
            if self._degenerate:
                # nothing to run, but a recolor warm start keeps its
                # committed colors (non-seed vertices never change)
                return _trivial_report(self.spec,
                                       self.statics.num_vertices, t0,
                                       colors=runtime.get("colors"))
            return _build_report(self._run(canon, *state), self.spec,
                                 self.strategy.name, perm, t0)

    def map(self, graphs: Sequence) -> list:
        """Color a batch of same-bucket graphs through ONE call of the
        plan's batched program (built at the first ``map``, for any batch
        size); one report per graph (original vertex ids, per-graph
        histories, wall time amortized over the batch)."""
        if not self.strategy.supports_map:
            raise NotImplementedError(
                f"strategy {self.strategy.name!r} does not support batched "
                "plan.map execution")
        graphs = list(graphs)
        if not graphs:
            return []
        t0 = time.perf_counter()
        with span("plan.map", request=request_ids(len(graphs))):
            canons, perms = zip(*(self._canonicalize(g) for g in graphs))
            if self._degenerate:
                return [_trivial_report(self.spec,
                                        self.statics.num_vertices, t0,
                                        batch_denom=len(graphs))
                        for _ in graphs]
            if self._batched is None:
                self._batched = self.strategy.compile_batched(
                    self.spec, self.statics, self._count_trace)
            with span("plan.run"):
                raws = self._batched(list(canons))
            return [_build_report(raw, self.spec, self.strategy.name, perm,
                                  t0, batch_denom=len(graphs))
                    for raw, perm in zip(raws, perms)]


def _spec_device(spec: ColoringSpec, device: DeviceSpec) -> DeviceSpec:
    """The device a spec runs on: a mesh-bound spec runs on its mesh's
    device, and a ``device=`` of another type is refused."""
    if spec.mesh is None:
        return device
    if device is not None and torch.device(device).type != spec.mesh.device.type:
        raise ValueError(f"device={device!r}, but the spec's mesh runs on "
                         f"{spec.mesh.device}")
    return spec.mesh.device


def compile_plan(spec: ColoringSpec, graph_or_shape,
                 device: DeviceSpec = None,
                 verify: Optional[str] = None) -> ColoringPlan:
    """Build ``spec`` against a host graph (or an explicit
    :class:`PlanShape`) into a reusable :class:`ColoringPlan` on ``device``
    (``None`` = the card).

    From a graph, the envelope is read off its *constraint* form (the
    square lowering under d2/pd2): the vertex count, the directed-edge
    count rounded up the :func:`pad_bucket` grid, and the max degree. Any
    later graph inside the envelope is served by the same program.

    ``verify`` runs the :mod:`repro_torch.analysis` static analyzer over
    the plan before returning it: ``"warn"`` emits a Python warning for
    any finding the committed baseline does not cover, ``"error"`` raises
    :class:`repro_torch.analysis.AnalysisError` instead (anything else
    raises ``ValueError``). The analyzer records the plan's program on the
    given graph (or on seeded graphs inside a ``PlanShape``), on the plan's
    device; distributed plans also run the SPMD verifier over every rank's
    recordings, so every rank of the mesh must compile together."""
    if verify is not None and verify not in ("warn", "error"):
        raise ValueError(f'verify must be None, "warn" or "error", '
                         f'got {verify!r}')
    plan = ColoringPlan(spec, graph_or_shape, device)
    if verify is not None:
        from ..analysis import verify_plan
        plan.findings = verify_plan(
            spec, plan.statics, mode=verify, device=plan.device,
            graph=(None if isinstance(graph_or_shape, PlanShape)
                   else graph_or_shape))
    return plan


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
    device = _spec_device(spec, device)
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
