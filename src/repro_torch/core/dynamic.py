"""Streaming/dynamic coloring: edge-delta batches as frontier seeds
(PyTorch port of ``repro.core.dynamic``).

The paper's speculation loop (Alg. 2) is already an incremental repair:
each round recolors only the conflicted vertices. Rokos et al.
(arXiv:1505.04086) make detect-and-recolor over the conflicted frontier the
scalable core of the method. Here an edge-delta batch is just another
frontier seed.

:class:`DynamicColoring` holds a live (graph, coloring) pair and applies
insert/delete batches incrementally:

* **deletes** only relax constraints — the coloring stays valid untouched
  (they may leave palette gaps, which is why ``num_colors`` counts
  distinct colors);
* **inserts** can create monochromatic edges — exactly the paper's phase-2
  conflicts. Their endpoints become the pending seed of a ``"recolor"``
  run (:class:`repro_torch.core.api.RecolorStrategy`), which warm-starts
  the ITERATIVE round loop from (committed colors, seed mask) and lets
  round 0 take the compacted frontier path.

The state rides a :class:`repro_torch.core.api.ColoringPlan` built against
a headroomed envelope on the :func:`repro_torch.core.graph.pad_bucket`
ladder, so every batch inside the envelope reuses ONE program
(``plan.traces`` stays 1); a batch that outgrows it rebuilds the plan
against a larger bucket (counted in ``recompiles``). The colors stay a
host numpy array between batches.

Color quality is bounded, not exact: every color ever assigned is a mex
over a live neighborhood, hence at most ``max_degree_seen + 1``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .api import ColoringPlan, ColoringReport, ColoringSpec, PlanShape, \
    compile_plan, get_strategy
from .graph import DeviceSpec, Graph, pad_bucket, resolve_device


@dataclasses.dataclass
class DeltaReport:
    """What one :meth:`DynamicColoring.apply_batch` did.

    inserted / deleted count *effective* edge changes (set semantics).
    ``seed_size`` is the number of vertices seeded for repair (endpoints of
    newly monochromatic edges); ``report`` the repair's
    :class:`repro_torch.core.api.ColoringReport`, or ``None`` when the batch
    created no conflicts. ``wall_time_s`` covers the whole batch: host
    delta application, conflict detection, and the (possible) repair;
    ``host_s`` is its host part before the repair starts (``delta_info``
    and the seed)."""

    inserted: int
    deleted: int
    seed_size: int
    report: Optional[ColoringReport]
    wall_time_s: float
    host_s: float = 0.0

    @property
    def repaired(self) -> bool:
        return self.report is not None


class DynamicColoring:
    """A live colored graph under streaming edge deltas, on ``device``
    (``None`` = the card).

    ``spec`` must resolve to the ``"recolor"`` strategy (the default);
    engine / frontier / concurrency knobs compose as everywhere else. The
    model is distance-1 only — under d2/pd2 an edge delta perturbs
    constraints beyond its endpoints, so the endpoint seed would
    under-repair. The vertex set is fixed at construction.

    ``edge_headroom`` / ``degree_headroom`` scale the plan envelope above
    the current graph so delta batches stay inside one program; pass
    ``plan_shape`` to pin the envelope for a whole stream.

    Invariants (pinned by the tests): after every batch ``colors`` is a
    valid coloring of ``graph``; ``num_colors <= max_degree_seen + 1``;
    same-envelope batches never rebuild the program (``plan.traces``
    stays 1).
    """

    def __init__(self, graph: Graph, spec: Optional[ColoringSpec] = None,
                 *, edge_headroom: float = 1.5,
                 degree_headroom: float = 1.5,
                 plan_shape: Optional[PlanShape] = None,
                 device: DeviceSpec = None):
        spec = self._check_spec(spec)
        self.spec = spec
        self.device = resolve_device(device)
        self._graph = graph
        self._edge_headroom = float(edge_headroom)
        self._degree_headroom = float(degree_headroom)
        self._pinned_shape = plan_shape
        self.recompiles = 0
        self.max_degree_seen = graph.max_degree()
        self._plan = self._compile(plan_shape or self._envelope(graph))
        # the cold start: no colors, everything pending — the same program
        # later delta repairs reuse
        self._colors = np.asarray(self._plan(graph).colors)

    # -------------------------------------------------------------- plumbing
    @staticmethod
    def _check_spec(spec: Optional[ColoringSpec]) -> ColoringSpec:
        spec = ColoringSpec(strategy="recolor") if spec is None else spec
        if get_strategy(spec.strategy).name != "recolor":
            raise ValueError(
                "DynamicColoring needs the 'recolor' strategy (got "
                f"{spec.strategy!r}); other strategies have no warm start")
        if spec.model != "d1":
            raise ValueError(
                "DynamicColoring is distance-1 only: under d2/pd2 an edge "
                "delta perturbs constraints beyond its endpoints, so the "
                "endpoint seed would under-repair")
        if spec.ordering != "natural":
            raise ValueError("DynamicColoring repairs in place; ordering "
                             "must be 'natural'")
        return spec

    def _envelope(self, graph: Graph) -> PlanShape:
        """Headroomed envelope on the pad_bucket ladder. The edge floor
        (one minimum bucket) lets a stream start from a sparse — even
        empty — graph without an immediate rebuild."""
        e = max(int(graph.num_directed_edges * self._edge_headroom), 1)
        d = graph.max_degree()
        return PlanShape(
            num_vertices=graph.num_vertices,
            padded_edges=pad_bucket(e),
            max_degree=max(int(d * self._degree_headroom), d + 2, 8))

    def _compile(self, shape: PlanShape) -> ColoringPlan:
        return compile_plan(self.spec, shape, device=self.device)

    def _ensure_envelope(self, graph: Graph) -> None:
        st = self._plan.statics
        if (graph.num_directed_edges <= st.padded_edges
                and graph.max_degree() <= st.max_degree):
            return
        if self._pinned_shape is not None:
            raise ValueError(
                f"stream outgrew the pinned plan envelope {st}: graph has "
                f"{graph.num_directed_edges} directed edges / max degree "
                f"{graph.max_degree()}; construct with a larger plan_shape "
                "or let DynamicColoring manage the envelope")
        self._plan = self._compile(self._envelope(graph))
        self.recompiles += 1

    # ------------------------------------------------------------ the state
    @property
    def graph(self) -> Graph:
        return self._graph

    @property
    def colors(self) -> np.ndarray:
        return self._colors

    @property
    def plan(self) -> ColoringPlan:
        return self._plan

    @property
    def num_colors(self) -> int:
        from .metrics import num_colors
        return num_colors(self._colors)

    @property
    def color_bound(self) -> int:
        """The provable palette bound, ``max_degree_seen + 1``."""
        return self.max_degree_seen + 1

    # ------------------------------------------------------------ the delta
    def apply_batch(self, inserts=None, deletes=None) -> DeltaReport:
        """Apply one edge-delta batch and repair the coloring incrementally.

        ``inserts`` / ``deletes`` are [M, 2] endpoint arrays (either
        orientation; duplicates, self loops and no-ops welcome — set
        semantics, deletes first). Only the endpoints of newly
        monochromatic edges are recolored; a conflict-free batch leaves
        every color untouched."""
        t0 = time.perf_counter()
        old = self._graph
        new_graph, new_pairs, n_del = old.delta_info(inserts, deletes)

        # genuinely new inserts: their monochromatic endpoints are the seed
        seed = np.zeros(old.num_vertices, np.bool_)
        if new_pairs.shape[0]:
            u, v = new_pairs[:, 0], new_pairs[:, 1]
            conf = self._colors[u] == self._colors[v]
            seed[u[conf]] = True
            seed[v[conf]] = True
        seed_size = int(seed.sum())
        host_s = time.perf_counter() - t0

        # nothing commits until the whole batch succeeds: a pinned-envelope
        # overflow (raises here) or a repair that fails to converge (raises
        # in the plan call) leaves graph, colors and max_degree_seen still
        # agreeing, so a caller can catch, resize and retry the batch
        self._ensure_envelope(new_graph)
        report = None
        if seed_size:
            report = self._plan(new_graph, colors=self._colors, seed=seed)
        self._graph = new_graph
        self.max_degree_seen = max(self.max_degree_seen,
                                   new_graph.max_degree())
        if report is not None:
            self._colors = np.asarray(report.colors)
        return DeltaReport(inserted=int(new_pairs.shape[0]), deleted=n_del,
                           seed_size=seed_size, report=report,
                           wall_time_s=time.perf_counter() - t0,
                           host_s=host_s)

    def recolor_full(self) -> ColoringReport:
        """Recolor the current graph from scratch through the same plan
        (palette compaction: drops the accumulated streaming gaps)."""
        report = self._plan(self._graph)
        self._colors = np.asarray(report.colors)
        return report

    # -------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """The complete streaming state as a flat dict of host arrays, in
        the reference's keys and dtypes (``repro_torch.train.checkpoint``
        writes it verbatim, and the reference restores it): the canonical
        undirected edge set, the committed colors, the plan envelope, and
        the stream counters. The spec is not included; serialize it with
        :meth:`repro_torch.core.api.ColoringSpec.to_dict`."""
        st = self._plan.statics
        return {
            "edges": self._graph.undirected_edges().astype(np.int64),
            "colors": self._colors.astype(np.int32),
            "num_vertices": np.int64(self._graph.num_vertices),
            "max_degree_seen": np.int64(self.max_degree_seen),
            "recompiles": np.int64(self.recompiles),
            "envelope": np.asarray(
                [st.num_vertices, st.padded_edges, st.max_degree], np.int64),
            "pinned": np.int64(self._pinned_shape is not None),
            "headroom": np.asarray(
                [self._edge_headroom, self._degree_headroom], np.float64),
        }

    @classmethod
    def from_state(cls, state: dict, spec: Optional[ColoringSpec] = None,
                   device: DeviceSpec = None) -> "DynamicColoring":
        """Rebuild a live stream from :meth:`state_dict` output (this
        package's or the reference's) WITHOUT rerunning the cold start: the
        committed colors are restored as-is and the plan is built against
        the checkpointed envelope, so every later delta batch gives the
        colors the unkilled run would."""
        spec = cls._check_spec(spec)
        self = cls.__new__(cls)
        self.spec = spec
        self.device = resolve_device(device)
        V = int(state["num_vertices"])
        self._graph = Graph.from_edges(
            V, np.asarray(state["edges"]).reshape(-1, 2))
        colors = np.asarray(state["colors"]).astype(np.int32)
        if colors.shape != (V,):
            raise ValueError(f"checkpointed colors shape {colors.shape} "
                             f"!= ({V},)")
        hr = np.asarray(state["headroom"], np.float64)
        self._edge_headroom, self._degree_headroom = float(hr[0]), float(hr[1])
        env = [int(x) for x in np.asarray(state["envelope"])]
        shape = PlanShape(num_vertices=env[0], padded_edges=env[1],
                          max_degree=env[2])
        self._pinned_shape = shape if int(state["pinned"]) else None
        self.recompiles = int(state["recompiles"])
        self.max_degree_seen = int(state["max_degree_seen"])
        self._plan = self._compile(shape)
        self._colors = colors
        return self
