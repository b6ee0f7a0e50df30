"""ITERATIVE — the paper's Algorithm 2 (speculation + iteration), PyTorch port.

Execution model (the reference's, unchanged): the paper runs Alg. 2's
phase-1 loop with OpenMP static scheduling over ``P`` threads. In the
lockstep model of that execution the vertices racing at any instant are
those at the same offset within their thread's block. Per round:

  1. pending vertices get ``offset = rank % ceil(|U|/P)``
     (:func:`repro_torch.core.engine.lockstep_offsets`);
  2. tentative colors are the fixpoint of
         c[v] = mex{ c[w] : w adj v, committed(w) or offset(w) < offset(v) }
     reached by chaotic sweeps (:func:`repro_torch.core.engine.fixpoint_sweep`);
  3. conflict detection (Alg. 2 lines 11-14): monochromatic pending pairs
     queue the higher-index endpoint for the next round, through the
     ``conflict_mask`` kernel
     (:func:`repro_torch.core.engine.speculation_conflicts`).

The reference's ``lax.while_loop``/``lax.cond`` become host loops and
branches: each round reads its conflict count (the loop condition) and,
with the frontier on, its active counts (the spill test) on the host, and
each sweep reads its convergence flag.

The round loop is two-phase (repro_torch.core.frontier): round 0 sweeps the
full edge list; later rounds compact the pending tail and its incident
edges into a static slab and sweep that instead, spilling back to the full
path when the frontier overflows. Bit-identical either way. A warm start
(committed colors plus a seed mask, the ``"recolor"`` strategy) lets round
0 take the frontier path too.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels.ops import report_path, report_state
from .engine import (EngineSpec, SweepSpec, fixpoint_sweep,
                     lockstep_offsets, speculation_conflicts)
from .frontier import (compact_frontier, frontier_conflicts, frontier_counts,
                       frontier_sweep)
from .graph import DeviceGraph, DeviceSpec

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class ColoringResult:
    colors: np.ndarray                # [V] int32, >= 1
    rounds: int                       # outer iterations (paper Fig. 10b)
    conflicts_per_round: np.ndarray   # [rounds] int32 (paper Fig. 10c)
    sweeps_per_round: np.ndarray      # [rounds] int32 inner sweeps

    @functools.cached_property
    def total_conflicts(self) -> int:
        return int(self.conflicts_per_round.sum())

    @functools.cached_property
    def sweeps(self) -> int:
        """Total inner dataflow sweeps across all rounds."""
        return int(self.sweeps_per_round.sum())

    @functools.cached_property
    def num_colors(self) -> int:
        from .metrics import num_colors as _distinct
        return _distinct(self.colors)


def _iterative_impl(g: DeviceGraph, colors0=None, pending0=None, *,
                    concurrency: int, max_rounds: int,
                    max_sweeps: int, backend, color_bound: int = 0,
                    frontier_cap_v: int = 0, frontier_cap_e: int = 0,
                    seed_frontier: bool = False):
    """The speculation round loop. ``colors0``/``pending0`` ([V] int32 /
    bool, host or device) warm-start it from an existing partial coloring
    (the ``"recolor"`` strategy's repair entry: committed colors + the
    conflicted seed set); ``None`` is the cold start (no colors, everything
    pending). ``seed_frontier`` lets round 0 take the compacted frontier
    path — off for cold starts, where round 0 is all-pending, on for
    seeded repairs, where round 0 IS the small conflicted tail.
    Returns ``(colors, rounds, conflicts_per_round, sweeps_per_round,
    frontier_per_round, unconverged)``: colors a device tensor, the
    histories ``[max_rounds]`` int32 numpy arrays."""
    V = g.num_vertices
    dev = g.device
    src, dst = g.src, g.dst
    max_colors = g.max_degree + 1
    if color_bound > 0:
        max_colors = min(max_colors, color_bound)
    mex = backend.bind(num_vertices=V, max_colors=max_colors,
                       ell_slot=g.ell_slot, ell_width=g.ell_width,
                       max_degree=g.max_degree)
    use_frontier = frontier_cap_v > 0 and g.has_frontier
    if use_frontier:
        mex_slab = backend.bind_slab(
            capacity=frontier_cap_v, max_colors=max_colors,
            ell_width=g.max_degree, max_degree=g.max_degree)

    def full_round(colors, pending, ppad, opad):
        # neighbor forbids src iff committed, or pending at smaller offset
        forbids = ppad[src] & (~ppad[dst] | (opad[dst] < opad[src]))
        spec = SweepSpec(key_v=torch.where(forbids, src, V),
                         dyn_idx=dst, dyn=forbids,
                         static_c=torch.zeros_like(dst))
        # Phase 1 — fixpoint of the offset-precedence dataflow equations.
        colors, n_sweeps, _ = fixpoint_sweep(
            mex, spec, torch.where(pending, torch.zeros_like(colors), colors),
            pending, max_sweeps=max_sweeps)
        # Phase 2 — conflicts among same-round pairs; higher index recolors.
        return colors, n_sweeps, speculation_conflicts(src, dst, colors,
                                                       pending, V)

    def frontier_round(colors, pending, ppad, opad):
        # same equations, compacted: the slab holds every pending vertex
        # and every constraint edge incident to one
        slab = compact_frontier(pending, g.inc_ptr, dst,
                                frontier_cap_v, frontier_cap_e)
        forbid_e = ((slab.src < V)
                    & (~ppad[slab.dst] | (opad[slab.dst] < opad[slab.src])))
        cpad0 = torch.cat([colors, colors.new_zeros(1)])
        cpad0[slab.vert] = 0          # empty rows (vert == V) hit slot V
        cpad, n_sweeps, _ = frontier_sweep(
            mex_slab,
            key_v=torch.where(forbid_e, slab.owner, frontier_cap_v),
            dyn=forbid_e, dyn_idx=slab.dst,
            static_c=torch.zeros_like(slab.dst), slot=slab.slot,
            write_vert=slab.vert, cpad0=cpad0, max_sweeps=max_sweeps)
        return cpad[:V], n_sweeps, frontier_conflicts(slab, cpad, ppad, V)

    colors = (torch.zeros((V,), dtype=torch.int32, device=dev)
              if colors0 is None else
              torch.as_tensor(colors0).to(dev, torch.int32, copy=True))
    pending = (torch.ones((V,), dtype=torch.bool, device=dev)
               if pending0 is None else
               torch.as_tensor(pending0).to(dev, torch.bool, copy=True))
    report_state(colors, pending)
    conf_hist = np.zeros(max_rounds, np.int32)
    sweep_hist = np.zeros(max_rounds, np.int32)
    front_hist = np.zeros(max_rounds, np.int32)
    left = int(pending.sum())
    rnd = 0
    while left > 0 and rnd < max_rounds:
        # OpenMP-static lockstep offsets over the pending set
        offset = lockstep_offsets(pending, concurrency)
        ppad = torch.cat([pending, pending.new_zeros(1)])
        opad = torch.cat([offset, offset.new_full((1,), _INT32_MAX)])
        fits = False
        if use_frontier and (rnd > 0 or seed_frontier):
            nv, ne = (int(x) for x in frontier_counts(pending, g.inc_ptr))
            fits = nv <= frontier_cap_v and ne <= frontier_cap_e
        if fits:
            report_path("frontier round")
            colors, n_sweeps, pending = frontier_round(colors, pending,
                                                       ppad, opad)
            front_hist[rnd] = nv
        else:
            if use_frontier and (rnd > 0 or seed_frontier):
                report_path("slab spill")
            colors, n_sweeps, pending = full_round(colors, pending,
                                                   ppad, opad)
        left = int(pending.sum())
        conf_hist[rnd] = left
        sweep_hist[rnd] = n_sweeps
        rnd += 1
    return colors, rnd, conf_hist, sweep_hist, front_hist, left > 0


def color_iterative(
    g,
    concurrency: int = 64,
    max_rounds: int = 64,
    max_sweeps: int = 4096,
    engine: EngineSpec = "sort",
    color_bound: int = 0,
    model: str = "d1",
    device: DeviceSpec = None,
) -> ColoringResult:
    """Run ITERATIVE with ``concurrency`` lockstep virtual threads on
    ``device`` (``None`` = the card).

    ``g`` is a :class:`DeviceGraph` (model ``"d1"`` only), or a host
    :class:`repro_torch.core.graph.Graph` / ``BipartiteGraph`` lowered per
    ``model``: ``"d1"`` distance-1 (the default), ``"d2"`` distance-2
    (Graph input), ``"pd2"`` bipartite partial distance-2 (BipartiteGraph
    input; colors the left class). ``engine`` selects the first-fit inner loop by
    name (``"sort"``, ``"bitmap"``, ``"ell_pallas"``, ``"fused_pallas"``)
    or takes a :class:`repro_torch.core.engine.MexBackend` instance.
    ``color_bound`` optionally caps the table backends' color capacity
    below the provable Delta+1 bound.

    Shim over the registered ``"iterative"`` strategy — same arguments,
    same results, the legacy :class:`ColoringResult` return."""
    from .api import ColoringSpec, get_strategy  # lazy: api imports us
    spec = ColoringSpec(strategy="iterative", model=model, engine=engine,
                        concurrency=int(concurrency), max_rounds=max_rounds,
                        max_sweeps=max_sweeps, color_bound=int(color_bound))
    raw = get_strategy("iterative").oneshot(spec, g, device)
    if bool(raw.unconverged):
        raise RuntimeError(f"ITERATIVE did not converge in {max_rounds} rounds")
    rounds = int(raw.rounds)
    return ColoringResult(colors=raw.colors.cpu().numpy(), rounds=rounds,
                          conflicts_per_round=raw.conflicts_per_round[:rounds],
                          sweeps_per_round=raw.sweeps_per_round[:rounds])
