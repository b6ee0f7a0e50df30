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

from ..kernels.ops import host_read, report_path, report_state, span
from .engine import (EngineSpec, SweepSpec, fixpoint_sweep,
                     lockstep_offsets, speculation_conflicts)
from .frontier import (compact_frontier, frontier_conflicts, frontier_counts,
                       frontier_sweep)
from .graph import BatchedGraph, DeviceSpec, batch_index

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


def _iterative_impl(bg: BatchedGraph, colors0=None, pending0=None, *,
                    concurrency: int, max_rounds: int,
                    max_sweeps: int, backend, color_bound: int = 0,
                    frontier_cap_v: int = 0, frontier_cap_e: int = 0,
                    seed_frontier: bool = False):
    """The speculation round loop over a batch of B graphs (one graph is a
    batch of one), with the semantics of the reference's ``vmap``: every
    graph runs its own rounds, and a graph whose round loop has ended stays
    frozen (no colors, pending rows or history entries change) while the
    others go on. Per round each graph takes its own branch: the frontier
    round when its pending set fits its slab, else the full round, so a
    round may run both, each over the graphs that took it. Each sweep
    launches the engine once for the whole union and each branch launches
    ``conflict_mask`` once; the host syncs are per batch (the pending
    counts, the spill test, one per sweep), not per graph.

    ``colors0``/``pending0`` ([B, V] or, for one graph, [V]; int32 /
    bool, host or device) warm-start it from an existing partial coloring
    (the ``"recolor"`` strategy's repair entry: committed colors + the
    conflicted seed set); ``None`` is the cold start (no colors, everything
    pending). ``seed_frontier`` lets round 0 take the compacted frontier
    path — off for cold starts, where round 0 is all-pending, on for
    seeded repairs, where round 0 IS the small conflicted tail.
    Returns ``(colors [B, V], rounds [B], conflicts [B, max_rounds],
    sweeps [B, max_rounds], frontier [B, max_rounds], unconverged [B])``:
    colors a device tensor, the rest host arrays."""
    B, V = bg.batch, bg.num_vertices
    BV = B * V
    dev = bg.device
    max_colors = bg.max_degree + 1
    if color_bound > 0:
        max_colors = min(max_colors, color_bound)
    mex = backend.bind(
        num_vertices=BV, max_colors=max_colors,
        ell_slot=None if bg.ell_slot is None else bg.ell_slot.reshape(-1),
        ell_width=bg.ell_width, max_degree=bg.max_degree)
    cap_v, cap_e = frontier_cap_v, frontier_cap_e
    use_frontier = cap_v > 0 and bg.has_frontier
    if use_frontier:
        mex_slab = backend.bind_slab(
            capacity=B * cap_v, max_colors=max_colors,
            ell_width=bg.max_degree, max_degree=bg.max_degree)
    rows = batch_index(bg.src, V)       # union rows of the real edges
    gsrc = batch_index(bg.src, V + 1)   # a pad (V) gathers its own phantom
    gdst = batch_index(bg.dst, V + 1)

    def full_round(colors, pending, ppad, opad, part):
        # neighbor forbids src iff committed, or pending at smaller offset
        # (never a padding edge: its src reads the phantom, never pending)
        pf, of = ppad.reshape(-1), opad.reshape(-1)
        forbids = pf[gsrc] & (~pf[gdst] | (of[gdst] < of[gsrc]))
        spec = SweepSpec(key_v=torch.where(forbids, rows, BV),
                         dyn_idx=gdst, dyn=forbids,
                         static_c=torch.zeros_like(gdst))
        run = pending & torch.as_tensor(part, device=dev)[:, None]
        # Phase 1 — fixpoint of the offset-precedence dataflow equations.
        colors, n_sweeps, _ = fixpoint_sweep(
            mex, spec, torch.where(run, torch.zeros_like(colors), colors),
            run, max_sweeps=max_sweeps, live=part)
        # Phase 2 — conflicts among same-round pairs; higher index recolors.
        return colors, n_sweeps, speculation_conflicts(bg.src, bg.dst,
                                                       colors, run, V)

    def frontier_round(colors, pending, ppad, opad, part):
        # same equations, compacted: the slab holds every pending vertex
        # and every constraint edge incident to one
        active = pending & torch.as_tensor(part, device=dev)[:, None]
        slab = compact_frontier(active, bg.inc_ptr, bg.dst, cap_v, cap_e)
        sd, ss = slab.dst.long(), slab.src.long()
        forbid_e = ((slab.src < V)
                    & (~ppad.gather(1, sd)
                       | (opad.gather(1, sd) < opad.gather(1, ss))))
        cpad0 = torch.cat([colors, colors.new_zeros((B, 1))], 1)
        cpad0.scatter_(1, slab.vert.long(), 0)   # empty rows hit slot V
        cpad, n_sweeps, _ = frontier_sweep(
            mex_slab,
            key_v=torch.where(forbid_e.reshape(-1),
                              batch_index(slab.owner, cap_v), B * cap_v),
            dyn=forbid_e.reshape(-1), dyn_idx=batch_index(slab.dst, V + 1),
            static_c=torch.zeros((B * cap_e,), dtype=torch.int32,
                                 device=dev),
            slot=slab.slot.reshape(-1), write_vert=slab.vert, cpad0=cpad0,
            live=part, max_sweeps=max_sweeps)
        return cpad[:, :V], n_sweeps, frontier_conflicts(slab, cpad, ppad, V)

    colors = (torch.zeros((B, V), dtype=torch.int32, device=dev)
              if colors0 is None else
              torch.as_tensor(colors0).to(dev, torch.int32, copy=True)
              .reshape(B, V))
    pending = (torch.ones((B, V), dtype=torch.bool, device=dev)
               if pending0 is None else
               torch.as_tensor(pending0).to(dev, torch.bool, copy=True)
               .reshape(B, V))
    report_state(colors, pending)
    conf_hist = np.zeros((B, max_rounds), np.int32)
    sweep_hist = np.zeros((B, max_rounds), np.int32)
    front_hist = np.zeros((B, max_rounds), np.int32)
    left = np.array(host_read(pending.sum(1), "pending"), np.int64)
    rounds = np.zeros(B, np.int32)
    rnd = 0
    while (left > 0).any() and rnd < max_rounds:
        with span("round"):
            live = left > 0
            rounds += live
            # OpenMP-static lockstep offsets over each graph's pending set
            offset = lockstep_offsets(pending, concurrency)
            ppad = torch.cat([pending, pending.new_zeros((B, 1))], 1)
            opad = torch.cat([offset, offset.new_full((B, 1), _INT32_MAX)],
                             1)
            fits = np.zeros(B, np.bool_)
            spill_test = use_frontier and (rnd > 0 or seed_frontier)
            if spill_test:
                nv, ne = np.array(host_read(torch.stack(
                    frontier_counts(pending, bg.inc_ptr)), "frontier_fit"))
                fits = live & (nv <= cap_v) & (ne <= cap_e)
            full = live & ~fits
            new_pending = torch.zeros_like(pending)
            if full.any():
                if spill_test:
                    report_path("slab spill")
                with span("round.full", n=bg.src.numel()):
                    colors, n_sweeps, p = full_round(colors, pending, ppad,
                                                     opad, full)
                new_pending |= p
                sweep_hist[full, rnd] = n_sweeps[full]
            if fits.any():
                report_path("frontier round")
                with span("round.frontier", n=B * cap_e):
                    colors, n_sweeps, p = frontier_round(colors, pending,
                                                         ppad, opad, fits)
                new_pending |= p
                sweep_hist[fits, rnd] = n_sweeps[fits]
                front_hist[fits, rnd] = nv[fits]
            pending = new_pending
            left = np.array(host_read(pending.sum(1), "pending"), np.int64)
            conf_hist[live, rnd] = left[live]
            rnd += 1
    return colors, rounds, conf_hist, sweep_hist, front_hist, left > 0


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
