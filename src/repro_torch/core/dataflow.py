"""DATAFLOW — the paper's Algorithms 3-5 as a chaotic fixpoint, PyTorch port.

The XMT version blocks each vertex's thread on ``readff(color[w])`` for
every smaller-index neighbor ``w`` — hardware dataflow over the DAG
``w -> v iff (v,w) in E and w < v``. A GPU has no full/empty bits either,
so, as in the reference, we run the *same DAG* as chaotic sweeps of

    c[v] <- mex{ c[w] : w in adj(v), w < v }     (uncolored w contributes 0)

which converge in ``depth(DAG)`` sweeps (+1 no-change sweep) to exactly the
serial greedy coloring in index order.

Under the frontier layer the fixpoint runs *active-set sweeps*: a vertex's
iterate can change at sweep s only if one of its dependencies changed at
sweep s-1, so once the changed set fits the static slab each sweep compacts
``dependents(changed)`` and re-evaluates only those — same iterates, same
sweep count. Each sweep's branch and convergence test are host syncs.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels.ops import report_path, report_state
from .engine import EngineSpec, SweepSpec, fixpoint_sweep
from .frontier import compact_frontier, frontier_counts
from .graph import DeviceGraph, DeviceSpec


@dataclasses.dataclass
class DataflowResult:
    colors: np.ndarray  # [V] int32, >= 1 — identical to serial greedy
    sweeps: int         # fixpoint sweeps == dataflow DAG depth (+1 check)

    @functools.cached_property
    def num_colors(self) -> int:
        from .metrics import num_colors as _distinct
        return _distinct(self.colors)


def _scatter_any(index: torch.Tensor, flags: torch.Tensor,
                 size: int) -> torch.Tensor:
    """[size] bool: OR of ``flags`` per ``index`` (index ``size`` = sink)."""
    out = torch.zeros((size + 1,), dtype=torch.int32, device=flags.device)
    out.scatter_reduce_(0, index.long(), flags.to(torch.int32), "amax")
    return out[:size].bool()


def _dataflow_impl(g: DeviceGraph, *, max_sweeps: int, backend,
                   color_bound: int = 0, frontier_cap_v: int = 0,
                   frontier_cap_e: int = 0):
    """Returns ``(colors, sweeps, still_changing, slab_sweeps)``."""
    V = g.num_vertices
    dev = g.device
    max_colors = g.max_degree + 1
    if color_bound > 0:
        max_colors = min(max_colors, color_bound)
    mex = backend.bind(num_vertices=V, max_colors=max_colors,
                       ell_slot=g.ell_slot, ell_width=g.ell_width,
                       max_degree=g.max_degree)
    # dependency edges: only smaller-index neighbors forbid a color
    dep = g.dst < g.src  # padding (src == dst == V) excluded
    spec = SweepSpec(key_v=torch.where(dep, g.src, V),
                     dyn_idx=g.dst, dyn=dep,
                     static_c=torch.zeros_like(g.dst))
    use_frontier = frontier_cap_v > 0 and g.has_frontier
    if not use_frontier:
        colors, n, changed = fixpoint_sweep(
            mex, spec, torch.zeros((V,), dtype=torch.int32, device=dev),
            torch.ones((V,), dtype=torch.bool, device=dev),
            max_sweeps=max_sweeps)
        return colors, n, changed, 0

    # Frontier (active-set) sweeps: per sweep, compact the changed
    # vertices' rows to find their dependents, compact the dependents'
    # rows, run the mex over that slab. Both sets spill to the full sweep
    # when they overflow the static capacities, so iterates (and the sweep
    # count) stay bit-identical to the full path.
    mex_slab = backend.bind_slab(
        capacity=frontier_cap_v, max_colors=max_colors,
        ell_width=g.max_degree, max_degree=g.max_degree)
    cap_v, cap_e = frontier_cap_v, frontier_cap_e

    def full_sweep(cpad):
        key_c = torch.where(dep, cpad[spec.dyn_idx], spec.static_c)
        new = mex(spec.key_v, key_c)
        return torch.cat([new, cpad[V:]]), new != cpad[:V], 0

    def slab_sweep(cpad, active):
        slab = compact_frontier(active, g.inc_ptr, g.dst, cap_v, cap_e)
        forb = (slab.src < V) & (slab.dst < slab.src)
        key_c = torch.where(forb, cpad[slab.dst], torch.zeros_like(slab.dst))
        mexv = mex_slab(torch.where(forb, slab.owner, cap_v), key_c,
                        slab.slot)
        live = slab.vert < V
        row = torch.clamp(slab.vert, max=V)
        chg_new = _scatter_any(row, live & (mexv != cpad[row]), V)
        buf = torch.cat([cpad, cpad.new_zeros(1)])
        buf[torch.where(live, slab.vert, V + 1)] = mexv
        return buf[:V + 1], chg_new, 1

    def active_sweep(cpad, chg):
        # dependents of the changed set: one compaction of the changed rows
        dslab = compact_frontier(chg, g.inc_ptr, g.dst, cap_v, cap_e)
        dep_e = (dslab.src < V) & (dslab.dst > dslab.src)
        active = _scatter_any(dslab.dst, dep_e, V)
        nv, ne = (int(x) for x in frontier_counts(active, g.inc_ptr))
        if nv <= cap_v and ne <= cap_e:
            report_path("active sweep")
            return slab_sweep(cpad, active)
        report_path("slab spill")
        return full_sweep(cpad)

    cpad = torch.zeros((V + 1,), dtype=torch.int32, device=dev)
    chg = torch.ones((V,), dtype=torch.bool, device=dev)
    report_state(cpad, chg)
    n, still, nslab = 0, True, 0
    while still and n < max_sweeps:
        fits = False
        if n > 0:
            nc, nce = (int(x) for x in frontier_counts(chg, g.inc_ptr))
            fits = nc <= cap_v and nce <= cap_e
        cpad, chg, used = active_sweep(cpad, chg) if fits else full_sweep(cpad)
        still = bool(chg.any())
        n, nslab = n + 1, nslab + used
    return cpad[:V], n, still, nslab


def color_dataflow(g, max_sweeps: int = 4096,
                   engine: EngineSpec = "sort",
                   color_bound: int = 0, model: str = "d1",
                   device: DeviceSpec = None) -> DataflowResult:
    """DATAFLOW on ``device`` (``None`` = the card). ``color_bound`` caps
    the table backends' capacity below Delta+1, as in ``color_iterative``.

    ``model`` selects the coloring semantics ("d1" | "d2" | "pd2"), lowered
    as in ``color_iterative``; under "d2"/"pd2" the fixpoint reproduces
    the serial D2/PD2 greedy in index order (``greedy_color_d2`` /
    ``greedy_color_pd2``), since the lowering keeps vertex ids.

    Shim over the registered ``"dataflow"`` strategy — same arguments, same
    results, the legacy :class:`DataflowResult` return."""
    from .api import ColoringSpec, get_strategy  # lazy: api imports us
    spec = ColoringSpec(strategy="dataflow", model=model, engine=engine,
                        max_sweeps=max_sweeps, color_bound=int(color_bound))
    raw = get_strategy("dataflow").oneshot(spec, g, device)
    if bool(raw.unconverged):
        raise RuntimeError(f"DATAFLOW did not converge in {max_sweeps} sweeps")
    return DataflowResult(colors=raw.colors.cpu().numpy(),
                          sweeps=int(raw.sweeps_per_round[0]))
