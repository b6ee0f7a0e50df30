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

from ..kernels.ops import host_read, report_path, report_state, span
from .engine import EngineSpec, SweepSpec, fixpoint_iterate, fixpoint_sweep
from .frontier import compact_frontier, frontier_counts
from .graph import BatchedGraph, DeviceGraph, DeviceSpec, batch_index


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
    """[B, size] bool: OR of ``flags`` per (graph, ``index``) over [B, n]
    operands (index ``size`` = sink)."""
    out = torch.zeros((index.shape[0], size + 1), dtype=torch.int32,
                      device=flags.device)
    out.scatter_reduce_(1, index.long(), flags.to(torch.int32), "amax")
    return out[:, :size].bool()


def _dataflow_impl(bg: BatchedGraph, *, max_sweeps: int, backend,
                   color_bound: int = 0, frontier_cap_v: int = 0,
                   frontier_cap_e: int = 0):
    """The fixpoint over a batch of B graphs (one graph is a batch of one),
    with the reference's ``vmap`` semantics: each graph sweeps to its own
    fixpoint and stays frozen from then on, and each takes its own branch
    per sweep (the slab sweep when its changed set and their dependents
    fit the slab, else the full sweep). One engine launch per branch and
    sweep for the whole union; the host syncs are per batch. Returns
    ``(colors [B, V], sweeps [B], still_changing [B], slab_sweeps [B])``:
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
    # dependency edges: only smaller-index neighbors forbid a color
    dep = (bg.dst < bg.src).reshape(-1)  # padding (src == dst == V) excluded
    gdst = batch_index(bg.dst, V + 1)
    key_v = torch.where(dep, batch_index(bg.src, V), BV)
    cap_v, cap_e = frontier_cap_v, frontier_cap_e
    if not (cap_v > 0 and bg.has_frontier):
        spec = SweepSpec(key_v=key_v, dyn_idx=gdst, dyn=dep,
                         static_c=torch.zeros_like(gdst))
        colors, n, changed = fixpoint_sweep(
            mex, spec, torch.zeros((B, V), dtype=torch.int32, device=dev),
            torch.ones((B, V), dtype=torch.bool, device=dev),
            max_sweeps=max_sweeps)
        return colors, n, changed, np.zeros(B, np.int32)

    # Frontier (active-set) sweeps: per sweep, compact the changed
    # vertices' rows to find their dependents, compact the dependents'
    # rows, run the mex over that slab. Both sets spill to the full sweep
    # when they overflow the static capacities, so iterates (and the sweep
    # count) stay bit-identical to the full path.
    mex_slab = backend.bind_slab(
        capacity=B * cap_v, max_colors=max_colors,
        ell_width=bg.max_degree, max_degree=bg.max_degree)

    def full_sweep(cpad, chg, part):
        key_c = torch.where(dep, cpad.reshape(-1)[gdst],
                            torch.zeros_like(gdst))
        old = cpad[:, :V]
        new = torch.where(part[:, None], mex(key_v, key_c).view(B, V), old)
        return (torch.cat([new, cpad[:, V:]], 1),
                torch.where(part[:, None], new != old, chg))

    def slab_sweep(cpad, chg, active, part):
        slab = compact_frontier(active, bg.inc_ptr, bg.dst, cap_v, cap_e)
        forb = (slab.src < V) & (slab.dst < slab.src)
        key_c = torch.where(forb, cpad.gather(1, slab.dst.long()),
                            torch.zeros_like(slab.dst))
        mexv = mex_slab(
            torch.where(forb.reshape(-1), batch_index(slab.owner, cap_v),
                        B * cap_v),
            key_c.reshape(-1), slab.slot.reshape(-1)).view(B, cap_v)
        live = slab.vert < V
        row = torch.clamp(slab.vert, max=V)
        chg_new = _scatter_any(
            row, live & (mexv != cpad.gather(1, row.long())), V)
        sink = B * (V + 1)
        buf = torch.cat([cpad.reshape(-1), cpad.new_zeros(1)])
        buf[torch.where(live.reshape(-1), batch_index(slab.vert, V + 1),
                        sink)] = mexv.reshape(-1)
        return (buf[:sink].view(B, V + 1),
                torch.where(part[:, None], chg_new, chg))

    cpad = torch.zeros((B, V + 1), dtype=torch.int32, device=dev)
    chg = torch.ones((B, V), dtype=torch.bool, device=dev)
    report_state(cpad, chg)
    still = np.ones(B, np.bool_)
    n = np.zeros(B, np.int32)
    nslab = np.zeros(B, np.int32)
    k = 0
    while still.any() and k < max_sweeps:
        with span("round"):
            fits = np.zeros(B, np.bool_)
            if k > 0:
                nc, nce = np.array(host_read(torch.stack(
                    frontier_counts(chg, bg.inc_ptr)), "changed_fit"))
                fits = still & (nc <= cap_v) & (nce <= cap_e)
            if fits.any():
                # dependents of the changed sets: one compaction of their rows
                dslab = compact_frontier(
                    chg & torch.as_tensor(fits, device=dev)[:, None],
                    bg.inc_ptr, bg.dst, cap_v, cap_e)
                active = _scatter_any(dslab.dst, (dslab.src < V)
                                      & (dslab.dst > dslab.src), V)
                nv, ne = np.array(host_read(torch.stack(
                    frontier_counts(active, bg.inc_ptr)), "active_fit"))
                ok = (nv <= cap_v) & (ne <= cap_e)
                for path, mask in (("active sweep", fits & ok),
                                   ("slab spill", fits & ~ok)):
                    if mask.any():
                        report_path(path)
                fits &= ok
            full = still & ~fits
            if full.any():
                cpad, chg = full_sweep(cpad, chg,
                                       torch.as_tensor(full, device=dev))
            if fits.any():
                fits_t = torch.as_tensor(fits, device=dev)
                cpad, chg = slab_sweep(cpad, chg, active & fits_t[:, None],
                                       fits_t)
            n += still
            nslab += fits
            still = still & np.array(host_read(chg.any(1), "changed"),
                                     np.bool_)
            k += 1
    return cpad[:, :V], n, still, nslab


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


def dataflow_levels(g: DeviceGraph, max_iters: int = 4096):
    """Dataflow level of each vertex (longest dependency chain ending at it).

    Returns (levels [V] int32 >= 1, depth). Wavefront L's vertices are
    pairwise independent — the paper's XMT threads resolve exactly this
    schedule through full/empty-bit blocking. Pad edges (``src == V``) land
    in a sink row; a pad ``dst`` reads level 0.
    """
    V = g.num_vertices
    src, dst = g.src.long(), g.dst.long()
    dep = dst < src

    def step(lv):
        lpad = torch.cat([lv, lv.new_zeros(1)])
        contrib = torch.where(dep, lpad[dst], 0).to(torch.int32)
        seg = torch.zeros(V + 1, dtype=torch.int32, device=lv.device)
        seg.scatter_reduce_(0, src, contrib, "amax")
        return seg[:V] + 1

    lv, _, _ = fixpoint_iterate(step, torch.ones(V, dtype=torch.int32,
                                                 device=g.src.device),
                                max_iters=max_iters)
    return lv, int(lv.max()) if V else 0
