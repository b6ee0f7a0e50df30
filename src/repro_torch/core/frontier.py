"""The frontier execution layer: active-set compaction for speculation rounds.

After the first speculation round the pending set collapses to a small
conflicted tail (paper §5, Fig. 10), yet a naive round loop keeps sweeping the
full edge list every round. This module compacts the active vertices and
their incident constraint edges into fixed-capacity slabs:

* :func:`frontier_capacities` — the static bucket ladder: slab capacities
  derived from the graph envelope via :func:`repro_torch.core.graph.pad_bucket`.
* :func:`compact_frontier` — sort-free cumsum-scatter compaction of the
  active vertices AND their incident edges into a :class:`FrontierSlab`:
  the ``frontier_expand`` kernel expands the slab rows into their edges
  through the DeviceGraph's ``inc_ptr``.
* :func:`frontier_sweep` — the speculation inner loop over the slab only,
  bit-identical to :func:`repro_torch.core.engine.fixpoint_sweep` on the
  full edge list.
* :func:`frontier_conflicts` — Alg. 2 phase 2 over the slab edges only,
  through the ``conflict_mask`` kernel.

Each takes one graph or a batch of B (``ColoringPlan.map``), whose graphs
compact into their own regions of one slab (rows ``[b*cap_v, (b+1)*cap_v)``
and edges ``[b*cap_e, (b+1)*cap_e)``); one graph runs as a batch of one.

Spill semantics: capacities are static, frontiers are data. The round loops
check the active counts against the capacities every round (a host sync)
and take the full-edge path when the frontier overflows, so results are
bit-identical in all regimes. Reference ``mode="drop"`` scatters become
writes into sink slots one past the end.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.frontier_expand import frontier_expand
from ..kernels.ops import host_read, report_state
from .engine import SlabMexFn, conflict_pending
from .graph import batch_index, pad_bucket

FRONTIER_MODES = ("auto", "on", "off")


def frontier_capacities(num_vertices: int, padded_edges: int,
                        max_degree: int = 0, *,
                        capacity: int = 0) -> Tuple[int, int]:
    """The static bucket ladder: (vertex capacity, edge capacity) slabs.

    The vertex slab is ~|V|/32 and the edge slab the matching
    average-degree share with 2x skew headroom (never below one full
    max-degree row), both rounded up the pad_bucket ladder. ``capacity``
    overrides the vertex capacity; the edge slab scales with it. A
    degenerate envelope (V=0 or E=0) gets ``(0, 0)`` — frontier disabled."""
    if int(num_vertices) <= 0 or int(padded_edges) <= 0:
        return 0, 0
    V = max(1, int(num_vertices))
    E = max(1, int(padded_edges))
    cap_v = int(capacity) if capacity > 0 else max(64, V // 32)
    cap_v = pad_bucket(min(cap_v, V), min_bucket=8)
    avg_share = (2 * E // V) * cap_v  # cap_v rows of twice-average degree
    cap_e = max(cap_v, avg_share, 2 * max(0, int(max_degree)))
    cap_e = pad_bucket(min(cap_e, E), min_bucket=8)
    return cap_v, cap_e


def resolve_frontier(mode: str, capacity: int, *, num_vertices: int,
                     padded_edges: int, max_degree: int,
                     has_inc: bool) -> Tuple[int, int]:
    """Resolve a spec-level ``frontier=`` knob against a graph envelope
    into static slab capacities ((0, 0) = frontier disabled). ``"auto"``
    enables it whenever the graph carries ``inc_ptr``; ``"on"`` demands it
    and raises otherwise; ``"off"`` disables."""
    if mode not in FRONTIER_MODES:
        raise ValueError(f"unknown frontier mode {mode!r}; "
                         f"choose from {FRONTIER_MODES}")
    usable = has_inc and padded_edges > 0 and num_vertices > 0
    if mode == "off":
        return 0, 0
    if not usable:
        if mode == "on":
            raise ValueError(
                "frontier='on' needs the incident-edge auxiliary: build the "
                "graph via Graph.to_device() (any layout attaches inc_ptr)")
        return 0, 0
    return frontier_capacities(num_vertices, padded_edges, max_degree,
                               capacity=capacity)


class FrontierSlab(NamedTuple):
    """The compacted active set: ``cap_v`` vertex rows + ``cap_e`` incident
    edges, fixed shapes, padded with inert sentinels.

    vert:  [cap_v] int32 vertex id of each slab row; ``V`` = empty row.
    owner: [cap_e] int32 slab row owning each slab edge; ``cap_v`` = pad.
    src:   [cap_e] int32 vertex id of the owning row; ``V`` = pad.
    dst:   [cap_e] int32 edge target; ``V`` (or ``dst_pad``) = pad.
    slot:  [cap_e] int32 position of the edge within its row.
    nv/ne: 0-d int32 true active counts — may EXCEED the capacities;
           callers must spill to the full path when they do.
    A batch's slab has a leading [B] on every field, graph b's row in its
    own ids.
    """

    vert: torch.Tensor
    owner: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    slot: torch.Tensor
    nv: torch.Tensor
    ne: torch.Tensor


def frontier_counts(active: torch.Tensor,
                    inc_ptr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nv, ne) of an active mask — the O(V) spill check, computable
    without building the slab. ``active`` [V] and ``inc_ptr`` [V+1] give
    0-d counts; a batch ([B, V], [B, V+1]) gives [B] counts."""
    deg = inc_ptr[..., 1:] - inc_ptr[..., :-1]
    nv = active.sum(-1, dtype=torch.int32)
    ne = torch.where(active, deg, torch.zeros_like(deg)).sum(
        -1, dtype=torch.int32)
    return nv, ne


def compact_frontier(active: torch.Tensor, inc_ptr: torch.Tensor,
                     dst: torch.Tensor, cap_v: int, cap_e: int, *,
                     dst_pad: Optional[int] = None) -> FrontierSlab:
    """Compact the active vertices and their incident CSR rows into a
    :class:`FrontierSlab` — no sort: a rank cumsum places vertices, and
    the degree cumsum is the slab's row pointer, from which
    :func:`repro_torch.kernels.frontier_expand` assigns edges to rows and
    pulls their targets through ``inc_ptr``.

    ``active`` [V] bool; ``inc_ptr`` [V+1] int32 row pointers into ``dst``
    (rows contiguous); padded slab edges point at ``dst_pad`` (default V;
    the distributed round loop passes its global phantom id, since its edge
    targets are global while its rows are local). Overflow never
    corrupts: rows landing beyond the capacities go to the sinks, and
    ``nv``/``ne`` report the TRUE counts so callers spill. A graph with no
    edges gives an empty slab with ``nv`` equal to the active count and
    ``ne = 0``.

    A batch (``active`` [B, V], ``inc_ptr`` [B, V+1], ``dst`` [B, E])
    compacts each graph along its own row: every field gains a leading
    [B], and graph b's slab is exactly the one it compacts alone.
    """
    if active.dim() == 1:
        slab = compact_frontier(active[None], inc_ptr[None], dst[None],
                                cap_v, cap_e, dst_pad=dst_pad)
        return FrontierSlab(*(x[0] for x in slab))
    B, V = active.shape
    dev = active.device
    deg = inc_ptr[:, 1:] - inc_ptr[:, :-1]
    nv, ne = frontier_counts(active, inc_ptr)
    i32 = dict(dtype=torch.int32, device=dev)

    # vertices: rank-within-active-set IS the slab row (order-preserving);
    # rows past the capacity go to the sink slot cap_v
    rank = torch.cumsum(active.to(torch.int32), 1, dtype=torch.int32) - 1
    row = torch.where(active & (rank < cap_v), rank,
                      torch.full_like(rank, cap_v))
    vert = torch.full((B, cap_v + 1), V, **i32)
    vert.scatter_(1, row.long(), torch.arange(V, **i32).expand(B, V))
    vert = vert[:, :cap_v]

    # edges: the exclusive cumsum of slab-row degrees is the slab's row
    # pointer; frontier_expand gives each slab entry its row, slot, source
    # and target
    degp = torch.cat([deg, deg.new_zeros((B, 1))], 1)
    vdeg = degp.gather(1, torch.clamp(vert, max=V).long())  # empty rows: 0
    starts = torch.cumsum(vdeg, 1, dtype=torch.int32) - vdeg
    owner, src, gdst, slot = frontier_expand(vert, vdeg, starts, ne, inc_ptr,
                                             dst, cap_e, dst_pad=dst_pad)
    return FrontierSlab(vert=vert, owner=owner, src=src, dst=gdst, slot=slot,
                        nv=nv, ne=ne)


def frontier_sweep(mex_slab: SlabMexFn, *, key_v: torch.Tensor,
                   dyn: torch.Tensor, dyn_idx: torch.Tensor,
                   static_c: torch.Tensor, slot: torch.Tensor,
                   write_vert: torch.Tensor, cpad0: torch.Tensor,
                   max_sweeps: int, live=None):
    """The speculation inner loop over a compacted slab: chaotic sweeps of
    ``c[vert[i]] <- mex{ contribution(e) : e in row i }`` to a fixpoint,
    one host sync per sweep.

    Mirrors :func:`repro_torch.core.engine.fixpoint_sweep` in slab space —
    same contribution classification, same convergence rule — so sweep
    counts and fixpoints are bit-identical to the full-edge path. ``cpad0``
    is the padded color carrier ([V+1]; the trailing 0 is the phantom
    gather target); ``write_vert`` the cpad index of each slab row, any
    value >= V being an inert row (written to a sink slot past the end).

    For a batch ``cpad0`` is [B, V+1] and ``write_vert`` [B, cap_v] (each
    graph's own ids); the per-edge operands stay flat, in union space
    (``key_v`` union slab rows, ``dyn_idx`` indices into the flattened
    carrier), and ``live`` ([B] host bool, default all) names the graphs
    that sweep. Each stops at its own fixpoint and stays frozen (its
    writes go to the sink); one engine launch and one host sync per sweep
    for the batch.

    Returns ``(cpad, sweeps, still_changing)``: [V+1], int and bool for
    one graph, [B, V+1] and two [B] host arrays for a batch.
    """
    if cpad0.dim() == 1:
        cpad, n, act = frontier_sweep(
            mex_slab, key_v=key_v, dyn=dyn, dyn_idx=dyn_idx,
            static_c=static_c, slot=slot, write_vert=write_vert[None],
            cpad0=cpad0[None], max_sweeps=max_sweeps)
        return cpad[0], int(n[0]), bool(act[0])
    B, n_pad = cpad0.shape                       # V + 1
    report_state(cpad0)
    sink = B * n_pad
    wok = write_vert < n_pad - 1
    widx = torch.where(wok.reshape(-1), batch_index(write_vert, n_pad), sink)
    old_idx = torch.clamp(widx, max=sink - 1)
    act = np.ones(B, np.bool_) if live is None else np.array(live, np.bool_)
    act_t = torch.as_tensor(act, device=cpad0.device)
    n = np.zeros(B, np.int32)
    flat, k = cpad0.reshape(-1), 0
    while act.any() and k < max_sweeps:
        key_c = torch.where(dyn, flat[dyn_idx], static_c)
        mexv = mex_slab(key_v, key_c, slot)
        ok = (wok & act_t[:, None]).reshape(-1)
        n += act
        act_t = (ok & (mexv != flat[old_idx])).view(B, -1).any(1)
        act = np.array(host_read(act_t, "slab_sweep"), np.bool_)
        buf = torch.cat([flat, flat.new_zeros(1)])
        buf.index_put_((torch.where(ok, widx, sink),), mexv)
        flat, k = buf[:sink], k + 1
    return flat.view(B, n_pad), n, act


def frontier_conflicts(slab: FrontierSlab, cpad: torch.Tensor,
                       ppad: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Alg. 2 phase 2 over the slab edges only — the frontier counterpart
    of :func:`repro_torch.core.engine.speculation_conflicts`. Exact,
    because every conflict edge has a pending ``src`` and the slab holds
    ALL edges incident to pending vertices; the slab rows are all pending,
    so masking non-pending colors to 0 reproduces the reference's
    ``ppad[dst] & cpad[src] == cpad[dst]`` through the ``conflict_mask``
    kernel. Returns the next round's pending mask ([V] bool; for a batch's
    slab and carriers, [B, V])."""
    masked = torch.where(ppad, cpad, torch.zeros_like(cpad))
    return conflict_pending(slab.src, slab.dst, masked, num_vertices)

