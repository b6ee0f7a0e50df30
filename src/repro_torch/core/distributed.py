"""Distributed BSP coloring on ``torch.distributed`` — the Bozdag et al. [6]
framework (the paper's ITERATIVE ancestor) run as SPMD: one process per
shard (PyTorch port of ``repro.core.distributed``).

Vertices are partitioned across the ranks of a :class:`ProcessMesh`
(:func:`partition_graph`: 1D blocks, or 2D block-cyclic for skewed R-MAT
degree distributions), and every local vertex is classified at partition
time as **interior** (no cross-shard edge) or **boundary**. Each rank
partitions the same host graph, keeps its own shard, and runs the round
loop of :func:`_bsp_local`. Each BSP round:

  1. local speculative greedy over the rank's pending vertices, against
     last round's exchanged snapshot: the fixpoint of the local
     offset-precedence equations through the shared
     :func:`repro_torch.core.engine.fixpoint_sweep` (with local
     concurrency ``C=1``, the sequential distributed-memory algorithm);
     cross-shard pending neighbors are speculated against. The first-fit
     inner loop is the engine bound to the local slab, so ``ell_pallas``
     and ``fused_pallas`` launch the ``firstfit`` and ``round_fused``
     kernels here;
  2. the wire, a three-tier exchange of ``(color, pending)`` state, each
     tier bit-identical to the others:

     * **boundary wire** (the default): only boundary entries cross,
       bit-packed into int32 words (:mod:`repro_torch.parallel.compression`)
       and scattered through the static boundary->halo id map, gathered
       once before the loop; the rank's own slice is patched locally;
     * **frontier-halo wire**, on top: when a vote says every rank's
       pending set fits its frontier slab, the round gathers the ``(gid,
       color)`` pairs of the slabs instead (one int32 word per pair when
       both fields fit, :func:`slab_entry_bytes`);
     * **full wire** (``wire="full"``, the spill path): the whole
       ``[Vp]`` vector packed as int16 ``color << 1 | pending``;
  3. conflict detection against the exchanged view through the
     ``conflict_mask`` kernel; the higher global id recolors;
  4. the termination vote: one ``all_reduce`` and one host read.

The reference's ``lax.while_loop``/``lax.cond`` become host loops and
branches. Every rank makes the same collective calls in the same order: the
wire tier follows the uniform vote, and a rank-local test (does this
rank's pending set fit its slab?) only picks local work. Every reference
``mode="drop"`` scatter writes to a sink slot one past the end.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.ops import (collective_scope, report_loop_exit, report_path,
                           report_round, report_state)
from ..parallel.compression import halo_words, pack_halo, unpack_halo
from .engine import (EngineSpec, SweepSpec, conflict_rows, edge_slots,
                     fixpoint_sweep, get_backend, lockstep_offsets)
from .frontier import compact_frontier, frontier_counts, frontier_sweep
from .graph import DeviceSpec, Graph, ShardLayout, resolve_device

PARTITION_SCHEMES = ("1d", "2d")
WIRES = ("boundary", "full")

_INT32_MAX = torch.iinfo(torch.int32).max
_WORD = 1 << 32


# --------------------------------------------------------------------------
# the process mesh
# --------------------------------------------------------------------------
class ProcessMesh:
    """The ranks of a ``torch.distributed`` process group as a device mesh:
    the port's stand-in for the reference's JAX ``Mesh``.

    ``group`` is a process group (``None``: one shard, no group, identity
    collectives — the reference's 1-device mesh) and ``device`` this rank's
    device (``None`` = the card). Rank order is shard order: a reference
    mesh of shape ``(4, 2)`` is 8 ranks in row-major order, as
    ``lax.axis_index`` over all mesh axes numbers its devices.

    The collective route is fixed per backend: NCCL takes the payload on
    the card; gloo takes CPU tensors directly, and with a CUDA device every
    payload is copied to a pinned host tensor and back (ranks sharing one
    card, where NCCL refuses). A gathered payload other than ``int32``
    travels as its bytes. ``bytes_gathered``
    counts the bytes this rank's all-gathers received."""

    def __init__(self, group=None, device: DeviceSpec = None):
        import torch.distributed as dist
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.group = group
        self.device = dev
        if group is None:
            self.backend, self.rank, self.num_devices = None, 0, 1
            self.route = "local"
        else:
            self.backend = str(dist.get_backend(group))
            self.rank = dist.get_rank(group)
            self.num_devices = dist.get_world_size(group)
            if self.backend == "nccl":
                if dev.type != "cuda":
                    raise ValueError("an NCCL process group needs a CUDA "
                                     f"device, got {dev}")
                self.route = "device"
            elif self.backend == "gloo":
                self.route = "host" if dev.type == "cuda" else "device"
            else:
                raise ValueError(f"unsupported process-group backend "
                                 f"{self.backend!r}; use 'gloo' or 'nccl'")
        self.bytes_gathered = 0

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank={self.rank}/{self.num_devices}, "
                f"device={self.device}, backend={self.backend}, "
                f"route={self.route})")

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """A payload as the collective takes it."""
        x = x.contiguous()
        if self.route == "host":
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return buf.copy_(x)
        return x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.route == "host" else x

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order
        (``lax.all_gather(..., tiled=True)``). A recorder sees the call
        with or without a group (``kernels.ops.collective_scope``)."""
        with collective_scope("all_gather", x, self.num_devices) as scope:
            return scope.result(self._all_gather(x))

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        import torch.distributed as dist
        # gloo and NCCL take int32; any other payload (the int16 full
        # wire) travels as its bytes and is viewed back after the gather
        raw = x.dtype != torch.int32
        payload = self._out(x.contiguous().view(torch.uint8) if raw else x)
        outs = [torch.empty_like(payload) for _ in range(self.num_devices)]
        dist.all_gather(outs, payload, group=self.group)
        out = torch.cat(outs)
        self.bytes_gathered += out.numel() * out.element_size()
        out = self._back(out)
        return out.view(x.dtype) if raw else out

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        with collective_scope("all_reduce", x, self.num_devices,
                              str(op).rsplit(".", 1)[-1].lower()) as scope:
            return scope.result(self._reduce(x, op))

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x
        import torch.distributed as dist
        payload = self._out(x)
        if payload is x:
            payload = x.clone()
        dist.all_reduce(payload, op=op, group=self.group)
        return self._back(payload)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._all_reduce(x, dist.ReduceOp.MAX)


# --------------------------------------------------------------------------
# host partitioning
# --------------------------------------------------------------------------
def slab_entry_bytes(verts_global: int, wire_colors: int) -> int:
    """Wire bytes one frontier-slab entry costs: 4 when the ``(gid,
    color)`` pair packs into a single int32 word (gid needs
    ``bit_length(Vp)`` bits — ``Vp`` doubles as the drop sentinel — plus
    ``bit_length(wire_colors)`` for the color), else 8 via two gathers."""
    packed = (wire_colors > 0 and
              int(verts_global).bit_length()
              + int(wire_colors).bit_length() <= 32)
    return 4 if packed else 8


def _grid_shape(num_devices: int) -> Tuple[int, int]:
    """The ``Pr x Pc`` grid of the 2D block-cyclic scheme: ``Pr`` the
    largest divisor of D at most ``sqrt(D)`` (a prime D degenerates to a
    1 x D grid, i.e. plain cyclic distribution)."""
    Pr = max(1, int(np.sqrt(num_devices)))
    while num_devices % Pr:
        Pr -= 1
    return Pr, num_devices // Pr


def partition_graph(graph: Graph, num_devices: int,
                    pad_edges_to: int = 0, *, scheme: str = "1d",
                    pad_boundary_to: int = 0) -> ShardLayout:
    """Host-side partitioning into the shard-local CSR + halo layout
    (:class:`repro_torch.core.graph.ShardLayout`), array for array the
    reference's.

    Shard d owns partition-space vertices [d*Vl, (d+1)*Vl); ``lsrc`` holds
    *local* ids (pad = Vl), ``ldst`` *global* ids (pad = Vl*D). Edges stay
    row-contiguous per shard (src order), so local ELL slots and incident
    pointers are recoverable on the device.

    A local vertex is **boundary** iff it has a cross-shard edge (as src
    or dst), else **interior**; ``bnd [D, Bl]`` lists each shard's
    boundary vertices, the static index map of the boundary wire.

    ``scheme``: ``"1d"`` contiguous blocks of the original ids, or ``"2d"``
    block-cyclic over a ``Pr x Pc`` grid (``owner(v) = (v mod Pr)*Pc +
    (v div Pr) mod Pc``, local index ``v div D``), which spreads R-MAT's
    low-id hubs over every shard; a ``"2d"`` layout carries the
    original->partition ``perm`` (:meth:`ShardLayout.unpermute` inverts
    it). ``pad_edges_to`` / ``pad_boundary_to`` pin El / Bl (the plan
    path); a graph whose densest shard exceeds either is rejected."""
    if scheme not in PARTITION_SCHEMES:
        raise ValueError(f"unknown partition scheme {scheme!r}; choose "
                         f"from {PARTITION_SCHEMES}")
    D = num_devices
    V = graph.num_vertices
    Vl = -(-V // D)
    Vp = Vl * D
    src, dst = graph.directed_edges()  # src sorted
    perm = None
    if scheme == "2d":
        Pr, Pc = _grid_shape(D)
        ids = np.arange(V, dtype=np.int64)
        owner_of = (ids % Pr) * Pc + (ids // Pr) % Pc
        perm = (owner_of * Vl + ids // D).astype(np.int32)
        # (src, dst) order in ONE sort of an int64 key: the reference's
        # lexsort order, since a Graph's directed edges are distinct
        key = perm[src].astype(np.int64) * Vp + perm[dst]
        key.sort()
        src, dst = (key // Vp).astype(np.int32), (key % Vp).astype(np.int32)
        del key
    owner = src // Vl
    counts = np.bincount(owner, minlength=D)
    El = max(1, int(counts.max()))
    if pad_edges_to:
        if El > pad_edges_to:
            raise ValueError(
                f"densest partition holds {El} directed edges, above the "
                f"requested slab capacity pad_edges_to={pad_edges_to}")
        El = int(pad_edges_to)
    lsrc = np.full((D, El), Vl, np.int32)
    ldst = np.full((D, El), Vp, np.int32)
    offsets = np.zeros(D + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    for d in range(D):
        sl = slice(offsets[d], offsets[d + 1])
        k = offsets[d + 1] - offsets[d]
        lsrc[d, :k] = src[sl] - d * Vl
        ldst[d, :k] = dst[sl]
    # every endpoint of a cross-shard edge is boundary (marking dst as
    # well as src keeps the split exact for one-directional edge lists)
    cross = owner != (dst // Vl)
    bmask = np.zeros(Vp, np.bool_)
    bmask[src[cross]] = True
    bmask[dst[cross]] = True
    bids = np.flatnonzero(bmask)
    bowner = bids // Vl
    bcounts = np.bincount(bowner, minlength=D)
    Bl = int(bcounts.max()) if bids.size else 0
    if pad_boundary_to:
        if Bl > pad_boundary_to:
            raise ValueError(
                f"densest shard holds {Bl} boundary vertices, above the "
                f"requested halo capacity pad_boundary_to={pad_boundary_to}")
        Bl = int(pad_boundary_to)
    bnd = np.full((D, Bl), Vl, np.int32)
    boffsets = np.zeros(D + 1, np.int64)
    np.cumsum(bcounts, out=boffsets[1:])
    rank = np.arange(bids.size, dtype=np.int64) - boffsets[bowner]
    bnd[bowner, rank] = (bids - bowner * Vl).astype(np.int32)
    return ShardLayout(lsrc=lsrc, ldst=ldst, bnd=bnd, verts_local=Vl,
                       num_vertices=V, num_devices=D, scheme=scheme,
                       perm=perm, boundary_counts=bcounts.astype(np.int64))


# --------------------------------------------------------------------------
# the per-rank round loop
# --------------------------------------------------------------------------
def _bsp_local(mesh: ProcessMesh, lsrc: torch.Tensor, ldst: torch.Tensor,
               bnd: torch.Tensor, *, verts_local: int, local_concurrency: int,
               max_rounds: int, max_sweeps: int, backend, max_colors: int,
               ell_width: int, frontier_cap_v: int = 0,
               frontier_cap_e: int = 0, wire: str = "boundary",
               wire_colors: int = 0):
    """One rank's BSP round loop over its shard (``lsrc``/``ldst`` [El],
    ``bnd`` [Bl], int32 on ``mesh.device``).

    The wire: the default **boundary wire** packs the shard's boundary
    ``(color, pending)`` entries into int32 words (entry width
    ``bit_length(wire_colors) + 1`` bits, ``wire_colors`` the provable
    Delta+1 bound) and all-gathers only those; the boundary->halo id map
    is gathered ONCE before the loop. The gathered payload patches the
    carried ``[Vp]`` snapshot at the boundary ids and the rank's own slice
    is patched locally: every cross-shard read lands on a remote boundary
    vertex, so the result equals the full gather's. ``wire="full"``
    gathers the whole packed int16 ``[Vp]`` vector each round.

    Frontier rounds (``frontier_cap_v > 0``): a rank whose pending set and
    incident edges fit its slabs solves (and detects conflicts) over the
    compacted slab; when the vote says EVERY rank's pending vertices fit,
    the round gathers the ``(gid, color)`` slab pairs instead of its round
    wire. Round 0 always takes the round wire.

    Returns ``(colors [Vl] tensor, rounds, conflicts_per_round,
    sweeps_per_round, frontier_per_round)``: the histories are
    ``[max_rounds]`` int32 numpy arrays, conflicts and frontier sizes
    summed over ranks, sweeps this rank's own."""
    Vl = verts_local
    D = mesh.num_devices
    Vp = Vl * D
    C = local_concurrency
    dev = lsrc.device
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r}; choose from {WIRES}")
    use_boundary = wire == "boundary"
    Bl = int(bnd.shape[0])
    if use_boundary and Bl > 0 and wire_colors <= 0:
        raise ValueError("wire='boundary' needs wire_colors (the provable "
                         "Delta+1 color bound) to size the packed payload")
    i32 = dict(dtype=torch.int32, device=dev)
    base = mesh.rank * Vl
    real = lsrc < Vl
    gsrc = torch.where(real, lsrc + base, Vp)
    dst_local = (ldst >= base) & (ldst < base + Vl)
    dst_loc = torch.where(dst_local, ldst - base, Vl)  # local id or pad
    lsrc_safe = torch.clamp(lsrc, max=Vl)
    ldst_safe = torch.clamp(ldst, max=Vp)
    slots = None
    if backend.needs_ell:
        # pad edges (row Vl, the slab's sink row) take slot 0
        slots = torch.where(real, edge_slots(lsrc, Vl), 0)
    # ell_width IS the true max degree here; pass it as max_degree too, so
    # a color_bound cap can't mask a truncated slab
    mex = backend.bind(num_vertices=Vl, max_colors=max_colors,
                       ell_slot=slots, ell_width=ell_width,
                       max_degree=ell_width if backend.needs_ell else -1)
    use_frontier = frontier_cap_v > 0
    if use_frontier:
        mex_slab = backend.bind_slab(
            capacity=frontier_cap_v, max_colors=max_colors,
            ell_width=ell_width,
            max_degree=ell_width if backend.needs_ell else -1)
        # per-shard incident-edge pointers, from the row-contiguous slab
        ldeg = torch.bincount(lsrc_safe, minlength=Vl + 1)[:Vl]
        lrow_ptr = torch.cat([ldeg.new_zeros(1),
                              torch.cumsum(ldeg, 0)]).to(torch.int32)
    if use_boundary and Bl > 0:
        Wb = halo_words(Bl, wire_colors)
        bnd_safe = torch.clamp(bnd, max=Vl)
        # the boundary->halo map is static: ONE gather before the loop
        # builds the global ids; pad entries carry the Vp sink
        bnd_gids = mesh.all_gather_tiled(
            torch.where(bnd < Vl, bnd + base, Vp)).long()      # [D*Bl]
    slab_cbits = int(wire_colors).bit_length()
    slab_packed = slab_entry_bytes(Vp, wire_colors) == 4

    def zpad(x):
        return torch.cat([x, x.new_zeros(1)])

    def full_solve(colors, pending, ppad, opad, snap_pad):
        # preceding local-pending neighbors track the live local colors,
        # everyone else contributes the frozen snapshot
        src_pending = ppad[lsrc_safe] & real
        precede = ppad[dst_loc] & (opad[dst_loc] < opad[lsrc_safe])
        spec = SweepSpec(key_v=torch.where(src_pending, lsrc, Vl),
                         dyn_idx=dst_loc, dyn=precede,
                         static_c=snap_pad[ldst_safe])
        colors, n_sweeps, _ = fixpoint_sweep(
            mex, spec, torch.where(pending, 0, colors), pending,
            max_sweeps=max_sweeps)
        return colors, n_sweeps

    def slab_solve(slab, colors, ppad, opad, snap_pad):
        e_local = (slab.dst >= base) & (slab.dst < base + Vl)
        e_loc = torch.where(e_local, slab.dst - base, Vl)
        precede = ppad[e_loc] & (opad[e_loc] < opad[torch.clamp(slab.src,
                                                                max=Vl)])
        live = slab.src < Vl
        cpad0 = zpad(colors)
        cpad0[slab.vert] = 0          # empty rows (vert == Vl) hit slot Vl
        cpad, n_sweeps, _ = frontier_sweep(
            mex_slab,
            key_v=torch.where(live, slab.owner, frontier_cap_v),
            dyn=precede, dyn_idx=e_loc,
            static_c=snap_pad[torch.clamp(slab.dst, max=Vp)],
            slot=slab.slot, write_vert=slab.vert, cpad0=cpad0,
            max_sweeps=max_sweeps)
        return cpad[:Vl], n_sweeps

    def full_wire(colors, pending, ppad, snap):
        packed = ((colors << 1) | pending.to(torch.int32)).to(torch.int16)
        glob = mesh.all_gather_tiled(packed).to(torch.int32)   # [Vp]
        return glob >> 1, (glob & 1).to(torch.bool)

    def boundary_wire(colors, pending, ppad, snap):
        # only boundary entries cross the wire; the rank's own slice needs
        # no collective at all
        pend = torch.zeros((Vp + 1,), dtype=torch.bool, device=dev)
        if Bl > 0:
            words = pack_halo(zpad(colors)[bnd_safe], ppad[bnd_safe],
                              wire_colors)                      # [Wb]
            gw = mesh.all_gather_tiled(words).reshape(D, Wb)
            gcol, gpend = unpack_halo(gw, Bl, wire_colors)      # [D, Bl]
            buf = zpad(snap)
            buf[bnd_gids] = gcol.reshape(-1)
            snap = buf[:Vp]
            pend[bnd_gids] = gpend.reshape(-1)
        # no cross-shard edges at all (D=1, or disconnected shards): the
        # local patch is the whole exchange
        pend = pend[:Vp]
        snap[base:base + Vl] = colors
        pend[base:base + Vl] = pending
        return snap, pend

    def slab_wire(slab, colors, snap):
        # only this round's pending vertices changed color or pending
        # state: gather (gid, color) of every rank's slab rows
        gids = torch.where(slab.vert < Vl, slab.vert + base, Vp)
        cols = zpad(colors)[torch.clamp(slab.vert, max=Vl)]
        if slab_packed:
            words = (gids.to(torch.int64) << slab_cbits) | cols.to(torch.int64)
            words = torch.where(words >= (1 << 31), words - _WORD, words)
            gw = mesh.all_gather_tiled(words.to(torch.int32))
            gw = gw.to(torch.int64) & (_WORD - 1)
            g_gids = gw >> slab_cbits
            g_cols = (gw & ((1 << slab_cbits) - 1)).to(torch.int32)
        else:
            g_gids = mesh.all_gather_tiled(gids).long()
            g_cols = mesh.all_gather_tiled(cols)
        buf = zpad(snap)
        buf[g_gids] = g_cols
        pend = torch.zeros((Vp + 1,), dtype=torch.bool, device=dev)
        pend[g_gids] = True
        return buf[:Vp], pend[:Vp]

    round_wire = boundary_wire if use_boundary else full_wire
    colors = torch.zeros((Vl,), **i32)
    pending = torch.ones((Vl,), dtype=torch.bool, device=dev)
    snap = torch.zeros((Vp,), **i32)   # snapshot: all uncolored
    report_state(colors, pending, snap)
    conf_hist = np.zeros(max_rounds, np.int32)
    sweep_hist = np.zeros(max_rounds, np.int32)
    front_hist = np.zeros(max_rounds, np.int32)
    rnd, total = 0, 1
    while total > 0 and rnd < max_rounds:
        report_round(rnd)
        # (1) last round's snapshot view. ALL nonzero colors forbid, stale
        # colors of re-pending vertices included (one exchange per round
        # serves phase 1 and the conflict pass)
        snap_pad = zpad(snap)
        ppad = zpad(pending)
        offset = lockstep_offsets(pending, C)
        opad = torch.cat([offset, offset.new_full((1,), _INT32_MAX)])
        fits_solve = all_fit = False
        slab = None
        if use_frontier:
            nv, ne = torch.stack(frontier_counts(pending, lrow_ptr)).tolist()
            fits_solve = (rnd > 0 and nv <= frontier_cap_v
                          and ne <= frontier_cap_e)
            # the slab wire only needs the pending VERTICES to fit, on
            # every rank: the vote, in every round, on every rank
            fits_wire = rnd > 0 and nv <= frontier_cap_v
            vote = torch.tensor([0 if fits_wire else 1,
                                 nv if fits_wire else 0], **i32)
            n_spill, front = mesh.all_reduce_sum(vote).tolist()
            all_fit = n_spill == 0
            if fits_solve or all_fit:
                # slab rows are LOCAL ids, edge targets stay GLOBAL
                slab = compact_frontier(pending, lrow_ptr, ldst,
                                        frontier_cap_v, frontier_cap_e,
                                        dst_pad=Vp)
        # (2) local sequential greedy as an offset-DAG fixpoint (no comms)
        if fits_solve:
            report_path("frontier round")
            colors, n_sweeps = slab_solve(slab, colors, ppad, opad, snap_pad)
        else:
            if use_frontier and rnd > 0:
                report_path("slab spill")
            colors, n_sweeps = full_solve(colors, pending, ppad, opad,
                                          snap_pad)
        # (3) the wire
        if all_fit:
            report_path("frontier-slab wire")
            snap, pend_glob = slab_wire(slab, colors, snap)
        else:
            snap, pend_glob = round_wire(colors, pending, ppad, snap)
        # (4) same-round conflicts, higher gid recolors: the masked view is
        # 0 at every non-pending vertex and at the Vp sink, and a pending
        # vertex holds a color >= 1 after phase 1
        masked = zpad(torch.where(pend_glob, snap, 0))
        if fits_solve:
            gsrc_e = torch.where(slab.src < Vl, slab.src + base, Vp)
            dst_e = torch.clamp(slab.dst, max=Vp)
            new_pending = conflict_rows(masked[gsrc_e], masked[dst_e],
                                        gsrc_e, slab.dst, slab.src, Vl)
        else:
            new_pending = conflict_rows(masked[gsrc], masked[ldst_safe],
                                        gsrc, ldst, lsrc_safe, Vl)
        # (5) global termination vote
        total = int(mesh.all_reduce_sum(
            new_pending.sum(dtype=torch.int32).reshape(1)).item())
        conf_hist[rnd] = total
        sweep_hist[rnd] = n_sweeps
        if use_frontier and all_fit:
            front_hist[rnd] = front
        pending = new_pending
        rnd += 1
    report_loop_exit()
    return colors, rnd, conf_hist, sweep_hist, front_hist


def build_distributed_coloring(mesh: ProcessMesh, verts_local: int,
                               edges_local: int, local_concurrency: int = 1,
                               max_rounds: int = 64, max_sweeps: int = 16384,
                               engine: EngineSpec = "sort",
                               max_colors: int = 0, ell_width: int = 0,
                               frontier_cap_v: int = 0,
                               frontier_cap_e: int = 0,
                               wire: str = "boundary",
                               wire_colors: int = 0):
    """Build the coloring program of a mesh for fixed slab shapes.

    Returns ``fn(lsrc [D, El], ldst [D, El], bnd [D, Bl]) -> (colors [Vp]
    tensor on the mesh's device, rounds, conflicts_per_round,
    sweeps_per_round, frontier_per_round)``. Every rank passes the whole
    layout and runs its own row; colors come back gathered on every rank,
    ``rounds`` and ``sweeps_per_round`` maxed across ranks (the deepest
    local fixpoint each round), ``frontier_per_round`` the global frontier
    size when the round took the slab wire, else 0.

    ``engine`` picks the local first-fit backend; ``max_colors`` (global
    Delta+1, possibly capped by ``color_bound``) sizes the table engines;
    ``ell_width`` (the max degree) is required by the ELL engines.
    ``frontier_cap_v``/``frontier_cap_e`` enable the per-shard frontier
    slabs. ``wire`` picks the round exchange (:func:`_bsp_local`);
    ``wire_colors`` is the *uncapped* Delta+1 sizing the packed entries.
    With ``wire="full"`` the ``bnd`` operand is ignored."""
    backend = get_backend(engine)
    if backend.needs_ell and ell_width <= 0:
        raise ValueError(f"engine={backend.name!r} needs ell_width (the max "
                         "degree across owned vertices) — color_distributed "
                         "wires it from the host graph automatically")
    if backend.needs_color_bound and max_colors <= 0:
        raise ValueError(
            f"engine={backend.name!r} needs max_colors (global Delta+1) — "
            "color_distributed wires it from the host graph automatically")
    D = mesh.num_devices
    dev = mesh.device

    def row(x) -> torch.Tensor:
        x = x[mesh.rank]
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.int32)
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    def run(lsrc, ldst, bnd):
        if tuple(lsrc.shape) != (D, edges_local) \
                or tuple(ldst.shape) != (D, edges_local) or bnd.shape[0] != D:
            raise ValueError(
                f"program built for [{D}, {edges_local}] edge slabs and "
                f"[{D}, Bl] halos, got {tuple(lsrc.shape)}, "
                f"{tuple(ldst.shape)}, {tuple(bnd.shape)}")
        colors, rnd, conf, sweeps, fronts = _bsp_local(
            mesh, row(lsrc), row(ldst), row(bnd),
            verts_local=verts_local, local_concurrency=local_concurrency,
            max_rounds=max_rounds, max_sweeps=max_sweeps, backend=backend,
            max_colors=max_colors, ell_width=ell_width,
            frontier_cap_v=frontier_cap_v, frontier_cap_e=frontier_cap_e,
            wire=wire, wire_colors=wire_colors)
        colors = mesh.all_gather_tiled(colors)
        maxed = mesh.all_reduce_max(torch.from_numpy(
            np.append(sweeps, np.int32(rnd))).to(dev)).cpu().numpy()
        return colors, int(maxed[-1]), conf, maxed[:-1], fronts

    return run


def color_distributed(graph, mesh: Optional[ProcessMesh] = None,
                      local_concurrency: int = 1, max_rounds: int = 64,
                      engine: EngineSpec = "sort", color_bound: int = 0,
                      model: str = "d1", device: DeviceSpec = None):
    """End-to-end on every rank of ``mesh``: partition on the host, color
    the rank's shard, return ``(colors [V], rounds, conflicts_per_round)``
    (colors ``[num_left]`` under ``model="pd2"``). ``mesh=None`` is one
    shard with no process group on ``device`` (``None`` = the card).

    Shim over the registered ``"distributed"`` strategy, kept for its
    legacy return shape; ``repro_torch.core.color(graph,
    strategy="distributed", mesh=mesh)`` gives the full report.
    ``color_bound`` optionally caps the table engines' color capacity
    below Delta+1 (a caller-asserted bound)."""
    from .api import ColoringSpec, get_strategy  # lazy: api imports us
    spec = ColoringSpec(strategy="distributed", model=model, engine=engine,
                        max_rounds=max_rounds, max_sweeps=16384,
                        color_bound=int(color_bound), mesh=mesh,
                        local_concurrency=local_concurrency)
    raw = get_strategy("distributed").oneshot(spec, graph, device)
    return (raw.colors.cpu().numpy(), int(raw.rounds),
            np.asarray(raw.conflicts_per_round))
