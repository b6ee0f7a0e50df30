"""The pluggable speculative-coloring engine (PyTorch port).

The paper's central finding is that ONE scheme — speculate, then resolve —
spans radically different machines once two inner pieces are specialized
per architecture: the first-fit ("mex") inner loop and the conflict pass.

* :class:`MexBackend` — a named, registered first-fit engine. Four ship,
  under the reference's registry names so one ``ColoringSpec`` means the
  same thing to both packages:

  - ``"sort"``         the segmented sort-based mex
                       (:func:`repro_torch.core.mex.segment_mex`) — any
                       edge-list layout, no color bound needed;
  - ``"bitmap"``       a dense per-vertex forbidden table built with one
                       scatter over the edge list, then a first-free scan;
                       needs a color bound, taken from the graph's max degree;
  - ``"ell_pallas"``   in this port: the hand-written CUDA ``firstfit``
                       kernel (``kernels/csrc/firstfit.cu``) over an ELL
                       slab, fed by an O(E) edge→(row, slot) scatter; needs
                       the graph built with ``to_device(layout="ell")``;
  - ``"fused_pallas"`` in this port: the hand-written CUDA ``round_fused``
                       kernel (``kernels/csrc/round_fused.cu``) — the same
                       bitmask mex fused with the Alg. 2 conflict predicate
                       in one slab read (ELL requirements as ``ell_pallas``).

  The two ``*_pallas`` names keep the reference's spelling; on CPU tensors
  their kernels run as the plain PyTorch versions.

* :class:`SweepSpec` — the per-round edge-space description every algorithm
  lowers its precedence semantics into.

* :func:`fixpoint_sweep` — THE speculation inner loop, a host loop of
  chaotic sweeps ``c[v] <- mex{contribution(e) : e forbids v}`` (pending v
  only) until nothing changes; one host sync per sweep for the convergence
  test. The sweep count includes the final no-change sweep. It and the
  other speculation helpers take one graph or a batch (``[B, ...]``, the
  block-diagonal union ``ColoringPlan.map`` colors); one graph runs as a
  batch of one.

Every reference ``mode="drop"`` scatter becomes a write into an explicit
sink row or column: an out-of-range ``index_put_`` raises in torch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.conflict import conflict_mask
from ..kernels.firstfit import firstfit
from ..kernels.ops import host_read, report_state, span
from ..kernels.ref import table_mex
from ..kernels.round_fused import COLOR_MASK, FORBID_BIT, round_fused
from .graph import batch_index
from .mex import segment_mex

# A bound mex engine: (key_v [M], key_c [M]) -> mex [V] int32 (>= 1).
# key_v[i] is the vertex the edge forbids (num_vertices = inert padding);
# key_c[i] the forbidden color (0 = no constraint).
MexFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# A slab-bound mex engine (the frontier path): (key_v [cap_e] slab rows,
# key_c [cap_e], slot [cap_e] within-row positions) -> mex [cap_v].
SlabMexFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class SweepSpec(NamedTuple):
    """Per-round, edge-space description of 'who forbids whom with what'.

    key_v:    [M] int32 in [0, V]; V marks an inert edge this round.
    dyn_idx:  [M] int32 in [0, V]; gather index into the live (padded)
              color vector for dynamic contributions.
    dyn:      [M] bool; True = contribution re-read from the live colors
              every sweep, False = frozen at ``static_c`` for the round.
    static_c: [M] int32; the frozen contribution (0 where unused).
    """

    key_v: torch.Tensor
    dyn_idx: torch.Tensor
    dyn: torch.Tensor
    static_c: torch.Tensor


def num_color_words(max_colors: int) -> int:
    """uint32 words needed so colors [1, max_colors] AND the next free
    candidate all fit: 32*words >= max_colors + 2."""
    return max(1, -(-(int(max_colors) + 2) // 32))


def _resolve_words(words: Optional[int], max_colors: int, name: str) -> int:
    """Shared words-capacity resolution for table-based backends. A color
    bound is always required — an unbounded table can silently drop forbids
    and corrupt colorings — so a ``words=`` override adjusts capacity above
    the bound rather than substituting for it."""
    if max_colors <= 0:
        raise ValueError(
            f"{name} engine needs a static color bound: build the graph "
            "via Graph.to_device() (it carries max_degree)")
    if max_colors > COLOR_MASK:
        # a color value at 2^28 IS round_fused's FORBID bit: a packed entry
        # carrying it would forbid nothing and conflict with everything, so
        # no table backend accepts a bound the packed layout cannot encode
        raise ValueError(
            f"{name} engine: max_colors={max_colors} exceeds the packed-"
            f"entry color field (bits 0..27, max {COLOR_MASK}); "
            "colors that large alias the FORBID/CONFLICT predicate bits")
    if words is not None:
        words = int(words)
        if words < num_color_words(max_colors):
            raise ValueError(
                f"{name} engine: words={words} gives {32 * words} color "
                f"slots, below the graph's Delta+2 bound of "
                f"{max_colors + 2}; use words >= {num_color_words(max_colors)}"
                " (or omit words to derive it)")
        return words
    return num_color_words(max_colors)


def ell_slab(rows: int, width: int, key_v: torch.Tensor, slot: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """Scatter ``values`` to ``(key_v, slot)`` of a zeroed ``(rows+1,
    width+1)`` int32 slab and return its ``[:rows, :width]`` view: row
    ``rows`` and column ``width`` are the sinks for inert and out-of-width
    edges, and the kernels read the view through its row stride, no copy."""
    slab = torch.zeros((rows + 1, width + 1), dtype=torch.int32,
                       device=values.device)
    slab.index_put_((key_v, slot), values)
    return slab[:rows, :width]


def _ell_width(name: str, ell_width: int, max_degree: int,
               max_colors: int) -> int:
    """The width of the slab an ELL bind scatters into, at least 1."""
    # completeness is judged against the TRUE max degree (not the possibly
    # color_bound-capped max_colors): a truncated ELL layout drops forbids
    # in the slab scatter and would silently corrupt colorings
    required = max_degree if max_degree >= 0 else max_colors - 1
    if required > 0 and ell_width < required:
        raise ValueError(
            f"{name} engine: ELL width {ell_width} is below the graph's max "
            f"degree {required}; rebuild with Graph.to_device(layout='ell') "
            "(full width)")
    return max(1, int(ell_width))


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MexBackend:
    """Base class: a named first-fit engine, bound per graph.

    ``bind`` receives everything static a backend may specialize on:
      num_vertices  segment count;
      max_colors    a static upper bound on any color value that can appear
                    (graph max degree + 1, possibly capped by color_bound;
                    0 = unknown);
      ell_slot      [M] int32 per-edge slot within its vertex row, or None;
      ell_width     static ELL slab width (max row length);
      max_degree    the graph's true max degree (-1 = unknown) — what ELL
                    completeness is checked against.
    It returns the per-sweep ``MexFn``.
    """

    name = "abstract"
    needs_ell = False          # True: bind() requires ell_slot/ell_width
    needs_color_bound = False  # True: bind() requires max_colors > 0

    def bind(self, *, num_vertices: int, max_colors: int = 0,
             ell_slot: Optional[torch.Tensor] = None,
             ell_width: int = 0, max_degree: int = -1) -> MexFn:
        raise NotImplementedError

    def bind_slab(self, *, capacity: int, max_colors: int = 0,
                  ell_width: int = 0, max_degree: int = -1) -> SlabMexFn:
        """Bind the backend to a fixed-capacity frontier slab
        (repro_torch.core.frontier): segments are the ``capacity`` slab
        rows. The returned callable takes a per-round ``slot`` operand
        (each edge's position within its slab row) so ELL-style backends
        can scatter a compacted slab. The default adapter covers
        layout-free backends; ``needs_ell`` backends override it."""
        if self.needs_ell:  # pragma: no cover - every needs_ell backend
            raise NotImplementedError(  # must provide its own slab bind
                f"mex backend {self.name!r} needs an ELL slab bind override")
        mex = self.bind(num_vertices=capacity, max_colors=max_colors,
                        max_degree=max_degree)
        return lambda key_v, key_c, slot: mex(key_v, key_c)


@dataclasses.dataclass(frozen=True)
class SortMexBackend(MexBackend):
    """Segmented-sort mex: layout-free, no color bound required."""

    name = "sort"

    def bind(self, *, num_vertices: int, max_colors: int = 0,
             ell_slot=None, ell_width: int = 0, max_degree: int = -1) -> MexFn:
        V = num_vertices

        def mex(key_v, key_c):
            # synthetic (v, 0) pairs guarantee every segment is populated;
            # the span counts every pair sorted, theirs included
            with span("mex.sort", n=int(key_v.shape[0]) + V):
                syn_v = torch.arange(V, dtype=torch.int32,
                                     device=key_v.device)
                return segment_mex(
                    torch.cat([key_v, syn_v]),
                    torch.cat([key_c, torch.zeros_like(syn_v)]), V)

        return mex


@dataclasses.dataclass(frozen=True)
class BitmapMexBackend(MexBackend):
    """Dense forbidden-table mex: one O(E) scatter over the edge list into a
    ``(V+1, C+1)`` byte table of C = 32*``words`` color slots (row V and
    column C are sinks: inert edges and colors >= C, which can never lower
    a mex that by the Delta+2 bound stays < C), then a first-free scan."""

    name = "bitmap"
    needs_color_bound = True
    words: Optional[int] = None

    def bind(self, *, num_vertices: int, max_colors: int = 0,
             ell_slot=None, ell_width: int = 0, max_degree: int = -1) -> MexFn:
        V = num_vertices
        C = 32 * _resolve_words(self.words, max_colors, self.name)
        return lambda key_v, key_c: table_mex(key_v, key_c, V, C)


@dataclasses.dataclass(frozen=True)
class _EllSlabBackend(MexBackend):
    """An engine whose kernel reads a dense ELL slab: each sweep's
    contributions scatter into the graph's (row, slot) geometry (an O(E)
    scatter, the irregular part), and :meth:`slab_mex` runs the kernel on
    the slab's ``[:rows, :width]`` view."""

    needs_ell = True
    needs_color_bound = True
    words: Optional[int] = None

    def slab_mex(self, rows: int, width: int, key_v: torch.Tensor,
                 slot: torch.Tensor, key_c: torch.Tensor,
                 words: int) -> torch.Tensor:
        raise NotImplementedError

    def bind(self, *, num_vertices: int, max_colors: int = 0,
             ell_slot=None, ell_width: int = 0, max_degree: int = -1) -> MexFn:
        if ell_slot is None:
            raise ValueError(
                f"{self.name} engine needs the ELL layout: build the graph "
                "with Graph.to_device(layout='ell')")
        D = _ell_width(self.name, ell_width, max_degree, max_colors)
        words = _resolve_words(self.words, max_colors, self.name)
        V = num_vertices
        return lambda key_v, key_c: self.slab_mex(V, D, key_v, ell_slot,
                                                  key_c, words)

    def bind_slab(self, *, capacity: int, max_colors: int = 0,
                  ell_width: int = 0, max_degree: int = -1) -> SlabMexFn:
        """Frontier bind: the kernel reads a compacted (capacity, D) slab
        scattered through the per-round ``slot`` operand."""
        D = _ell_width(self.name, ell_width if ell_width > 0 else max_degree,
                       max_degree, max_colors)
        words = _resolve_words(self.words, max_colors, self.name)
        cap = int(capacity)
        return lambda key_v, key_c, slot: self.slab_mex(cap, D, key_v, slot,
                                                        key_c, words)


@dataclasses.dataclass(frozen=True)
class EllPallasMexBackend(_EllSlabBackend):
    """The CUDA ``firstfit`` kernel (the port of the reference's Pallas
    ``ell_pallas`` engine) over the slab of neighbor colors."""

    name = "ell_pallas"

    def slab_mex(self, rows, width, key_v, slot, key_c, words):
        return firstfit(ell_slab(rows, width, key_v, slot, key_c),
                        words=words)


@dataclasses.dataclass(frozen=True)
class FusedPallasMexBackend(_EllSlabBackend):
    """The CUDA ``round_fused`` kernel (the port of the reference's Pallas
    ``fused_pallas`` engine): the ``firstfit`` bitmask mex PLUS the Alg. 2
    conflict predicate in ONE read of the ELL slab. Contributions scatter
    into the packed int32 entry slab (color | FORBID bit); the engine
    protocol pre-masks sweeps by precedence, so the algorithms consume only
    the mex lane (no CONFLICT bits are packed and ``own_colors`` is 0).
    Bit-identical to ``"bitmap"``/``"ell_pallas"`` by construction."""

    name = "fused_pallas"

    def slab_mex(self, rows, width, key_v, slot, key_c, words):
        ent = ell_slab(rows, width, key_v, slot, key_c | FORBID_BIT)
        mex, _ = round_fused(ent, torch.zeros((rows,), dtype=torch.int32,
                                              device=ent.device),
                             words=words)
        return mex


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_REGISTRY: Dict[str, MexBackend] = {}

EngineSpec = Union[str, MexBackend]


def register_backend(backend: MexBackend, *, overwrite: bool = False) -> MexBackend:
    """Register a backend instance under ``backend.name`` so every algorithm
    accepts it via ``engine="<name>"``."""
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"mex backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(engine: EngineSpec) -> MexBackend:
    """Resolve ``engine=`` — a registered name or a MexBackend instance."""
    if isinstance(engine, MexBackend):
        return engine
    try:
        return _REGISTRY[engine]
    except KeyError:
        raise ValueError(
            f"unknown mex backend {engine!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend(SortMexBackend())
register_backend(BitmapMexBackend())
register_backend(EllPallasMexBackend())
register_backend(FusedPallasMexBackend())


# --------------------------------------------------------------------------
# the shared speculation machinery
# --------------------------------------------------------------------------
def edge_slots(src: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Per-edge slot within its vertex row, for row-contiguous edge lists
    (CSR order): the device-side counterpart of the host ELL slot map."""
    m = src.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=src.device)
    row = torch.clamp(src, max=num_vertices).long()
    first = torch.full((num_vertices + 1,), m, dtype=torch.int32,
                       device=src.device)
    first.scatter_reduce_(0, row, idx, "amin")
    return idx - first[row]


def fixpoint_iterate(update, x0, *, max_iters: int):
    """Chaotic iteration x <- update(x) to a fixpoint (or ``max_iters``), as
    a host loop: each iteration's convergence test is one host sync.
    Returns (x, iters, still_changing) with Python scalars."""
    x, changed, n = x0, True, 0
    while changed and n < max_iters:
        xn = update(x)
        changed = bool(host_read(torch.any(xn != x), "iterate"))
        x, n = xn, n + 1
    return x, n, changed


def fixpoint_sweep(mex: MexFn, spec: SweepSpec, colors0: torch.Tensor,
                   pending: torch.Tensor, *, max_sweeps: int, live=None):
    """THE speculative inner loop (paper Alg. 2 phase 1 / Alg. 3-5): sweep
        c[v] <- mex{ contribution(e) : e forbids v }     for pending v
    to its fixpoint. ITERATIVE and DATAFLOW both call this — their
    differences live entirely in ``spec``.

    The color vector is carried padded with the phantom slot V (always 0),
    so contributions gather from it directly. ``colors0``/``pending`` are
    [V], or [B, V] for a batch (``ColoringPlan.map``): then ``spec`` lies
    in union space (``key_v`` union rows ``b*V + v``, sink ``B*V``;
    ``dyn_idx`` indices into the flattened [B, V+1] carrier) and ``live``
    ([B] host bool, default all) names the graphs that sweep. Each sweep
    launches the engine once for the batch and syncs once; a graph stops
    at its own fixpoint (its no-change sweep counted) and stays frozen
    from then on, as under the reference's ``vmap``. Returns
    (colors, sweeps, still_changing): [V], int and bool for one graph,
    [B, V] and two [B] host arrays for a batch."""
    if colors0.dim() == 1:
        c, n, act = fixpoint_sweep(mex, spec, colors0[None], pending[None],
                                   max_sweeps=max_sweeps)
        return c[0], int(n[0]), bool(act[0])
    B, V = colors0.shape
    report_state(colors0, pending)
    act = np.ones(B, np.bool_) if live is None else np.array(live, np.bool_)
    act_t = torch.as_tensor(act, device=colors0.device)
    n = np.zeros(B, np.int32)
    cpad = torch.cat([colors0, colors0.new_zeros((B, 1))], 1)
    k = 0
    while act.any() and k < max_sweeps:
        key_c = torch.where(spec.dyn, cpad.reshape(-1)[spec.dyn_idx],
                            spec.static_c)
        old = cpad[:, :V]
        new = torch.where(pending & act_t[:, None],
                          mex(spec.key_v, key_c).view(B, V), old)
        n += act
        act_t = act_t & (new != old).any(1)
        act = np.array(host_read(act_t, "sweep"), np.bool_)
        cpad, k = torch.cat([new, cpad[:, V:]], 1), k + 1
    return cpad[:, :V], n, act


def lockstep_offsets(pending: torch.Tensor, concurrency: int) -> torch.Tensor:
    """OpenMP-static superstep offsets over the pending set: rank within the
    pending set mod block size (paper Alg. 2's thread-block geometry).
    ``pending`` is [V], or [B, V] for a batch: the block size and the rank
    are each graph's own."""
    p = pending.to(torch.int32)
    r = p.sum(-1, keepdim=True, dtype=torch.int32)
    bs = torch.clamp((r + (concurrency - 1)) // concurrency, min=1)
    rank = torch.cumsum(p, -1, dtype=torch.int32) - 1
    return torch.where(pending, rank % bs, torch.zeros_like(rank))


def conflict_rows(masked_src: torch.Tensor, masked_dst: torch.Tensor,
                  src_ids: torch.Tensor, dst_ids: torch.Tensor,
                  rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Alg. 2 phase 2 through the ``conflict_mask`` kernel, with the ids
    the predicate compares apart from the rows it queues: edge e fires iff
    ``masked_src[e] == masked_dst[e] > 0`` and ``src_ids[e] > dst_ids[e]``
    (the masked colors are 0 at every non-pending endpoint), and an
    ``amax`` scatter into ``[num_rows+1]`` queues ``rows[e]`` (row
    ``num_rows`` = sink). The distributed conflict pass compares global ids
    and queues local rows. Returns the pending mask [num_rows] bool."""
    conf_e = conflict_mask(masked_src, masked_dst, src_ids, dst_ids)
    out = torch.zeros((num_rows + 1,), dtype=torch.int32, device=rows.device)
    out.scatter_reduce_(0, rows.long(), conf_e, "amax")
    return out[:num_rows].bool()


def conflict_pending(src: torch.Tensor, dst: torch.Tensor,
                     masked: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Alg. 2 phase 2 through the ``conflict_mask`` kernel: ``masked`` is
    the padded [V+1] color vector with 0 at every non-pending vertex and at
    the phantom slot V. Edge e fires iff both endpoints are pending, share
    a color and src > dst (padding edges, src == dst == V, never fire);
    an ``amax`` scatter queues each firing src. Returns the next round's
    pending mask [V] bool.

    For a batch ``src``/``dst`` are [B, M] local ids and ``masked`` is
    [B, V+1]: one launch covers all B*M edges, comparing local ids (both
    endpoints of an edge lie in one graph) and queueing carrier rows
    ``b*(V+1) + src`` (padding lands on its own graph's phantom row).
    Returns [B, V] bool."""
    if masked.dim() == 1:
        return conflict_pending(src[None], dst[None], masked[None],
                                num_vertices)[0]
    B, n_pad = masked.shape
    s = batch_index(torch.clamp(src, max=num_vertices), n_pad)
    d = batch_index(torch.clamp(dst, max=num_vertices), n_pad)
    flat = masked.reshape(-1)
    out = conflict_rows(flat[s], flat[d], src.reshape(-1), dst.reshape(-1),
                        s, B * n_pad)
    return out.view(B, n_pad)[:, :num_vertices]


def speculation_conflicts(src: torch.Tensor, dst: torch.Tensor,
                          colors: torch.Tensor, pending: torch.Tensor,
                          num_vertices: int) -> torch.Tensor:
    """Alg. 2 phase 2 on an edge list: monochromatic same-round pairs queue
    the higher-index endpoint. Returns the next round's pending mask
    (shapes as :func:`conflict_pending`, colors/pending [V] or [B, V]).

    Evaluated by the ``conflict_mask`` kernel on ``m = where(pending,
    colors, 0)``: after phase 1 every pending vertex holds a color >= 1, so
    ``m[src] == m[dst] & m[src] > 0`` is exactly the reference's
    ``pending[src] & pending[dst] & c[src] == c[dst]``."""
    masked = torch.where(pending, colors, torch.zeros_like(colors))
    pad = masked.new_zeros(masked.shape[:-1] + (1,))
    return conflict_pending(src, dst, torch.cat([masked, pad], -1),
                            num_vertices)
