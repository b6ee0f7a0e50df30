"""The coloring-model layer: distance-2 and partial distance-2 lowerings
(PyTorch port of ``repro.core.distance2``).

The engine colors *constraint graphs*: its SweepSpec edge space is just
"who forbids whom". The coloring models differ ONLY in that edge space:

* ``model="d1"``  — the graph's edges (adjacent vertices differ);
* ``model="d2"``  — pairs at distance <= 2 differ: distance-1 coloring of
  the square graph G², whose constraints are the wedges v—w—u plus the
  distance-1 pairs;
* ``model="pd2"`` — bipartite partial distance-2: color ONE vertex class
  of a :class:`repro_torch.core.graph.BipartiteGraph` so that two
  same-class vertices sharing a neighbor differ (column compression of a
  sparse Jacobian). Constraints are the wedges through the other class.

So a model is one host-side lowering: no new sweep loop, no new engine,
and the engines' bit parity carries over.

Two lowering strategies (``strategy=``):

* ``"wedge"``  — the wedge *multiset*: per directed edge (v, w), one entry
  per u in adj(w), self wedges v—w—v sent to the phantom vertex V (the
  port's sink row). No sort, no dedup; duplicate forbids are harmless to
  the mex and invisible to the per-vertex conflict count. Edges layout
  only: no CSR/ELL geometry, no ``inc_ptr`` (so no frontier rounds).
* ``"square"`` — G² as a host :class:`Graph` via :func:`square` (sort +
  dedup over the same pairs): every DeviceGraph layout, the ELL engines
  included.
* ``"auto"``   — ``"square"`` when the ELL layout or edge padding is
  requested, else ``"wedge"``.

Both give the same constraint *set*, so colors, rounds and histories are
bit-identical under either.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .graph import BipartiteGraph, DeviceGraph, DeviceSpec, Graph, \
    resolve_device

MODELS = ("d1", "d2", "pd2")
_STRATEGIES = ("auto", "wedge", "square")


# --------------------------------------------------------------------------
# host-side wedge expansion
# --------------------------------------------------------------------------
def _expand_rows(row_ptr: np.ndarray, col_idx: np.ndarray,
                 targets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate the CSR rows of ``targets`` (repeats preserved).

    Returns (values, counts): ``values`` is the concatenation of
    ``col_idx[row_ptr[t]:row_ptr[t+1]]`` for each t in ``targets`` in
    order, ``counts[i]`` the length ``targets[i]`` contributed."""
    counts = (row_ptr[targets + 1] - row_ptr[targets]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int32), counts
    block_starts = np.cumsum(counts) - counts
    pos = np.arange(total, dtype=np.int64) - np.repeat(block_starts, counts)
    return col_idx[np.repeat(row_ptr[targets], counts) + pos], counts


def wedge_count(graph: Graph) -> int:
    """W = sum over directed edges (v, w) of deg(w): the size of the D2
    wedge multiset before the 2E distance-1 pairs are added."""
    _src, dst = graph.directed_edges()
    deg = graph.degrees()
    return int(deg[dst].sum())


def d2_pairs(graph: Graph) -> Tuple[np.ndarray, np.ndarray, int]:
    """The distance-<=2 constraint multiset as (src, dst, live) arrays.

    Per directed edge (v, w), the block [(v, w), (v, u) for u in adj(w)],
    so the result is row-contiguous in ``src``. Self wedges v—w—v go to
    the phantom vertex V at both ends. ``live`` counts the other entries."""
    V = graph.num_vertices
    src, dst = graph.directed_edges()
    two_hop, counts = _expand_rows(graph.row_ptr, graph.col_idx, dst)
    sizes = counts + 1
    total = int(sizes.sum())
    fsrc = np.repeat(src, sizes).astype(np.int32)
    fdst = np.empty(total, np.int32)
    starts = np.cumsum(sizes) - sizes
    head = np.zeros(total, np.bool_)
    head[starts] = True
    fdst[head] = dst
    fdst[~head] = two_hop
    self_pair = fsrc == fdst  # only wedges u == v; d1 pairs have no loops
    fsrc[self_pair] = V
    fdst[self_pair] = V
    return fsrc, fdst, total - int(self_pair.sum())


def square(graph: Graph) -> Graph:
    """G² as a host :class:`Graph`: an edge between every pair at distance
    1 or 2. Distance-2 coloring of G is distance-1 coloring of G²."""
    fsrc, fdst, _ = d2_pairs(graph)
    keep = fsrc < graph.num_vertices
    return Graph.from_edges(graph.num_vertices,
                            np.stack([fsrc[keep], fdst[keep]], axis=1))


def pd2_pairs(bg: BipartiteGraph, side: str = "left"
              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The partial-D2 constraint multiset over one vertex class: per
    (v, r) edge, one entry (v, u) for each u in adj(r), self pairs sent to
    the phantom vertex. Row-contiguous in the colored class."""
    if side == "left":
        n, a_ptr, a_idx, b_ptr, b_idx = (bg.num_left, bg.l2r_ptr, bg.l2r_idx,
                                         bg.r2l_ptr, bg.r2l_idx)
    elif side == "right":
        n, a_ptr, a_idx, b_ptr, b_idx = (bg.num_right, bg.r2l_ptr, bg.r2l_idx,
                                         bg.l2r_ptr, bg.l2r_idx)
    else:
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    deg = np.diff(a_ptr).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    back, counts = _expand_rows(b_ptr, b_idx, a_idx)
    fsrc = np.repeat(src, counts).astype(np.int32)
    fdst = back.astype(np.int32)
    self_pair = fsrc == fdst
    fsrc[self_pair] = n
    fdst[self_pair] = n
    return fsrc, fdst, fsrc.shape[0] - int(self_pair.sum())


def partial_square(bg: BipartiteGraph, side: str = "left") -> Graph:
    """The one-mode projection of ``bg`` onto ``side``: a host
    :class:`Graph` joining same-class vertices that share a neighbor. PD2
    coloring of ``bg`` is distance-1 coloring of this graph."""
    n = bg.num_left if side == "left" else bg.num_right
    fsrc, fdst, _ = pd2_pairs(bg, side)
    keep = fsrc < n
    return Graph.from_edges(n, np.stack([fsrc[keep], fdst[keep]], axis=1))


# --------------------------------------------------------------------------
# DeviceGraph lowerings
# --------------------------------------------------------------------------
def _multiset_device_graph(num_vertices: int, fsrc: np.ndarray,
                           fdst: np.ndarray, live: int,
                           device: DeviceSpec = None) -> DeviceGraph:
    """A constraint-pair multiset as an edges-layout DeviceGraph on
    ``device``. ``max_degree`` is the max *multiset* row count, an
    over-bound on the true constraint degree, so tables sized from it
    never drop a forbid."""
    dev = resolve_device(device)
    row_count = np.bincount(fsrc[fsrc < num_vertices],
                            minlength=num_vertices)
    return DeviceGraph(
        num_vertices=num_vertices,
        num_directed_edges=live,
        src=torch.from_numpy(np.ascontiguousarray(fsrc, np.int32)).to(dev),
        dst=torch.from_numpy(np.ascontiguousarray(fdst, np.int32)).to(dev),
        max_degree=int(row_count.max()) if row_count.size else 0,
    )


def d2_device_graph(graph: Graph, *, strategy: str = "auto",
                    layout: Union[str, Sequence[str]] = "edges",
                    pad_edges_to: Optional[int] = None,
                    device: DeviceSpec = None) -> DeviceGraph:
    """Lower ``graph`` to the distance-2 constraint DeviceGraph on
    ``device`` (``None`` = the card)."""
    strategy = _resolve_strategy(strategy, layout, pad_edges_to)
    if strategy == "square":
        return square(graph).to_device(layout=layout,
                                       pad_edges_to=pad_edges_to,
                                       device=device)
    return _multiset_device_graph(graph.num_vertices, *d2_pairs(graph),
                                  device=device)


def pd2_device_graph(bg: BipartiteGraph, *, side: str = "left",
                     strategy: str = "auto",
                     layout: Union[str, Sequence[str]] = "edges",
                     pad_edges_to: Optional[int] = None,
                     device: DeviceSpec = None) -> DeviceGraph:
    """Lower one class of ``bg`` to its partial-D2 constraint DeviceGraph
    (vertices = the colored class) on ``device``."""
    strategy = _resolve_strategy(strategy, layout, pad_edges_to)
    if strategy == "square":
        return partial_square(bg, side).to_device(
            layout=layout, pad_edges_to=pad_edges_to, device=device)
    n = bg.num_left if side == "left" else bg.num_right
    return _multiset_device_graph(n, *pd2_pairs(bg, side), device=device)


def _resolve_strategy(strategy: str, layout: Union[str, Sequence[str]],
                      pad_edges_to: Optional[int] = None) -> str:
    """Pick or validate the lowering. The wedge multiset has no CSR/ELL
    geometry and a data-dependent length, so CSR/ELL layouts and
    ``pad_edges_to`` force (under ``"auto"``) or require (explicitly) the
    square lowering."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"choose from {_STRATEGIES}")
    layouts = (layout,) if isinstance(layout, str) else tuple(layout)
    needs_square = (pad_edges_to is not None
                    or "ell" in layouts or "csr" in layouts)
    if strategy == "auto":
        return "square" if needs_square else "wedge"
    if strategy == "wedge" and needs_square:
        raise ValueError(
            "strategy='wedge' emits an edge multiset (duplicates, inert "
            "masks) with no CSR/ELL geometry or shape padding; use "
            f"strategy='square' for layout={layouts}, "
            f"pad_edges_to={pad_edges_to}")
    return strategy


# --------------------------------------------------------------------------
# the model= entry point the strategies thread through
# --------------------------------------------------------------------------
def as_constraint_graph(g, model: str = "d1", *, needs_ell: bool = False,
                        strategy: str = "auto", side: str = "left",
                        device: DeviceSpec = None) -> DeviceGraph:
    """Resolve a strategy's ``(g, model=)`` to the constraint DeviceGraph the
    engine colors, on ``device`` (``None`` = the card; a DeviceGraph stays
    where it lies).

    Accepted ``g`` per model: d1 — DeviceGraph (as-is) or host Graph; d2 —
    host Graph (the two-hop expansion reads the CSR); pd2 —
    BipartiteGraph, ``side`` picks the colored class. ``needs_ell`` (an
    ELL engine) forces the ELL-capable lowering."""
    if model not in MODELS:
        raise ValueError(f"unknown coloring model {model!r}; "
                         f"choose from {MODELS}")
    layout = ("edges", "ell") if needs_ell else "edges"
    if isinstance(g, DeviceGraph):
        if model != "d1":
            raise ValueError(
                f"model={model!r} needs the host graph (two-hop expansion "
                "reads the host CSR): pass a Graph"
                + ("/BipartiteGraph" if model == "pd2" else "")
                + " instead of a DeviceGraph")
        return g
    if isinstance(g, BipartiteGraph):
        if model != "pd2":
            raise ValueError(
                f"BipartiteGraph only supports model='pd2' (got "
                f"model={model!r}); project it to a Graph first for "
                "d1/d2 semantics")
        return pd2_device_graph(g, side=side, strategy=strategy,
                                layout=layout, device=device)
    if not isinstance(g, Graph):
        raise TypeError(f"expected Graph/BipartiteGraph/DeviceGraph, "
                        f"got {type(g).__name__}")
    if model == "pd2":
        raise ValueError("model='pd2' needs a BipartiteGraph (which vertex "
                         "class would be colored?)")
    if model == "d1":
        return g.to_device(layout=layout, device=device)
    return d2_device_graph(g, strategy=strategy, layout=layout,
                           device=device)


def constraint_host_graph(g, model: str = "d1", *,
                          side: str = "left") -> Graph:
    """The host constraint :class:`Graph` of ``(g, model)``, always through
    the exact ``square`` lowering: what plans lower, relabel and pad."""
    if model not in MODELS:
        raise ValueError(f"unknown coloring model {model!r}; "
                         f"choose from {MODELS}")
    if isinstance(g, BipartiteGraph):
        if model != "pd2":
            raise ValueError(f"BipartiteGraph only supports model='pd2' "
                             f"(got model={model!r})")
        return partial_square(g, side)
    if not isinstance(g, Graph):
        raise TypeError(f"expected Graph/BipartiteGraph, "
                        f"got {type(g).__name__}")
    if model == "pd2":
        raise ValueError("model='pd2' needs a BipartiteGraph")
    return g if model == "d1" else square(g)
