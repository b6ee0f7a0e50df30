"""Serial greedy coloring oracles: distance-1 (paper Alg. 1), distance-2
and bipartite partial distance-2.

All three are the exact first-fit formulation with the *vertex-stamped*
``forbiddenColors`` array (no per-vertex reinitialization; O(|V|+|E|)
total for D1, O(sum of two-hop neighborhood sizes) for D2/PD2), the
foundation of the parallel algorithms. numpy/host-side: DATAFLOW under
``model="d1"``/``"d2"``/``"pd2"`` reproduces :func:`greedy_color` /
:func:`greedy_color_d2` / :func:`greedy_color_pd2` exactly.
"""
from __future__ import annotations

import numpy as np

from .graph import BipartiteGraph, Graph


def greedy_color(graph: Graph, order: np.ndarray | None = None) -> np.ndarray:
    """Color ``graph`` greedily visiting vertices in ``order``.

    Returns colors[V] (1-based; every vertex colored). With ``order=None``
    vertices are visited in natural index order — the order the parallel
    DATAFLOW algorithm reproduces exactly.
    """
    n = graph.num_vertices
    if order is None:
        order = np.arange(n, dtype=np.int64)
    colors = np.zeros(n, dtype=np.int32)
    # stamped with the vertex id being colored; init with a value not in V
    forbidden = np.full(graph.max_degree() + 2, -1, dtype=np.int64)
    row_ptr, col_idx = graph.row_ptr, graph.col_idx
    for v in order:
        nbrs = col_idx[row_ptr[v]:row_ptr[v + 1]]
        nc = colors[nbrs]
        forbidden[nc[nc > 0]] = v  # mark colors of colored neighbors
        # smallest positive index not stamped with v
        c = 1
        while forbidden[c] == v:
            c += 1
        colors[v] = c
    return colors


def greedy_color_d2(graph: Graph, order: np.ndarray | None = None) -> np.ndarray:
    """Serial greedy *distance-2* coloring: first-fit over the colors of
    every vertex within two hops. Equivalent to :func:`greedy_color` on the
    square graph G², computed from the CSR without materializing G²."""
    n = graph.num_vertices
    if order is None:
        order = np.arange(n, dtype=np.int64)
    colors = np.zeros(n, dtype=np.int32)
    deg = np.diff(graph.row_ptr)
    row_ptr, col_idx = graph.row_ptr, graph.col_idx
    # D2 degree <= sum of neighbor degrees; +2 for the 1-based scan past it
    bound = 2
    if deg.size and graph.num_directed_edges:
        src, dst = graph.directed_edges()
        bound = int(np.bincount(src, weights=deg[dst], minlength=n).max()) + 2
    forbidden = np.full(bound, -1, dtype=np.int64)
    for v in order:
        nbrs = col_idx[row_ptr[v]:row_ptr[v + 1]]
        if nbrs.size:
            two_hop = np.concatenate(
                [nbrs] + [col_idx[row_ptr[w]:row_ptr[w + 1]] for w in nbrs])
            nc = colors[two_hop[two_hop != v]]
            forbidden[nc[nc > 0]] = v
        c = 1
        while forbidden[c] == v:
            c += 1
        colors[v] = c
    return colors


def greedy_color_pd2(bg: BipartiteGraph, order: np.ndarray | None = None,
                     side: str = "left") -> np.ndarray:
    """Serial greedy *partial distance-2* coloring of one class of a
    bipartite graph: first-fit over the colors of same-class vertices
    reachable through a shared neighbor. Returns colors for the ``side``
    class only."""
    if side == "left":
        n, a_ptr, a_idx, b_ptr, b_idx = (bg.num_left, bg.l2r_ptr, bg.l2r_idx,
                                         bg.r2l_ptr, bg.r2l_idx)
    elif side == "right":
        n, a_ptr, a_idx, b_ptr, b_idx = (bg.num_right, bg.r2l_ptr, bg.r2l_idx,
                                         bg.l2r_ptr, bg.l2r_idx)
    else:
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if order is None:
        order = np.arange(n, dtype=np.int64)
    colors = np.zeros(n, dtype=np.int32)
    other_deg = np.diff(b_ptr)
    bound = 2
    if n and bg.num_edges:
        deg = np.diff(a_ptr)
        src = np.repeat(np.arange(n), deg)
        bound = int(np.bincount(src, weights=other_deg[a_idx],
                                minlength=n).max()) + 2
    forbidden = np.full(bound, -1, dtype=np.int64)
    for v in order:
        nbrs = a_idx[a_ptr[v]:a_ptr[v + 1]]
        if nbrs.size:
            peers = np.concatenate(
                [b_idx[b_ptr[r]:b_ptr[r + 1]] for r in nbrs])
            nc = colors[peers[peers != v]]
            forbidden[nc[nc > 0]] = v
        c = 1
        while forbidden[c] == v:
            c += 1
        colors[v] = c
    return colors


def num_colors(colors: np.ndarray) -> int:
    return int(colors.max()) if colors.size else 0
