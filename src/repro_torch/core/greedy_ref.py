"""Serial greedy distance-1 coloring oracle (paper Alg. 1).

The exact first-fit formulation with the *vertex-stamped*
``forbiddenColors`` array (no per-vertex reinitialization; O(|V|+|E|)
total), the foundation of the parallel algorithms. numpy/host-side: the
reference DATAFLOW reproduces exactly.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


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


def num_colors(colors: np.ndarray) -> int:
    return int(colors.max()) if colors.size else 0
