"""Coloring validity / quality metrics (host side), for every coloring
model: distance-1, distance-2 and bipartite partial distance-2.

Colors may be a numpy array or a torch tensor on any device; they are
checked on the host against the host :class:`Graph`.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import BipartiteGraph, Graph


def _host(colors) -> np.ndarray:
    if isinstance(colors, torch.Tensor):
        return colors.detach().cpu().numpy()
    return np.asarray(colors)


def validate_coloring(graph: Graph, colors) -> bool:
    """True iff every vertex is colored (>0) and no edge is monochromatic."""
    colors = _host(colors)
    if colors.shape[0] < graph.num_vertices or (colors[: graph.num_vertices] <= 0).any():
        return False
    src, dst = graph.directed_edges()
    return not bool((colors[src] == colors[dst]).any())


def count_conflicts(graph: Graph, colors) -> int:
    """Number of undirected monochromatic edges."""
    colors = _host(colors)
    src, dst = graph.directed_edges()
    return int(((colors[src] == colors[dst]) & (src > dst)).sum())


def num_colors(colors) -> int:
    """Number of *distinct* positive colors in use (not ``colors.max()``:
    repair paths can leave gaps in the palette)."""
    colors = _host(colors)
    if not colors.size:
        return 0
    return int(np.unique(colors[colors > 0]).size)


# ------------------------------------------------------------- D2 / PD2
def validate_d2_coloring(graph: Graph, colors) -> bool:
    """True iff ``colors`` is a valid *distance-2* coloring: every vertex
    colored and no two vertices within two hops share a color. Checked on
    the wedge multiset directly (no G² materialization)."""
    from .distance2 import d2_pairs  # deferred: metrics stays light
    colors = _host(colors)
    if colors.shape[0] < graph.num_vertices or (colors[: graph.num_vertices] <= 0).any():
        return False
    fsrc, fdst, _ = d2_pairs(graph)
    cpad = np.concatenate([colors[: graph.num_vertices], [0]])
    live = fsrc < graph.num_vertices
    return not bool((cpad[fsrc[live]] == cpad[fdst[live]]).any())


def count_d2_conflicts(graph: Graph, colors) -> int:
    """Number of *distinct* unordered distance-<=2 pairs sharing a color."""
    from .distance2 import square
    return count_conflicts(square(graph), colors)


def validate_pd2_coloring(bg: BipartiteGraph, colors,
                          side: str = "left") -> bool:
    """True iff ``colors`` (one entry per ``side`` vertex) is a valid
    partial distance-2 coloring: every ``side`` vertex colored, and the
    neighbors of each opposite-class vertex have pairwise-distinct colors."""
    n = bg.num_left if side == "left" else bg.num_right
    ptr, idx = ((bg.r2l_ptr, bg.r2l_idx) if side == "left"
                else (bg.l2r_ptr, bg.l2r_idx))
    colors = _host(colors)
    if colors.shape[0] < n or (colors[:n] <= 0).any():
        return False
    if not idx.size:
        return True
    rows = np.repeat(np.arange(ptr.shape[0] - 1), np.diff(ptr))
    vals = colors[idx]
    order = np.lexsort((vals, rows))
    r, v = rows[order], vals[order]
    return not bool(((r[1:] == r[:-1]) & (v[1:] == v[:-1])).any())


def count_pd2_conflicts(bg: BipartiteGraph, colors,
                        side: str = "left") -> int:
    """Number of distinct same-class pairs that share a neighbor AND a
    color."""
    from .distance2 import partial_square
    return count_conflicts(partial_square(bg, side), colors)
