"""Distance-1 coloring validity / quality metrics (host side).

Colors may be a numpy array or a torch tensor on any device; they are
checked on the host against the host :class:`Graph`.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import Graph


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
