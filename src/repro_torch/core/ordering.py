"""Vertex ordering techniques (paper §1, §5.1; Gebremedhin et al. [19]).

Orderings matter for greedy color quality and, on cached machines, for
locality. ``apply`` relabels a graph so that the parallel algorithms (which
always process in index order) inherit the ordering.

The ``ORDERINGS`` registry is the ordering namespace of
:class:`repro_torch.core.api.ColoringSpec`: every entry is callable as
``fn(graph, seed) -> order`` (``order[k]`` = the vertex visited k-th); the
spec/plan layer relabels the graph and un-relabels the resulting colors,
so reports stay in original vertex ids.
"""
from __future__ import annotations

import heapq

import numpy as np

from .graph import Graph


def natural(graph: Graph, seed: int = 0) -> np.ndarray:
    return np.arange(graph.num_vertices, dtype=np.int64)


def random_shuffle(graph: Graph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(graph.num_vertices).astype(np.int64)


def largest_degree_first(graph: Graph, seed: int = 0) -> np.ndarray:
    """Welsh-Powell: visit high-degree vertices first (stable tie-break)."""
    deg = graph.degrees()
    return np.argsort(-deg, kind="stable").astype(np.int64)


def smallest_degree_last(graph: Graph, seed: int = 0) -> np.ndarray:
    """Iteratively peel minimum-degree vertices; color in reverse peel order.
    Bounds colors by degeneracy+1. Lazy-deletion binary heap, O(E log V)."""
    n = graph.num_vertices
    deg = graph.degrees().astype(np.int64).copy()
    removed = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    heap = [(int(d), int(v)) for v, d in enumerate(deg)]
    heapq.heapify(heap)
    row_ptr, col_idx = graph.row_ptr, graph.col_idx
    k = n - 1
    while heap:
        d, v = heapq.heappop(heap)
        if removed[v] or d != deg[v]:
            continue
        removed[v] = True
        order[k] = v
        k -= 1
        for w in col_idx[row_ptr[v]:row_ptr[v + 1]]:
            if not removed[w]:
                deg[w] -= 1
                heapq.heappush(heap, (int(deg[w]), int(w)))
    return order


ORDERINGS = {
    "natural": natural,
    "random": random_shuffle,
    "largest_first": largest_degree_first,
    "smallest_last": smallest_degree_last,
}


def apply(graph: Graph, order: np.ndarray) -> Graph:
    """Relabel so that ``order[i]`` becomes vertex ``i`` (index-order greedy
    over the result == greedy in ``order`` over the original)."""
    perm = np.empty_like(order)
    perm[order] = np.arange(order.shape[0], dtype=np.int64)
    return graph.relabel(perm)
