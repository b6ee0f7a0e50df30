"""R-MAT graph generator (Chakrabarti & Faloutsos), vectorized.

The paper's §4 test-graph methodology: recursive quadrant subdivision with
parameters (a, b, c, d); the three paper settings are :data:`RMAT_ER`,
:data:`RMAT_G`, :data:`RMAT_B`. Duplicate edges and self-loops are removed
in ``Graph.from_edges`` exactly as the paper does, and :func:`generate`
shuffles vertex ids (§5.1 "Locality Not Exploited").

The same seed gives the same graph as the reference ``repro.core.rmat``:
the uniform draws come from the same PCG64 stream in the same order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import Graph

# (a, b, c, d) — §4.1 of the paper.
RMAT_ER: Tuple[float, float, float, float] = (0.25, 0.25, 0.25, 0.25)
RMAT_G: Tuple[float, float, float, float] = (0.45, 0.15, 0.15, 0.25)
RMAT_B: Tuple[float, float, float, float] = (0.55, 0.15, 0.15, 0.15)

PAPER_PARAMS = {"RMAT-ER": RMAT_ER, "RMAT-G": RMAT_G, "RMAT-B": RMAT_B}

# rows of uniform draws per chunk: bounds host memory at scale 22, where a
# one-shot [8 * 2^22, 22] float64 draw would be 5.9 GB
_CHUNK_ROWS = 1 << 20


def rmat_edges(
    scale: int,
    edge_factor: int,
    params: Tuple[float, float, float, float],
    seed: int = 0,
) -> np.ndarray:
    """Sample ``edge_factor * 2**scale`` raw (src, dst) pairs.

    Each of the ``scale`` recursion levels independently picks one of four
    quadrants with probs (a, b, c, d); the row/col bits accumulate into the
    final coordinates. Draws come in row chunks: PCG64 fills a C-order
    array row by row, so chunked draws consume the stream in the same order
    as one ``rng.random((n_edges, scale))`` and give the same edges.
    """
    a, b, c, d = params
    if not np.isclose(a + b + c + d, 1.0):
        raise ValueError("R-MAT parameters must sum to 1")
    n_edges = edge_factor << scale
    rng = np.random.default_rng(seed)
    weights = (1 << np.arange(scale, dtype=np.int64))[::-1]
    out = np.empty((n_edges, 2), np.int64)
    for start in range(0, n_edges, _CHUNK_ROWS):
        stop = min(n_edges, start + _CHUNK_ROWS)
        u = rng.random((stop - start, scale))
        # quadrant: 0 -> (1,1)=a, 1 -> (1,2)=b, 2 -> (2,1)=c, 3 -> (2,2)=d
        quad = (u >= a).astype(np.int8) + (u >= a + b).astype(np.int8) \
            + (u >= a + b + c).astype(np.int8)
        out[start:stop, 0] = (quad >= 2).astype(np.int64) @ weights  # c, d
        out[start:stop, 1] = (quad % 2).astype(np.int64) @ weights   # b, d
    return out


def generate(
    scale: int,
    edge_factor: int = 8,
    params: Tuple[float, float, float, float] = RMAT_ER,
    seed: int = 0,
    shuffle: bool = True,
) -> Graph:
    """Generate an undirected R-MAT graph with ``2**scale`` vertices.

    ``edge_factor=8`` matches the paper (|E| = 8·|V| undirected edges before
    dedup, average degree ≈ 16).
    """
    n = 1 << scale
    edges = rmat_edges(scale, edge_factor, params, seed)
    g = Graph.from_edges(n, edges)
    del edges
    if shuffle:
        rng = np.random.default_rng(seed + 0x5EED)
        perm = rng.permutation(n).astype(np.int64)
        g = g.relabel(perm)
    return g


def paper_graph(name: str, scale: int, seed: int = 0, shuffle: bool = True) -> Graph:
    """One of the paper's three graph families at a chosen scale."""
    return generate(scale, 8, PAPER_PARAMS[name], seed=seed, shuffle=shuffle)
