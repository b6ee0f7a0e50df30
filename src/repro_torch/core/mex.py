"""Vectorized segmented first-fit ("mex") — the computational core of the
``"sort"`` engine: the paper's ``forbiddenColors`` stamped array + linear
scan (Alg. 1, lines 5-6) as sort, gap test and segment-min.

Given a multiset of (vertex, forbidden-color) pairs, compute per vertex the
minimum *positive* integer not present: sort the pairs lexicographically
(two stable sorts — by color, then by vertex), emit a candidate ``c+1``
wherever a gap occurs (next entry belongs to another vertex, or skips past
``c+1``), and take the segment-min of the candidates.

Callers must guarantee every live vertex contributes at least one entry;
``SortMexBackend.bind`` appends a synthetic ``(v, 0)`` pair per vertex.
"""
from __future__ import annotations

import torch

_INT32_MAX = torch.iinfo(torch.int32).max


def segment_mex(vertex: torch.Tensor, color: torch.Tensor,
                num_vertices: int) -> torch.Tensor:
    """Per-vertex minimum excluded positive color.

    vertex: [M] int32 ids in [0, num_vertices]; id == num_vertices is inert
        padding (its segment is computed then discarded).
    color:  [M] int32 >= 0 forbidden colors.
    Returns [num_vertices] int32 mex (>= 1); ``INT32_MAX`` for vertices with
    no entries.
    """
    vertex = vertex.to(torch.int32)
    color = color.to(torch.int32)
    # two-key sort: stable by the minor key, then stable by the major key
    c_order = torch.sort(color, stable=True).indices
    v_order = torch.sort(vertex[c_order], stable=True).indices
    order = c_order[v_order]
    v_s, c_s = vertex[order], color[order]
    next_v = torch.cat([v_s[1:], v_s.new_full((1,), num_vertices + 1)])
    next_c = torch.cat([c_s[1:], c_s.new_zeros(1)])
    gap = (next_v != v_s) | (next_c > c_s + 1)
    cand = torch.where(gap, c_s + 1, torch.full_like(c_s, _INT32_MAX))
    mex = torch.full((num_vertices + 1,), _INT32_MAX, dtype=torch.int32,
                     device=vertex.device)
    mex.scatter_reduce_(0, v_s.long(), cand, "amin")
    return mex[:num_vertices]
