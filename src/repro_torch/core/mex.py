"""Vectorized segmented first-fit ("mex") — the computational core of the
``"sort"`` engine: the paper's ``forbiddenColors`` stamped array + linear
scan (Alg. 1, lines 5-6) as sort, gap test and segment-min.

Given a multiset of (vertex, forbidden-color) pairs, compute per vertex the
minimum *positive* integer not present: sort the pairs lexicographically
(two stable sorts — by color, then by vertex), emit a candidate ``c+1``
wherever a gap occurs (next entry belongs to another vertex, or skips past
``c+1``), and take the segment-min of the candidates
(:func:`repro_torch.kernels.sorted_mex`: a CUDA kernel on the card, plain
PyTorch on the CPU).

Callers must guarantee every live vertex contributes at least one entry;
``SortMexBackend.bind`` appends a synthetic ``(v, 0)`` pair per vertex.
"""
from __future__ import annotations

import torch

from ..kernels.sorted_mex import sorted_mex


def segment_mex(vertex: torch.Tensor, color: torch.Tensor,
                num_vertices: int) -> torch.Tensor:
    """Per-vertex minimum excluded positive color.

    vertex: [M] int32 ids in [0, num_vertices]; id == num_vertices is inert
        padding (it takes no mex).
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
    return sorted_mex(vertex[order], color[order], num_vertices)
