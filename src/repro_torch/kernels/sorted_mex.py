"""sorted_mex: the ``sort`` engine's segment-min, over (vertex, color) pairs
already sorted by vertex, then color — the last step of
:func:`repro_torch.core.mex.segment_mex`.

A pair is a gap where the next pair belongs to another vertex (or there is
none) or skips past ``color + 1``; a vertex's mex is the least
``color + 1`` over its gaps. Id ``num_vertices`` is inert. No TPU kernel is
replaced: the reference takes the segment-min with XLA's ``segment_min``
(``src/repro/core/mex.py::segment_mex``). The pass is bound by bytes (each
pair read once, one word written per vertex); the kernel's design is in
its source, ``csrc/sorted_mex.cu``.

* :func:`sorted_mex` — the wrapper. A CUDA tensor launches the kernel or
  raises; a CPU tensor takes :func:`sorted_mex_plain`. No fallback between
  them.
* :func:`sorted_mex_plain` — the same function in plain PyTorch (a gap test
  and a ``scatter_reduce_`` amin).
"""
from __future__ import annotations

import torch

from . import _build

INT32_MAX = 2**31 - 1


def _check(vertex: torch.Tensor, color: torch.Tensor,
           num_vertices: int) -> None:
    for name, a in (("vertex", vertex), ("color", color)):
        if a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"sorted_mex: {name} must be a contiguous 1-D "
                             f"int32 tensor, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if vertex.device != color.device:
        raise ValueError("sorted_mex: vertex and color on different devices")
    if vertex.numel() != color.numel():
        raise ValueError(f"sorted_mex: {vertex.numel()} vertices but "
                         f"{color.numel()} colors")
    if vertex.numel() > INT32_MAX:
        raise ValueError("sorted_mex: more than 2^31 - 1 pairs")
    if not 0 <= int(num_vertices) < INT32_MAX:
        raise ValueError(f"sorted_mex: num_vertices must lie in "
                         f"[0, 2^31 - 1), got {num_vertices}")


def sorted_mex_plain(v_s: torch.Tensor, c_s: torch.Tensor,
                     num_vertices: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`sorted_mex` (any device)."""
    next_v = torch.cat([v_s[1:], v_s.new_full((1,), num_vertices + 1)])
    next_c = torch.cat([c_s[1:], c_s.new_zeros(1)])
    gap = (next_v != v_s) | (next_c > c_s + 1)
    cand = torch.where(gap, c_s + 1, torch.full_like(c_s, INT32_MAX))
    mex = torch.full((num_vertices + 1,), INT32_MAX, dtype=torch.int32,
                     device=v_s.device)
    mex.scatter_reduce_(0, v_s.long(), cand, "amin")
    return mex[:num_vertices]


def sorted_mex(vertex: torch.Tensor, color: torch.Tensor,
               num_vertices: int) -> torch.Tensor:
    """Per-vertex minimum excluded positive color from pairs sorted by
    (vertex, color).

    vertex: [M] int32 ids in [0, num_vertices], ascending; id
    ``num_vertices`` is inert. color: [M] int32 in [0, 2^31 - 1),
    ascending within a vertex. Returns [num_vertices] int32 mex (>= 1);
    ``INT32_MAX`` for a vertex with no pairs."""
    from . import ops
    _check(vertex, color, num_vertices)
    V, M = int(num_vertices), vertex.numel()
    with ops.kernel_scope("sorted_mex", (vertex, color), rows=V,
                          width=M) as scope:
        if vertex.device.type == "cpu":
            return scope.result(sorted_mex_plain(vertex, color, V))
        if vertex.device.type != "cuda":
            raise ValueError(f"sorted_mex: unsupported device "
                             f"{vertex.device}")
        mex = torch.full((V,), INT32_MAX, dtype=torch.int32,
                         device=vertex.device)
        if M == 0:
            return scope.result(mex)
        _build.launch("sorted_mex", vertex.device, vertex.data_ptr(),
                      color.data_ptr(), M, V, mex.data_ptr())
        return scope.result(mex)
