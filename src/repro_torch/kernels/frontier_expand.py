"""frontier_expand: the edge half of the frontier's compaction — for every
entry of a graph's edge slab, the slab row that owns it, its slot in the
row, the row's vertex and the edge's target
(:func:`repro_torch.core.frontier.compact_frontier`).

A slab row ``r`` holds the vertex ``vert[r]`` and its ``vdeg[r]`` incident
edges from ``starts[r]``, the exclusive sum of ``vdeg``. Entry ``e`` belongs
to the largest row ``r`` with ``vdeg[r] > 0`` and ``starts[r] <= e`` (row 0
if there is none); entries from ``min(ne, cap_e)`` on are pads. No TPU
kernel is replaced: the reference floods the row ids with XLA's
``lax.cummax`` (``src/repro/core/frontier.py:178``). The pass is bound by
bytes (the four int32 fields written once, the live targets read once); the
kernel's design is in its source, ``csrc/frontier_expand.cu``.

* :func:`frontier_expand` — the wrapper. A CUDA tensor launches the kernel
  or raises; a CPU tensor takes :func:`frontier_expand_plain`. No fallback
  between them.
* :func:`frontier_expand_plain` — the same function in plain PyTorch (a
  ``scatter_reduce_`` amax of row ids at the starts, a ``cummax`` and four
  gathers).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

INT32_MAX = 2**31 - 1
INT32_MIN = -2**31

Slab = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(vert, vdeg, starts, ne, inc_ptr, dst, cap_e, fill) -> None:
    named = (("vert", vert), ("vdeg", vdeg), ("starts", starts),
             ("inc_ptr", inc_ptr), ("dst", dst))
    for name, a in named:
        if a.dtype != torch.int32 or a.dim() != 2 or (
                a.shape[1] > 1 and a.stride(1) != 1):
            raise ValueError(f"frontier_expand: {name} must be a 2-D int32 "
                             f"tensor with unit stride along its rows, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if ne.dtype != torch.int32 or ne.dim() != 1 or not ne.is_contiguous():
        raise ValueError(f"frontier_expand: ne must be a contiguous 1-D "
                         f"int32 tensor, got {ne.dtype} {tuple(ne.shape)}")
    if len({a.device for _, a in named} | {ne.device}) != 1:
        raise ValueError("frontier_expand: inputs on different devices")
    B, cap_v = vert.shape
    if vdeg.shape != vert.shape or starts.shape != vert.shape:
        raise ValueError(f"frontier_expand: vert {tuple(vert.shape)}, vdeg "
                         f"{tuple(vdeg.shape)} and starts "
                         f"{tuple(starts.shape)} must be one [B, cap_v]")
    if ne.shape[0] != B or inc_ptr.shape[0] != B or dst.shape[0] != B:
        raise ValueError(f"frontier_expand: ne, inc_ptr and dst must have "
                         f"B = {B} rows")
    if not 1 <= inc_ptr.shape[1] <= INT32_MAX or dst.shape[1] > INT32_MAX:
        raise ValueError(f"frontier_expand: inc_ptr must be [B, V+1] and "
                         f"dst [B, E] with V + 1 and E in int32, got "
                         f"{tuple(inc_ptr.shape)} and {tuple(dst.shape)}")
    if not 0 <= int(cap_e) <= INT32_MAX:
        raise ValueError(f"frontier_expand: cap_e must lie in [0, 2^31 - 1], "
                         f"got {cap_e}")
    if not INT32_MIN <= int(fill) <= INT32_MAX:
        raise ValueError(f"frontier_expand: dst_pad {fill} is not an int32")


def frontier_expand_plain(vert: torch.Tensor, vdeg: torch.Tensor,
                          starts: torch.Tensor, ne: torch.Tensor,
                          inc_ptr: torch.Tensor, dst: torch.Tensor,
                          cap_e: int, fill: int) -> Slab:
    """Plain PyTorch version of :func:`frontier_expand` (any device): the
    row ids scattered (amax) at their starts and flooded rightwards by a
    running max, then the gathers."""
    B, cap_v = vert.shape
    V, E = inc_ptr.shape[1] - 1, dst.shape[1]
    i32 = dict(dtype=torch.int32, device=vert.device)
    at = torch.where((vdeg > 0) & (starts < cap_e), starts,
                     torch.full_like(starts, cap_e))
    owner = torch.zeros((B, cap_e + 1), **i32)
    owner.scatter_reduce_(1, at.long(),
                          torch.arange(cap_v, **i32).expand(B, cap_v),
                          "amax")
    owner = torch.cummax(owner[:, :cap_e], 1).values
    eidx = torch.arange(cap_e, **i32).expand(B, cap_e)
    valid = eidx < torch.clamp(ne, max=cap_e)[:, None]
    if cap_v:
        slot = eidx - starts.gather(1, owner.long())
        src = vert.gather(1, owner.long())
    else:
        slot, src = eidx, torch.full((B, cap_e), V, **i32)
    if E:
        gidx = inc_ptr.gather(1, torch.clamp(src, max=V).long()) + slot
        gdst = dst.gather(1, torch.clamp(gidx, 0, E - 1).long())
    else:
        gdst = torch.full((B, cap_e), fill, **i32)
    return (torch.where(valid, owner, torch.full_like(owner, cap_v)),
            torch.where(valid, src, torch.full_like(src, V)),
            torch.where(valid, gdst, torch.full_like(gdst, fill)),
            torch.where(valid, slot, torch.zeros_like(slot)))


def frontier_expand(vert: torch.Tensor, vdeg: torch.Tensor,
                    starts: torch.Tensor, ne: torch.Tensor,
                    inc_ptr: torch.Tensor, dst: torch.Tensor, cap_e: int, *,
                    dst_pad: Optional[int] = None) -> Slab:
    """The slab's edge fields ``(owner, src, dst, slot)``, each [B, cap_e]
    int32, from its rows.

    vert, vdeg, starts: [B, cap_v] int32 — each slab row's vertex (``V`` =
    empty row), its degree and its first entry, ``starts`` the exclusive
    sum of ``vdeg >= 0`` along each row. ne: [B] int32 true edge counts
    (may exceed ``cap_e``). inc_ptr: [B, V+1] and dst: [B, E] int32 — the
    CSR row pointers and edge targets. Pads are ``(cap_v, V, dst_pad, 0)``
    (``dst_pad`` defaults to V). Rows need unit stride, not contiguity."""
    from . import ops
    fill = inc_ptr.shape[1] - 1 if dst_pad is None else int(dst_pad)
    _check(vert, vdeg, starts, ne, inc_ptr, dst, cap_e, fill)
    (B, cap_v), cap_e = vert.shape, int(cap_e)
    V, E = inc_ptr.shape[1] - 1, dst.shape[1]
    with ops.kernel_scope("frontier_expand",
                          (vert, vdeg, starts, ne, inc_ptr, dst),
                          rows=cap_v, width=cap_e) as scope:
        if vert.device.type == "cpu":
            return scope.result(frontier_expand_plain(
                vert, vdeg, starts, ne, inc_ptr, dst, cap_e, fill))
        if vert.device.type != "cuda":
            raise ValueError(f"frontier_expand: unsupported device "
                             f"{vert.device}")
        if B > 65535:
            raise ValueError(f"frontier_expand: B = {B} graphs exceed the "
                             "grid's 65,535")
        out = torch.empty((4, B, cap_e), dtype=torch.int32,
                          device=vert.device)
        if B and cap_e:
            _build.launch(
                "frontier_expand", vert.device, vert.data_ptr(),
                vert.stride(0), vdeg.data_ptr(), vdeg.stride(0),
                starts.data_ptr(), starts.stride(0), ne.data_ptr(),
                inc_ptr.data_ptr(), inc_ptr.stride(0), dst.data_ptr(),
                dst.stride(0), B, cap_v, cap_e, V, E, fill,
                *(x.data_ptr() for x in out))
        return scope.result(tuple(out.unbind(0)))
