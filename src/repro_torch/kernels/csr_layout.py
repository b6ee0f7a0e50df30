"""csr_layout: a graph's device layout expanded from its CSR on the card,
the one layout pass of ``Graph.to_device``.

From ``row_ptr`` ([V+1] int64) and a ``dst`` of P int32 entries whose
first 2E hold ``col_idx``, it makes what the engines read: ``src`` (the row
of each directed edge, V for padding), the ELL slot map (each edge's
position in its row, cut at the slab width, which is also the padding's
slot), ``dst``'s padding (V) and ``inc_ptr`` (``row_ptr`` as int32, where
2E fits). No TPU kernel is replaced: the reference builds this layout on
the host in numpy (``src/repro/core/graph.py::Graph.to_device``). The pass
is bound by bytes (``row_ptr`` read once, each output written once); the
kernel's design is in its source, ``csrc/csr_layout.cu``.

* :func:`csr_layout` — the wrapper. A CUDA tensor launches the kernel or
  raises; a CPU tensor takes :func:`csr_layout_plain`. No fallback between
  them.
* :func:`csr_layout_plain` — the same function in plain PyTorch (gathers
  only).
* ``csr_layout.launches`` — how many times the wrapper launched the kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build

INT32_MAX = 2**31 - 1


class CsrLayout(NamedTuple):
    src: torch.Tensor                 # [P] int32
    ell_slot: Optional[torch.Tensor]  # [P] int32, or None without a width
    inc_ptr: Optional[torch.Tensor]   # [V+1] int32, or None when 2E > 2^31-1


def _check(row_ptr: torch.Tensor, dst: torch.Tensor, num_directed_edges: int,
           ell_width: Optional[int]) -> None:
    if row_ptr.dtype != torch.int64 or row_ptr.dim() != 1 \
            or row_ptr.numel() < 1 or not row_ptr.is_contiguous():
        raise ValueError("csr_layout: row_ptr must be a contiguous [V+1] "
                         f"int64 tensor, got {row_ptr.dtype} "
                         f"{tuple(row_ptr.shape)}")
    if dst.dtype != torch.int32 or dst.dim() != 1 or not dst.is_contiguous():
        raise ValueError("csr_layout: dst must be a contiguous 1-D int32 "
                         f"tensor, got {dst.dtype} {tuple(dst.shape)}")
    if dst.device != row_ptr.device:
        raise ValueError("csr_layout: row_ptr and dst on different devices")
    if row_ptr.numel() - 1 > INT32_MAX - 1:
        raise ValueError("csr_layout: vertex ids must fit int32")
    if not 0 <= int(num_directed_edges) <= dst.numel():
        raise ValueError(f"csr_layout: {num_directed_edges} edges do not fit "
                         f"a dst of {dst.numel()}")
    if ell_width is not None and not 1 <= int(ell_width) <= INT32_MAX:
        raise ValueError(f"csr_layout: ell_width must be >= 1, got "
                         f"{ell_width}")


def csr_layout_plain(row_ptr: torch.Tensor, dst: torch.Tensor,
                     num_directed_edges: int,
                     ell_width: Optional[int] = None) -> CsrLayout:
    """Plain PyTorch version of :func:`csr_layout` (any device)."""
    V, e, P = row_ptr.numel() - 1, int(num_directed_edges), dst.numel()
    dev = row_ptr.device
    src = torch.full((P,), V, dtype=torch.int32, device=dev)
    src[:e] = torch.repeat_interleave(
        torch.arange(V, dtype=torch.int32, device=dev),
        row_ptr[1:] - row_ptr[:-1], output_size=e)
    slot = None
    if ell_width is not None:
        slot = torch.full((P,), int(ell_width), dtype=torch.int32, device=dev)
        pos = torch.arange(e, dtype=torch.int64, device=dev) \
            - row_ptr[src[:e].long()]
        slot[:e] = pos.clamp(max=int(ell_width))
    dst[e:] = V
    inc = row_ptr.to(torch.int32) if e <= INT32_MAX else None
    return CsrLayout(src, slot, inc)


def csr_layout(row_ptr: torch.Tensor, dst: torch.Tensor,
               num_directed_edges: int,
               ell_width: Optional[int] = None) -> CsrLayout:
    """Expand a CSR into the device layout: returns ``(src, ell_slot,
    inc_ptr)`` and writes V into ``dst[num_directed_edges:]``.

    row_ptr: [V+1] int64; dst: [P] int32 on the same device, its first
    ``num_directed_edges`` entries the CSR's ``col_idx``; ell_width: the
    slab width (None: no slot map). ``inc_ptr`` is None when the edge
    count does not fit int32."""
    _check(row_ptr, dst, num_directed_edges, ell_width)
    if row_ptr.device.type == "cpu":
        return csr_layout_plain(row_ptr, dst, num_directed_edges, ell_width)
    if row_ptr.device.type != "cuda":
        raise ValueError(f"csr_layout: unsupported device {row_ptr.device}")
    V, e, P = row_ptr.numel() - 1, int(num_directed_edges), dst.numel()
    dev = row_ptr.device
    src = torch.empty((P,), dtype=torch.int32, device=dev)
    slot = (torch.empty((P,), dtype=torch.int32, device=dev)
            if ell_width is not None else None)
    inc = (torch.empty((V + 1,), dtype=torch.int32, device=dev)
           if e <= INT32_MAX else None)
    for a in (src, slot):  # the kernel stores them 16 bytes at a time
        if a is not None and a.data_ptr() % 16:
            raise ValueError("csr_layout: src and ell_slot must start on a "
                             "16-byte boundary")
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_csr_layout(
            row_ptr.data_ptr(), V, e, P,
            int(ell_width) if ell_width is not None else 0, src.data_ptr(),
            None if slot is None else slot.data_ptr(), dst.data_ptr(),
            None if inc is None else inc.data_ptr(), stream)
    _build.check(lib, rc, "csr_layout")
    csr_layout.launches += 1
    return CsrLayout(src, slot, inc)


csr_layout.launches = 0
