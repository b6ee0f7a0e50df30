"""round_fused: ONE read of a packed ELL slab gives the mex of its FORBID
entries and the Alg. 2 conflict flag — the port of the Pallas TPU kernel
``src/repro/kernels/round_fused.py::round_fused``.

Each int32 slab entry packs a neighbor's color with two predicate bits:

* ``FORBID``  (bit 28) — the entry contributes to the forbidden bitset;
* ``CONFLICT`` (bit 29) — the entry is conflict-eligible: an equal color
  queues the row for recoloring.

Entries with neither bit are inert; color 0 is always forbidden.

* :func:`round_fused` — the wrapper. A CUDA tensor launches the
  hand-written kernel ``csrc/round_fused.cu`` (``firstfit``'s staged row
  tiles and bitsets, plus a warp ballot for the conflict flag) or raises; a
  CPU tensor takes :func:`round_fused_plain`. There is no fallback between
  the two.
* :func:`round_fused_plain` — the same function in plain PyTorch.
* ``round_fused.launches`` — how many times the wrapper launched the kernel.
* :func:`smem_estimate` — ``firstfit``'s: both kernels share one launcher
  (``csrc/bitset.cuh``), so their per-block shared memory is the same.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .firstfit import check_slab, row_stride, smem_estimate
from .ref import table_mex

# packed-entry layout: bits 0..27 color, bit 28 forbid, bit 29 conflict
COLOR_MASK = (1 << 28) - 1
FORBID_BIT = 1 << 28
CONFLICT_BIT = 1 << 29


def pack_entries(colors: torch.Tensor, forbid, conflict) -> torch.Tensor:
    """Pack an ELL block of neighbor colors + predicate masks into the
    kernel's int32 entry format. ``colors`` int32 (values < 2^28),
    ``forbid``/``conflict`` broadcastable booleans."""
    colors = colors.to(torch.int32) & COLOR_MASK
    zero = torch.zeros((), dtype=torch.int32, device=colors.device)
    f = torch.where(torch.as_tensor(forbid, device=colors.device),
                    zero + FORBID_BIT, zero)
    c = torch.where(torch.as_tensor(conflict, device=colors.device),
                    zero + CONFLICT_BIT, zero)
    return colors | f | c


def round_fused_plain(entries: torch.Tensor, own_colors: torch.Tensor, *,
                      words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`round_fused` (any device)."""
    V, D = entries.shape
    color = entries & COLOR_MASK
    forbid = (entries & FORBID_BIT) != 0
    elig = (entries & CONFLICT_BIT) != 0
    rows = torch.arange(V, device=entries.device).unsqueeze(1).expand(V, D)
    mex = table_mex(rows, torch.where(forbid, color, torch.full_like(color, -1)),
                    V, 32 * int(words))
    own = own_colors.to(torch.int32).unsqueeze(1)
    conf = (elig & (color == own) & (own > 0)).any(dim=1).to(torch.int32)
    return mex, conf


def round_fused(entries: torch.Tensor, own_colors: torch.Tensor, *,
                words: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused detect→mex pass over a packed ELL slab.

    entries:    [V, D] int32 packed (:func:`pack_entries`), rows may be
                strided as for ``firstfit``.
    own_colors: [V] int32, each row's current color (0 = uncolored — such
                rows never report a conflict).

    Returns ``(mex, conflict)``: mex [V] int32 >= 1 (the smallest positive
    color absent from the row's FORBID entries, ``INT32_MAX`` if none) and
    conflict [V] int32 (1 iff some CONFLICT entry matches the row's own
    color).
    """
    check_slab(entries, words, "round_fused")
    V, D = entries.shape
    if own_colors.dtype != torch.int32 or tuple(own_colors.shape) != (V,):
        raise ValueError(f"round_fused: own_colors must be int32 of shape "
                         f"({V},), got {own_colors.dtype} "
                         f"{tuple(own_colors.shape)}")
    if own_colors.device != entries.device:
        raise ValueError("round_fused: entries and own_colors on different "
                         "devices")
    from . import ops
    with ops.kernel_scope("round_fused", (entries, own_colors), rows=V,
                          width=D, words=int(words),
                          smem=smem_estimate(words)) as scope:
        if entries.device.type == "cpu":
            return scope.result(round_fused_plain(entries, own_colors,
                                                  words=words))
        if entries.device.type != "cuda":
            raise ValueError(f"round_fused: unsupported device "
                             f"{entries.device}")
        own = own_colors.contiguous()
        mex = torch.empty((V,), dtype=torch.int32, device=entries.device)
        conf = torch.empty((V,), dtype=torch.int32, device=entries.device)
        if V == 0:
            return scope.result((mex, conf))
        lib = _build.load()
        with torch.cuda.device(entries.device):
            stream = torch.cuda.current_stream(entries.device).cuda_stream
            rc = lib.repro_round_fused(entries.data_ptr(),
                                       row_stride(entries), own.data_ptr(),
                                       V, D, int(words), mex.data_ptr(),
                                       conf.data_ptr(), stream)
        _build.check(lib, rc, "round_fused")
        round_fused.launches += 1
        return scope.result((mex, conf))


round_fused.launches = 0
