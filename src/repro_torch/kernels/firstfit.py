"""firstfit: blocked bitmask first-fit over an ELL slab (the paper's Alg. 1
lines 5-6) — the port of the Pallas TPU kernel
``src/repro/kernels/firstfit.py::firstfit``.

The irregular neighbor-color gather stays outside the kernel (the engines
scatter each sweep's contributions into a dense ``[V, D]`` slab); the
kernel builds each row's ``W``-word forbidden bitset (color 0 preset,
colors ``< 0`` or ``>= 32·W`` dropped) and returns the lowest clear bit.

* :func:`firstfit` — the wrapper. A CUDA tensor launches the hand-written
  kernel ``csrc/firstfit.cu`` (row tiles staged into shared memory by bulk
  async copies, 4 lanes per row with the bitset in registers for W <= 8,
  a warp per row with a shared bitset above; see the source for its bound
  and design) or raises; a CPU tensor takes :func:`firstfit_plain`. There
  is no fallback between the two.
* :func:`firstfit_plain` — the same function in plain PyTorch.
* :func:`smem_estimate` — the least shared memory a block of the kernel
  needs at ``W`` words; :func:`check_slab` and the static analyzer's
  budget pass (``repro_torch.analysis.budgets``) both read it.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import table_mex

# a block may use at most 227 KB (232,448 bytes) of shared memory on Hopper;
# the kernels keep 1,152 of them for their barriers and result stash
SMEM_LIMIT_BYTES = 232_448
SMEM_RESERVED_BYTES = 1_152


def smem_estimate(words: int) -> int:
    """The least dynamic shared memory, in bytes, a block of the slab
    kernels needs at ``words`` bitset words: the barriers and result stash
    plus one warp's ``W``-word bitset (the wide path's floor; the launcher
    fits its staging ring into whatever is left, and the narrow path's
    bitsets live in registers). A block launches iff this fits the card's
    opt-in limit."""
    return SMEM_RESERVED_BYTES + 4 * int(words)


def firstfit_plain(nbr_colors: torch.Tensor, *, words: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`firstfit` (any device)."""
    V, D = nbr_colors.shape
    rows = torch.arange(V, device=nbr_colors.device).unsqueeze(1).expand(V, D)
    return table_mex(rows, nbr_colors, V, 32 * int(words))


def check_slab(slab: torch.Tensor, words: int, name: str) -> None:
    """The layout both ELL-slab kernels take: 2-D int32, unit column
    stride, row stride >= D, and a bitset that fits in shared memory."""
    if slab.dtype != torch.int32 or slab.dim() != 2:
        raise ValueError(f"{name}: need a 2-D int32 slab, got {slab.dtype} "
                         f"of shape {tuple(slab.shape)}")
    V, D = slab.shape
    if D < 1:
        raise ValueError(f"{name}: slab width must be >= 1")
    if (D > 1 and slab.stride(1) != 1) or (V > 1 and slab.stride(0) < D):
        raise ValueError(f"{name}: slab rows must be unit-stride with row "
                         f"stride >= {D}; got strides {slab.stride()}")
    if int(words) < 1:
        raise ValueError(f"{name}: words must be >= 1")
    if smem_estimate(words) > SMEM_LIMIT_BYTES:
        raise ValueError(f"{name}: a {words}-word bitset needs "
                         f"{smem_estimate(words)} bytes of shared memory per "
                         f"block, above the {SMEM_LIMIT_BYTES} a block may "
                         f"have")


def row_stride(slab: torch.Tensor) -> int:
    """The row stride handed to a kernel (a single row's stride is moot)."""
    return slab.stride(0) if slab.shape[0] > 1 else slab.shape[1]


def firstfit(nbr_colors: torch.Tensor, *, words: int = 16) -> torch.Tensor:
    """Minimum excluded positive color per row of an ELL neighbor-color slab.

    nbr_colors: [V, D] int32 (0 = absent/uncolored); rows may be strided
    (the engines pass the ``[:V, :D]`` view of a slab with a sink row and
    column). Returns mex [V] int32 >= 1, ``INT32_MAX`` for a row whose
    ``32·words`` colors are all taken.
    """
    from . import ops
    check_slab(nbr_colors, words, "firstfit")
    V, D = nbr_colors.shape
    with ops.kernel_scope("firstfit", (nbr_colors,), rows=V, width=D,
                          words=int(words),
                          smem=smem_estimate(words)) as scope:
        if nbr_colors.device.type == "cpu":
            return scope.result(firstfit_plain(nbr_colors, words=words))
        if nbr_colors.device.type != "cuda":
            raise ValueError(f"firstfit: unsupported device "
                             f"{nbr_colors.device}")
        out = torch.empty((V,), dtype=torch.int32, device=nbr_colors.device)
        if V == 0:
            return scope.result(out)
        _build.launch("firstfit", nbr_colors.device, nbr_colors.data_ptr(),
                      row_stride(nbr_colors), V, D, int(words),
                      out.data_ptr())
        return scope.result(out)
