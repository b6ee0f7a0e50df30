"""Wire-payload compression for the distributed layers (PyTorch port of
``repro.parallel.compression``).

Two independent codecs live here:

* **Halo payload bit-packing** (lossless — the distributed coloring wire):
  each boundary vertex contributes one ``(color, pending)`` entry per BSP
  round. A color is at most ``Delta + 1`` (first-fit mex over at most
  ``Delta`` forbids), so an entry needs ``bit_length(bound) + 1`` bits.
  :func:`pack_halo` packs ``32 // bits`` entries per int32 word with
  reshape/shift/sum ops and :func:`unpack_halo` inverts it exactly. The
  words equal the reference's bit for bit. torch has no uint32 shifts or
  sums on the CPU, so the packing runs in int64 and folds each word to
  int32 two's complement explicitly.

* **int8 all-reduce** (lossy, stochastic rounding — :func:`compressed_psum`):
  quantize a tensor to int8 with an fp32 scale, sum the requantized
  payload in int32 across a process group, dequantize. Unbiased but NOT
  exact, so never used for the coloring wire, where bit parity is the
  contract.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_WORD = 1 << 32


# --------------------------------------------------------------------------
# lossless halo payload packing (the distributed coloring wire)
# --------------------------------------------------------------------------
def halo_bits(color_bound: int) -> int:
    """Bits per halo entry: a color in ``[0, color_bound]`` plus one
    pending flag. ``color_bound`` is the inclusive max color (``Delta+1``
    for the coloring wire; 0 is the uncolored sentinel, included free)."""
    return max(1, int(color_bound).bit_length()) + 1


def halo_words(n: int, color_bound: int) -> int:
    """int32 words :func:`pack_halo` produces for ``n`` entries."""
    if n <= 0:
        return 0
    k = max(1, 32 // halo_bits(color_bound))
    return -(-n // k)


def halo_bytes(n: int, color_bound: int, num_devices: int = 1) -> int:
    """Per-round bytes the packed boundary halo puts on the wire:
    ``D * halo_words(n, bound) * 4`` — each rank gathers every peer's word
    slab."""
    return num_devices * halo_words(n, color_bound) * 4


def _lanes(color_bound: int) -> Tuple[int, int]:
    bits = halo_bits(color_bound)
    return bits, max(1, 32 // bits)


def pack_halo(colors: torch.Tensor, pending: torch.Tensor,
              color_bound: int) -> torch.Tensor:
    """Bit-pack ``(colors [..., n] int, pending [..., n] bool)`` into
    ``[..., halo_words(n, color_bound)]`` int32 words, losslessly while
    every color is ``<= color_bound``. Entry ``i`` occupies bits
    ``[(i % k)*bits, ...)`` of word ``i // k`` (little-endian lanes)."""
    bits, k = _lanes(color_bound)
    n = colors.shape[-1]
    W = -(-n // k) if n else 0
    entries = (colors.to(torch.int64) << 1) | pending.to(torch.int64)
    entries = torch.nn.functional.pad(entries, (0, W * k - n))
    entries = entries.reshape(*entries.shape[:-1], W, k)
    shifts = torch.arange(k, dtype=torch.int64, device=colors.device) * bits
    # disjoint bit fields: the sum IS the bitwise-or of the shifted lanes,
    # a value in [0, 2^32); fold it to int32 two's complement explicitly
    words = (entries << shifts).sum(dim=-1)
    words = torch.where(words >= (1 << 31), words - _WORD, words)
    return words.to(torch.int32)


def unpack_halo(words: torch.Tensor, n: int,
                color_bound: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inverse of :func:`pack_halo`: ``[..., W] int32`` words back to
    ``(colors [..., n] int32, pending [..., n] bool)``."""
    bits, k = _lanes(color_bound)
    shifts = torch.arange(k, dtype=torch.int64, device=words.device) * bits
    w = words.to(torch.int64) & (_WORD - 1)
    lanes = (w[..., None] >> shifts) & ((1 << bits) - 1)
    flat = lanes.reshape(*words.shape[:-1], -1)[..., :n]
    return (flat >> 1).to(torch.int32), (flat & 1).to(torch.bool)


# --------------------------------------------------------------------------
# lossy int8 psum (never the coloring wire)
# --------------------------------------------------------------------------
def _quantize(x: torch.Tensor,
              uniform: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization of ``x`` against its absmax
    scale; ``uniform`` holds the draws in [0, 1), one per element (the
    reference draws them with ``jax.random.uniform``). The scale is the
    absmax times float32(1/127): XLA compiles the reference's division by
    the constant 127 into that product, and the two differ in the last
    bit for some inputs."""
    x32 = x.to(torch.float32)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(x32.abs().max(), min=1e-12) * inv127
    y = x32 / scale
    lo = torch.floor(y)
    frac = y - lo
    q = (lo + (uniform.to(x32.device) < frac).to(torch.float32)).to(torch.int32)
    q = torch.clamp(q, -127, 127)
    return q.to(torch.int8), scale


def compressed_psum(x: torch.Tensor, group=None,
                    generator: Optional[torch.Generator] = None, *,
                    uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized sum of ``x`` across the ranks of ``group`` (a
    ``torch.distributed`` process group; ``None`` = this process alone).
    The rounding draws come from ``generator``, or are given as
    ``uniform`` (same shape as ``x``). Scales reduce with max, and each
    rank requantizes against the shared scale, so the int32 sum is exact
    and dequantization linear."""
    from ..core.distributed import ProcessMesh   # the collective route
    if uniform is None:
        uniform = torch.rand(x.shape, generator=generator, device=x.device)
    mesh = ProcessMesh(group, x.device)
    q, scale = _quantize(x, uniform)
    scale_max = mesh.all_reduce_max(scale.reshape(1))[0]
    requant = torch.clamp(
        torch.round(q.to(torch.float32) * (scale / scale_max)),
        -127, 127).to(torch.int32)
    total = mesh.all_reduce_sum(requant)
    return total.to(torch.float32) * scale_max
