"""repro_torch.parallel — wire codecs for the distributed layers.

Only the compression codecs are ported: the boundary-halo bit-packing the
distributed coloring wire uses, and the int8 stochastic-rounding psum.
The reference's ``parallel/sharding.py`` (logical-axis sharding rules of
the LM substrate) waits for the LM port (ROADMAP A15).
"""
from .compression import (compressed_psum, halo_bits, halo_bytes,
                          halo_words, pack_halo, unpack_halo)

__all__ = ["halo_bits", "halo_words", "halo_bytes", "pack_halo",
           "unpack_halo", "compressed_psum"]
