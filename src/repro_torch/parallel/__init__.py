"""repro_torch.parallel — wire codecs and sharding rules.

``compression``: the boundary-halo bit-packing the distributed coloring
wire uses, and the int8 stochastic-rounding psum. ``sharding``: the
logical-axis sharding rules of the LM lane (``Rules``, ``spec_for_array``,
``constrain``), which place its params and activations on a
``DeviceMesh`` as DTensors.
"""
from .compression import (compressed_psum, halo_bits, halo_bytes,
                          halo_words, pack_halo, unpack_halo)

__all__ = ["halo_bits", "halo_words", "halo_bytes", "pack_halo",
           "unpack_halo", "compressed_psum"]
