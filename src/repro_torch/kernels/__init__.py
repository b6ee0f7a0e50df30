"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions — the ports of the repository's three Pallas TPU kernels.

firstfit    — bitmask first-fit over ELL neighbor-color slabs (Alg. 1 5-6)
round_fused — the firstfit mex and the Alg. 2 conflict predicate in ONE
              read of a packed slab; reached as ``engine="fused_pallas"``
conflict    — edge-parallel conflict detection (Alg. 2 line 13); runs as
              the phase-2 conflict pass of every ITERATIVE round

Each wrapper launches its kernel for CUDA tensors (raising if it cannot)
and takes its ``*_plain`` version for CPU tensors; ``<wrapper>.launches``
counts kernel launches. Sources are in ``csrc/``; ``_build`` compiles them
with ``nvcc`` at first use.
"""
from .conflict import conflict_mask, conflict_mask_plain
from .firstfit import firstfit, firstfit_plain
from .ops import KERNELS, launch_counts, reset_launch_counts
from .round_fused import (COLOR_MASK, CONFLICT_BIT, FORBID_BIT, pack_entries,
                          round_fused, round_fused_plain)

__all__ = [
    "firstfit", "firstfit_plain", "round_fused", "round_fused_plain",
    "conflict_mask", "conflict_mask_plain", "pack_entries", "COLOR_MASK",
    "FORBID_BIT", "CONFLICT_BIT", "KERNELS", "launch_counts",
    "reset_launch_counts",
]
