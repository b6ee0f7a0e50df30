"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions — the ports of the repository's three Pallas TPU kernels,
and two kernels that replace none.

firstfit    — bitmask first-fit over ELL neighbor-color slabs (Alg. 1 5-6)
round_fused — the firstfit mex and the Alg. 2 conflict predicate in ONE
              read of a packed slab; reached as ``engine="fused_pallas"``
conflict    — edge-parallel conflict detection (Alg. 2 line 13); runs as
              the phase-2 conflict pass of every ITERATIVE round
sorted_mex  — the ``sort`` engine's segment-min over sorted (vertex, color)
              pairs, every sweep of that engine; the reference takes it
              with XLA's ``segment_min``
frontier_expand — the frontier's row-owner flood: each slab entry's row,
              slot, source and target, in every frontier compaction; the
              reference floods with XLA's ``lax.cummax``

:data:`KERNELS` lists them, one entry each: its name, its CUDA source in
``csrc/``, the ``pl.pallas_call`` it replaces and its C entry's argtypes.
Each wrapper launches its kernel for CUDA tensors (raising if it cannot)
through ``_build.launch`` and takes its ``*_plain`` version for CPU
tensors; :func:`launch_counts` reads the launches. ``_build`` compiles the
sources with ``nvcc`` at first use.
"""
from .conflict import conflict_mask, conflict_mask_plain
from .firstfit import firstfit, firstfit_plain
from .frontier_expand import frontier_expand, frontier_expand_plain
from .ops import (KERNELS, ell_gather_colors, ell_mex, launch_counts,
                  reset_launch_counts)
from .round_fused import (COLOR_MASK, CONFLICT_BIT, FORBID_BIT, pack_entries,
                          round_fused, round_fused_plain,
                          tile_conflict_counts)
from .sorted_mex import sorted_mex, sorted_mex_plain

__all__ = [
    "firstfit", "firstfit_plain", "round_fused", "round_fused_plain",
    "conflict_mask", "conflict_mask_plain", "sorted_mex", "sorted_mex_plain",
    "frontier_expand", "frontier_expand_plain",
    "pack_entries", "COLOR_MASK", "FORBID_BIT", "CONFLICT_BIT", "KERNELS",
    "launch_counts", "reset_launch_counts", "ell_gather_colors", "ell_mex",
    "tile_conflict_counts",
]
