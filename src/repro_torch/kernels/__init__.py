"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions — the ports of the repository's three Pallas TPU kernels,
and two kernels that replace none.

firstfit    — bitmask first-fit over ELL neighbor-color slabs (Alg. 1 5-6)
round_fused — the firstfit mex and the Alg. 2 conflict predicate in ONE
              read of a packed slab; reached as ``engine="fused_pallas"``
conflict    — edge-parallel conflict detection (Alg. 2 line 13); runs as
              the phase-2 conflict pass of every ITERATIVE round
csr_layout  — a graph's device layout (edge list, ELL slot map, padding)
              expanded from its CSR, once per ``Graph.to_device``; the
              reference builds it on the host, so it is not in
              :data:`KERNELS`, the ports of the ``pl.pallas_call`` kernels
sorted_mex  — the ``sort`` engine's segment-min over sorted (vertex, color)
              pairs, every sweep of that engine; the reference takes it
              with XLA's ``segment_min``, so it is not in :data:`KERNELS`

Each wrapper launches its kernel for CUDA tensors (raising if it cannot)
and takes its ``*_plain`` version for CPU tensors; ``<wrapper>.launches``
counts kernel launches. Sources are in ``csrc/``; ``_build`` compiles them
with ``nvcc`` at first use.
"""
from .conflict import conflict_mask, conflict_mask_plain
from .csr_layout import csr_layout, csr_layout_plain
from .firstfit import firstfit, firstfit_plain
from .ops import (KERNELS, ell_gather_colors, ell_mex, launch_counts,
                  reset_launch_counts)
from .round_fused import (COLOR_MASK, CONFLICT_BIT, FORBID_BIT, pack_entries,
                          round_fused, round_fused_plain,
                          tile_conflict_counts)
from .sorted_mex import sorted_mex, sorted_mex_plain

__all__ = [
    "firstfit", "firstfit_plain", "round_fused", "round_fused_plain",
    "conflict_mask", "conflict_mask_plain", "csr_layout",
    "csr_layout_plain", "sorted_mex", "sorted_mex_plain", "pack_entries",
    "COLOR_MASK", "FORBID_BIT", "CONFLICT_BIT", "KERNELS", "launch_counts",
    "reset_launch_counts", "ell_gather_colors", "ell_mex",
    "tile_conflict_counts",
]
