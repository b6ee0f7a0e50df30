"""The kernel registry.

The coloring algorithms reach the kernels only through the engine registry
(``repro_torch.core.engine``: ``engine="ell_pallas"`` binds ``firstfit``,
``engine="fused_pallas"`` binds ``round_fused``) and the Alg. 2 phase-2
conflict pass (``conflict_mask``). What lives here: :data:`KERNELS`, one
entry per hand-written kernel with the TPU kernel it replaces, and the
launch counters.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

from .conflict import conflict_mask
from .firstfit import firstfit
from .round_fused import round_fused


class Kernel(NamedTuple):
    name: str
    wrapper: object
    source: str    # the CUDA source, relative to the repository root
    replaces: str  # the pl.pallas_call of the TPU kernel it ports


KERNELS = (
    Kernel("firstfit", firstfit,
           "src/repro_torch/kernels/csrc/firstfit.cu",
           "src/repro/kernels/firstfit.py:117"),
    Kernel("round_fused", round_fused,
           "src/repro_torch/kernels/csrc/round_fused.cu",
           "src/repro/kernels/round_fused.py:181"),
    Kernel("conflict_mask", conflict_mask,
           "src/repro_torch/kernels/csrc/conflict.cu",
           "src/repro/kernels/conflict.py:57"),
)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {k.name: k.wrapper.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0
