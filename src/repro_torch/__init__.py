"""repro_torch — the PyTorch/CUDA port of ``repro`` (parallel graph coloring,
the paper's ITERATIVE and DATAFLOW algorithms) for NVIDIA Hopper.

``repro_torch.core`` mirrors ``repro.core``; ``repro_torch.kernels`` holds
the hand-written CUDA kernels that replace the reference's Pallas TPU
kernels, each beside its plain PyTorch version. Entry points run on the
card unless the caller passes ``device="cpu"``. The package imports torch
and numpy only.
"""
from . import core, kernels

__all__ = ["core", "kernels"]
