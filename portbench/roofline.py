"""The frozen roofline model of the port's three kernels.

Bytes per launch come from the launch geometry the program's
``kernel_scope`` reports (``rows``, ``width``, ``words``): every input byte
read once and every output byte written once, whatever a kernel reads again.
All three kernels are bound by bytes at these shapes: their integer work is
a few operations per slab entry. A kernel's least time is its bytes over the
card's memory rate; its roofline share is that over its measured time.

* ``firstfit``: reads the ``rows x width`` int32 neighbour-color slab and
  writes one int32 mex per row.
* ``round_fused``: reads the ``rows x width`` int32 packed slab and the
  rows' own int32 colors, and writes an int32 mex and an int32 conflict flag
  per row.
* ``conflict_mask``: over ``rows`` edges, reads both endpoints' int32
  colors and writes an int32 flag. It also reads both int32 endpoint ids
  where the colors tie; the geometry does not carry that count, so the model
  leaves those 8 bytes per tied edge out (a lower bound: the share it gives
  is never above the true one).
"""
from __future__ import annotations

import re
from typing import Optional

# NVIDIA H100 SXM (80 GB HBM3), published, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12

_SLAB = re.compile(r"slab_rows_kernel<\s*-?\d+\s*,\s*-?\d+\s*,\s*(true|false)")


def launch_bytes(kernel: str, rows: int, width: int) -> int:
    if kernel == "firstfit":
        return 4 * rows * width + 4 * rows
    if kernel == "round_fused":
        return 4 * rows * width + 4 * rows + 8 * rows
    if kernel == "conflict_mask":
        return 12 * rows
    raise ValueError(f"no roofline model for kernel {kernel!r}")


def bound_s(kernel: str, rows: int, width: int) -> float:
    """The launch's least time on the card, in seconds."""
    return launch_bytes(kernel, rows, width) / HBM_BYTES_PER_S


def kernel_of(device_op: str) -> Optional[str]:
    """Which of the port's kernels a device op of the trace is, by its
    CUDA function name (``round_fused`` and ``firstfit`` share one template,
    told apart by its ``kFused`` argument)."""
    m = _SLAB.search(device_op)
    if m:
        return "round_fused" if m.group(1) == "true" else "firstfit"
    if "conflict_kernel" in device_op:
        return "conflict_mask"
    return None
