"""conflict_mask: edge-parallel conflict detection (Alg. 2 line 13) — the
port of the Pallas TPU kernel ``src/repro/kernels/conflict.py::conflict_mask``.

Consumes pre-gathered endpoint colors plus the endpoint ids and emits the
per-edge mask ``c_src == c_dst and c_src > 0 and src > dst``. In the port it
runs on the main path: ``engine.speculation_conflicts`` and
``frontier.frontier_conflicts`` evaluate Alg. 2 phase 2 through it.

* :func:`conflict_mask` — the wrapper. CUDA tensors launch the hand-written
  kernel ``csrc/conflict.cu`` (one thread per edge, grid-stride) or raise;
  CPU tensors take :func:`conflict_mask_plain`. No fallback between them.
* :func:`conflict_mask_plain` — the same function in plain PyTorch.
"""
from __future__ import annotations

import torch

from . import _build


def conflict_mask_plain(colors_src: torch.Tensor, colors_dst: torch.Tensor,
                        src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`conflict_mask` (any device)."""
    conf = (colors_src == colors_dst) & (colors_src > 0) & (src > dst)
    return conf.to(torch.int32)


def conflict_mask(colors_src: torch.Tensor, colors_dst: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Per-edge conflict mask [E] int32 (1 = recolor the src endpoint).
    All four operands are [E] int32 on one device."""
    args = (colors_src, colors_dst, src, dst)
    (E,) = colors_src.shape
    for a in args:
        if a.dtype != torch.int32 or tuple(a.shape) != (E,):
            raise ValueError(f"conflict_mask: need four [{E}] int32 operands, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != colors_src.device:
            raise ValueError("conflict_mask: operands on different devices")
    from . import ops
    with ops.kernel_scope("conflict_mask", args, rows=E, width=1, words=0,
                          smem=0) as scope:
        if colors_src.device.type == "cpu":
            return scope.result(conflict_mask_plain(*args))
        if colors_src.device.type != "cuda":
            raise ValueError(f"conflict_mask: unsupported device "
                             f"{colors_src.device}")
        args = tuple(a.contiguous() for a in args)
        out = torch.empty((E,), dtype=torch.int32, device=colors_src.device)
        if E == 0:
            return scope.result(out)
        _build.launch("conflict_mask", colors_src.device,
                      *(a.data_ptr() for a in args), E, out.data_ptr())
        return scope.result(out)
