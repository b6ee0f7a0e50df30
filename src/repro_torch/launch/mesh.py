"""Device meshes over the current process group (the port of
``repro.launch.mesh``).

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"); the pod
axis is data-parallel by default (only the gradient reduction crosses
pods).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one rank per mesh position in row-major order.
Functions, not module constants: importing this module touches no process
group. ``repro_torch.parallel.sharding`` takes the production shapes
without any process group (a mesh there is anything with axis names and a
shape).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

from ..core.graph import DeviceSpec, resolve_device

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def production_shape(*, multi_pod: bool = False) -> Tuple[tuple, tuple]:
    """``(shape, axis names)`` of a production mesh."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceSpec = None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    current process group, on ``device``'s type (``None`` = the card).
    Raises unless the group has exactly ``prod(shape)`` ranks, and refuses
    a mesh of several gloo ranks on the card: gloo does not carry
    DTensor's collectives on CUDA tensors (under torch 2.11 its functional
    ``all_gather_into_tensor`` kills the rank with SIGSEGV), so ranks on
    cards take NCCL, one rank per card, and gloo ranks run on the CPU."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"a mesh of shape {shape} {axes} takes {need} ranks; "
                         f"the process group has {have}"
                         + ("" if have else " (none is initialized)"))
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and need > 1 and dist.get_backend() == "gloo":
        raise ValueError(f"a mesh of {need} gloo ranks on the card: gloo does "
                         f"not carry DTensor's collectives on CUDA tensors; "
                         f"use NCCL (one rank per card) or device='cpu'")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceSpec = None):
    """The production mesh (see the module docstring); raises, saying so,
    unless the process group has its 256 (512) ranks."""
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device)
