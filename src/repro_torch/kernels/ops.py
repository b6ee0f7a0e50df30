"""The kernel registry.

The coloring algorithms reach the kernels only through the engine registry
(``repro_torch.core.engine``: ``engine="ell_pallas"`` binds ``firstfit``,
``engine="fused_pallas"`` binds ``round_fused``) and the Alg. 2 phase-2
conflict pass (``conflict_mask``). What lives here: the standalone slab helpers :func:`ell_gather_colors`
and :func:`ell_mex` (serial-style mex over an ELL adjacency), :data:`KERNELS`, one
entry per hand-written kernel with the TPU kernel it replaces, the launch
counters, :func:`kernel_attributes` (what the CUDA runtime reports for a
kernel), and the hooks through which a running program reports to the
static analyzer's recorder (``repro_torch.analysis.record``):

* :func:`kernel_scope` — every wrapper runs its launch (or, for a CPU
  tensor, its plain version) inside one, so the recorder sees one kernel
  op, never the plain version's aten ops;
* :func:`collective_scope` — ``ProcessMesh`` runs every all-gather and
  all-reduce inside one, before it decides whether a group exists;
* :func:`report_state` — the speculation state a program carries
  (colors, pending sets, the exchanged snapshot): what the recorder's
  provenance calls *data*;
* :func:`report_round` / :func:`report_loop_exit` / :func:`report_path` —
  the distributed round loop's boundaries and the program paths a run
  took.

With no recorder active (the normal case) each hook is one thread-local
read.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, NamedTuple, Optional

import torch

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


# the fields repro_kernel_attributes fills, in order
ATTRIBUTE_FIELDS = ("registers", "static_smem_bytes", "local_bytes",
                    "max_threads", "block_threads", "optin_smem_bytes")


def kernel_attributes(name: str, *, words: int = 1, width: int = 1) -> dict:
    """``cudaFuncGetAttributes`` of the kernel variant the launcher of
    ``name`` picks for a ``words``-word bitset over rows of ``width``
    (the bulk-copy variant; the conflict kernel has one), beside the block
    size the launcher asks for and the card's opt-in shared memory per
    block. Needs the card."""
    from . import _build
    ids = {k.name: i for i, k in enumerate(KERNELS)}
    if name not in ids:
        raise ValueError(f"unknown kernel {name!r}; choose from {sorted(ids)}")
    lib = _build.load()
    out = (ctypes.c_int * len(ATTRIBUTE_FIELDS))()
    rc = lib.repro_kernel_attributes(ids[name], int(words), int(width),
                                     ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, rc, f"{name} attributes")
    return dict(zip(ATTRIBUTE_FIELDS, (int(x) for x in out)))


# --------------------------------------------------------------------------
# the analysis recorder's hooks
# --------------------------------------------------------------------------
_HOOKS = threading.local()


def active_recorder():
    """The recorder this thread's program reports to, or None."""
    return getattr(_HOOKS, "recorder", None)


def set_recorder(recorder) -> Optional[object]:
    """Make ``recorder`` this thread's active recorder; returns the one it
    replaces."""
    prev = active_recorder()
    _HOOKS.recorder = recorder
    return prev


class _Unrecorded:
    """What a scope yields when nothing records: ``result`` passes through."""

    @staticmethod
    def result(out):
        return out


_UNRECORDED = _Unrecorded()


@contextlib.contextmanager
def kernel_scope(name: str, inputs, **info):
    """Run a kernel wrapper's launch (or plain version) as one recorded op:
    ``inputs`` its tensor operands, ``info`` its geometry (rows, width,
    words, smem). The body returns ``scope.result(out)``."""
    rec = active_recorder()
    if rec is None:
        yield _UNRECORDED
        return
    with rec.kernel(name, inputs, info) as scope:
        yield scope


@contextlib.contextmanager
def collective_scope(kind: str, payload, num_devices: int, op: str = ""):
    """Run one ``ProcessMesh`` collective (``"all_gather"`` or
    ``"all_reduce"``, reduction ``op``) as one recorded op, whether or not
    a process group exists. The body returns ``scope.result(out)``."""
    rec = active_recorder()
    if rec is None:
        yield _UNRECORDED
        return
    with rec.collective(kind, payload, num_devices, op) as scope:
        yield scope


def report_state(*tensors) -> None:
    """``tensors`` are the program's speculation state (colors, pending
    sets, snapshots): values computed from them are data, not structure."""
    rec = active_recorder()
    if rec is not None:
        rec.state(tensors)


def report_round(rnd: int) -> None:
    """A round of a collective round loop begins."""
    rec = active_recorder()
    if rec is not None:
        rec.round(rnd)


def report_loop_exit() -> None:
    """The collective round loop has ended."""
    rec = active_recorder()
    if rec is not None:
        rec.loop_exit()


def report_path(name: str) -> None:
    """The program took the path ``name`` (coverage for the recorder)."""
    rec = active_recorder()
    if rec is not None:
        rec.path(name)


def ell_gather_colors(colors: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """Gather neighbor colors for an ELL adjacency slab.

    colors: [V] int32 (0 = uncolored); ell: [V, D] int32 neighbor ids with
    pad = V. Returns [V, D] int32 (pad slots -> 0); the gather stays outside
    the kernel.
    """
    cpad = torch.cat([colors.to(torch.int32),
                      colors.new_zeros(1, dtype=torch.int32)])
    return cpad[torch.clamp_max(ell.long(), colors.shape[0])]


def ell_mex(colors: torch.Tensor, ell: torch.Tensor, *,
            words: int = 16) -> torch.Tensor:
    """mex per vertex from an ELL slab — the Alg. 1 inner loop through
    :func:`firstfit` (its CUDA kernel for a tensor on the card, its plain
    version for a CPU tensor)."""
    return firstfit(ell_gather_colors(colors, ell), words=words)
