"""Budget checker: packed-entry bit fields, int32 index arithmetic, and
per-block shared memory (the port of ``repro.analysis.budgets``).

Three resource envelopes that fail *silently* when exceeded — no exception,
just corrupt colorings or a refused launch:

* **bit budget** (BIT001/BIT002) — the fused-round packed entry
  (:mod:`repro_torch.kernels.round_fused`) holds the color in bits 0..27;
  ``FORBID_BIT`` is bit 28 and ``CONFLICT_BIT`` bit 29. A caller-asserted
  ``color_bound >= 2^28`` (or a ``words=`` override providing that many
  color slots) lets a legal color value alias the predicate bits. The
  table backends reject this at bind time; this pass reports it before
  any program runs. The reference's arithmetic, unchanged.
* **index width** (IDX001/IDX002) — ELL slab addressing computes
  ``row * D + slot`` in int32; ``(V+1) * max_degree >= 2^31`` wraps.
  Same for edge-list capacities.
* **shared memory per block** (VMEM001, the reference's VMEM budget) — a
  slab kernel's block needs :func:`smem_estimate` bytes at ``W`` bitset
  words (each slab kernel module exposes it, and its launcher check
  ``check_slab`` reads the same function, so this pass and the launcher
  cannot disagree). The ceiling is Hopper's 232,448-byte opt-in
  (``kernels/firstfit.py``), or on the card
  ``cudaDevAttrMaxSharedMemoryPerBlockOptin``; ``vmem_ceiling_bytes=`` or
  ``REPRO_ANALYSIS_VMEM_CEILING`` override it. :func:`check_spec_budgets`
  checks the spec's declared geometry before anything runs;
  :func:`check_kernel_smem` checks every launch a recording saw and, on
  the card, each kernel's ``cudaFuncGetAttributes`` (registers, static and
  local bytes, max threads): a kernel that cannot launch at its block
  size is a VMEM001 too.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .findings import Finding

INT32_MAX = np.iinfo(np.int32).max


def default_smem_ceiling(device=None) -> int:
    """The per-block shared-memory ceiling: the environment override, else
    the card's opt-in limit when ``device`` is a CUDA device, else
    Hopper's 232,448 bytes."""
    env = os.environ.get("REPRO_ANALYSIS_VMEM_CEILING")
    if env:
        return int(env)
    import torch
    from ..kernels.firstfit import SMEM_LIMIT_BYTES
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return int(props.shared_memory_per_block_optin)
    return SMEM_LIMIT_BYTES


def _packed_color_capacity() -> int:
    """Highest color value the packed entry can represent (2^28 - 1)."""
    from ..kernels.round_fused import COLOR_MASK
    return int(COLOR_MASK)


def check_spec_budgets(spec, statics, *, backend=None,
                       vmem_ceiling: Optional[int] = None,
                       context: str = "") -> List[Finding]:
    """Spec/shape-level budget audit — needs no recording, so it runs even
    for plans that would fail to build.

    ``spec`` is a :class:`repro_torch.core.api.ColoringSpec`; ``statics``
    a :class:`repro_torch.core.api.PlanShape` (constraint-graph space);
    ``backend`` the resolved mex backend (resolved from the spec when
    omitted); ``vmem_ceiling`` the per-block shared-memory ceiling in
    bytes (None = :func:`default_smem_ceiling` of the CPU).
    """
    from ..core.engine import get_backend, num_color_words

    findings: List[Finding] = []
    ceiling = default_smem_ceiling() if vmem_ceiling is None \
        else int(vmem_ceiling)
    backend = get_backend(spec.engine) if backend is None else backend
    cap = _packed_color_capacity()

    V = int(statics.num_vertices)
    D = max(1, int(statics.max_degree))
    eff_colors = D + 1
    if int(spec.color_bound) > 0:
        eff_colors = min(eff_colors, int(spec.color_bound))

    # --- bit budget --------------------------------------------------------
    if int(spec.color_bound) > cap:
        findings.append(Finding(
            "BIT001", "core/api.py:ColoringSpec",
            f"color_bound={spec.color_bound} exceeds the packed-entry "
            f"color field (bits 0..27, max {cap}): a color at "
            f"{cap + 1} IS the FORBID bit — table backends reject this "
            "at bind time, and no engine can represent it", context))
    elif statics.max_degree + 1 > cap:
        findings.append(Finding(
            "BIT001", "core/api.py:PlanShape",
            f"max_degree={statics.max_degree} admits colors above the "
            f"packed-entry color field (max {cap})", context))
    words_override = getattr(backend, "words", None)
    if words_override and 32 * int(words_override) - 1 > cap \
            and getattr(backend, "needs_ell", False):
        findings.append(Finding(
            "BIT002", f"core/engine.py:{type(backend).__name__}",
            f"words={words_override} provides {32 * int(words_override)} "
            f"color slots, beyond the packed-entry field (max {cap})",
            context))

    # --- int32 index arithmetic -------------------------------------------
    if getattr(backend, "needs_ell", False) and (V + 1) * D > INT32_MAX:
        findings.append(Finding(
            "IDX001", "core/engine.py:bind",
            f"ELL slab (V+1)*D = {(V + 1) * D} overflows int32 "
            "(row*width+slot addressing wraps negative)", context))
    if int(statics.padded_edges) > INT32_MAX:
        findings.append(Finding(
            "IDX002", "core/api.py:PlanShape",
            f"padded_edges={statics.padded_edges} overflows int32 edge "
            "indexing", context))

    # --- declared-geometry shared memory -----------------------------------
    if getattr(backend, "needs_ell", False):
        words = int(words_override) if words_override else \
            num_color_words(eff_colors)
        est, site = _declared_estimate(backend, words)
        if est > ceiling:
            findings.append(Finding(
                "VMEM001", site,
                f"declared per-block shared memory {est} B (words={words} "
                f"from {eff_colors} colors) exceeds the {ceiling} B "
                "ceiling — shrink the color bound", context))
    return findings


def _declared_estimate(backend, words: int):
    """(bytes, site) from the kernel module's own shared-memory model."""
    if backend.name == "fused_pallas":
        from ..kernels.round_fused import smem_estimate
        return smem_estimate(words), "kernels/round_fused.py:round_fused"
    from ..kernels.firstfit import smem_estimate
    return smem_estimate(words), "kernels/firstfit.py:firstfit"


# --------------------------------------------------------------------------
# recorded launches, and the card's own word on each kernel
# --------------------------------------------------------------------------
def check_kernel_smem(recordings: Sequence, *,
                      vmem_ceiling: Optional[int] = None,
                      context: str = "",
                      attributes: Optional[Dict] = None) -> List[Finding]:
    """Shared-memory audit of every kernel launch in ``recordings``: the
    launch's per-block estimate against the ceiling, and — for launches
    on the card — the kernel's attributes (``attributes`` caches
    :func:`launch_attributes` per launch geometry)."""
    findings: List[Finding] = []
    seen = set()
    for rec in recordings:
        for name, site, rows, width, words, smem, dev, _n in rec.launches:
            ceiling = (default_smem_ceiling(dev if dev == "cuda" else None)
                       if vmem_ceiling is None else int(vmem_ceiling))
            key = (site, name, words, smem)
            if key in seen:
                continue
            seen.add(key)
            if smem > ceiling:
                findings.append(Finding(
                    "VMEM001", site,
                    f"kernel {name!r} per-block shared memory estimate "
                    f"{smem} B (W={words} bitset words) exceeds the "
                    f"{ceiling} B ceiling", context))
            if dev != "cuda":
                continue
            a = launch_attributes(name, words, width, attributes)
            if a["block_threads"] < 1 or \
                    a["max_threads"] < a["block_threads"]:
                findings.append(Finding(
                    "VMEM001", site,
                    f"kernel {name!r} cannot launch: the launcher asks for "
                    f"{a['block_threads']} threads per block, the kernel "
                    f"allows {a['max_threads']} ({a['registers']} "
                    "registers per thread)", context))
            elif smem + a["static_smem_bytes"] > a["optin_smem_bytes"]:
                findings.append(Finding(
                    "VMEM001", site,
                    f"kernel {name!r} needs {smem} B dynamic + "
                    f"{a['static_smem_bytes']} B static shared memory per "
                    f"block, above the card's {a['optin_smem_bytes']} B",
                    context))
    return findings


def launch_attributes(name: str, words: int, width: int,
                      cache: Optional[Dict] = None) -> Dict:
    """``repro_torch.kernels.ops.kernel_attributes`` of one launch
    geometry, memoized in ``cache``."""
    from ..kernels.ops import kernel_attributes
    key = (name, int(words), int(width))
    if cache is not None and key in cache:
        return cache[key]
    a = kernel_attributes(name, words=max(1, int(words)),
                          width=max(1, int(width)))
    if cache is not None:
        cache[key] = a
    return a
