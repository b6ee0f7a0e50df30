"""Race classifier: every scatter/store of a recorded coloring program,
classified against the paper's benign-speculation model (the port of
``repro.analysis.races``).

The speculative algorithm (Çatalyürek et al. arXiv:1205.3809, Alg. 1-2) is
*deliberately* racy: concurrent first-fit writes may collide, and
correctness rests on every collision being (a) resolved by the later
conflict-detection pass, or (b) idempotent/commutative so the collision
cannot be observed at all. This pass takes every aten store the recorder
saw (``record.py`` classifies its operands' provenance as it runs) and
proves it into one of the benign classes, or reports it:

=========  ========  =====================================================
code       severity  class (aten ops)
=========  ========  =====================================================
RACE101    info      ``scatter_reduce_``/``index_reduce_`` with ``amin``/
                     ``amax``: order-independent
RACE102    info      ``index_put_``/``scatter_``/``index_copy_``/
                     ``index_fill_`` whose indices are static (graph
                     structure, factories): no data-driven overlap
RACE103    info      the same with a constant-fill value (the bitmap
                     scatter-or)
RACE104    info      the same with one update row
RACE300    warning   otherwise: last writer wins — benign ONLY via the
                     conflict-detected-later argument; allowlisted per site
RACE201    error     floating-point accumulation (``index_add_``,
                     ``scatter_add_``, ``scatter_reduce_("sum")``,
                     ``index_put_(accumulate=True)``)
RACE202    error     integer accumulation (the same ops, and ``bincount``)
=========  ========  =====================================================

``RACE301`` (``unique_indices`` asserted on data-driven indices) has no
public torch counterpart: no aten store takes a uniqueness claim, so this
pass never emits it; the code stays registered so baselines keep their
meaning.

A recording proves the class of the stores the run executed; a store on a
path the run did not take is not seen (the analyzer records again to reach
the paths a run missed).
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from .findings import Finding
from .record import Recording


def classify_scatters(recordings: Iterable[Recording],
                      context: str = "") -> List[Finding]:
    """One finding per distinct (site, op, class) store over
    ``recordings`` (see the table above)."""
    worst: dict = {}
    for rec in recordings:
        for site, op, cls, dtype, reduce, _count in rec.scatters:
            key = (site, op, dtype, reduce)
            if key not in worst or _RANK[cls] > _RANK[worst[key]]:
                worst[key] = cls
    return [_classify(site, op, cls, dtype, reduce, context)
            for (site, op, dtype, reduce), cls in worst.items()]


# a store seen in several classes (one class per run of the op) is
# reported by its weakest benignity argument
_RANK = {"commutative": 0, "static": 1, "single": 2, "fill": 3,
         "data": 4, "accumulate": 5}


def _classify(site, op, cls, dtype, reduce, context) -> Finding:
    what = f"{op}" + (f"({reduce!r})" if reduce else "")
    if cls == "commutative":
        return Finding("RACE101", site,
                       f"{what} ({dtype}): order-independent reduction",
                       context)
    if cls == "accumulate":
        if np.issubdtype(np.dtype(_np_dtype(dtype)), np.inexact):
            return Finding(
                "RACE201", site,
                f"{what} on {dtype}: overlapping accumulation order is "
                "nondeterministic — results vary run to run", context)
        return Finding(
            "RACE202", site,
            f"{what} on {dtype}: overlapping accumulation is "
            "non-idempotent — a speculative replay double-counts", context)
    if cls == "static":
        return Finding(
            "RACE102", site,
            f"{what}: store indices derive from the graph structure and "
            "factories only: no data-driven overlap", context)
    if cls == "single":
        return Finding("RACE104", site,
                       f"{what}: single update row: the store cannot "
                       "self-collide", context)
    if cls == "fill":
        return Finding(
            "RACE103", site,
            f"{what}: idempotent constant store ({dtype}): colliding "
            "writes all write the same value (scatter-or idiom)", context)
    return Finding(
        "RACE300", site,
        f"{what}: overlapping data-driven store ({dtype}): last writer "
        "wins, nondeterministically — benign only if a conflict pass "
        "detects and repairs collisions (paper Alg. 2 phase 2); "
        "allowlist with that argument", context)


def _np_dtype(name: str):
    return {"bfloat16": "float32", "bool": "bool_"}.get(name, name)
