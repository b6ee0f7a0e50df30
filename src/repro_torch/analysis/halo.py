"""Halo exactness — interior-unreferencability (HALO codes; the port of
``repro.analysis.halo``).

The boundary wire is exact because remote **interior** state is never
referenced: every cross-shard read lands on a boundary (or frontier-slab)
vertex, and the conflict pass reads the gathered payload only through the
patched ``[Vp]`` snapshot view. The reference proves this as a
dataflow-reachability property of the traced mesh program; the port shows
it on the recorded run of every rank, in two halves:

* **payload side** (HALO201) — every per-round all-gather of the
  boundary-wire program must ship a *selection*: its operand holds fewer
  than ``Vl`` entries (the packed halo words do; the frontier-slab wire's
  ``(gid, color)`` pairs are bounded by ``cap_v`` instead, which may reach
  ``Vl`` on tiny envelopes). A mutation that routes the un-selected color
  vector onto the wire does not;
* **read side** (HALO202) — the recorder taints each round's all-gather
  output as *raw* and follows it through every op. Raw payload may land in
  the carried snapshot/pending views only through an index store into a
  ``[Vp]`` (or ``[Vp + 1]``, with its sink slot) buffer: the sanctioned
  patch, after which reads see the patched view. A raw value reaching an
  equality compare (the conflict predicate), a kernel (a conflict compare
  or a mex table) or an index store into any other buffer would make raw
  remote state — interior entries included — referenceable, and is an
  error.

The proof is per round: the carried snapshot is last round's
already-patched view, which is the algorithm's contract, so raw taint
ends with its round. HALO101 records the successful check with the gather
count and payload widths, and says that it holds for the recorded run.
"""
from __future__ import annotations

from typing import List, Sequence

from .findings import Finding
from .spmd import SLAB_WIRE_SITE, SpmdGeometry


def check_halo_exactness(recordings: Sequence, geometry: SpmdGeometry, *,
                         context: str = "") -> List[Finding]:
    """The exactness check over the recordings of every rank. Only
    meaningful for the boundary wire (the full tier ships everything by
    design and is exempt)."""
    g = geometry
    if g.wire != "boundary":
        return []
    findings: List[Finding] = []
    seen = set()
    Vl = g.verts_local
    widths = []
    for rec in recordings:
        for e in rec.collectives():
            if e["phase"] != "round" or e["kind"] != "all_gather":
                continue
            widths.append(e["in_elems"])
            slab = e["site"] == SLAB_WIRE_SITE
            limit = max(Vl, g.frontier_cap_v + 1) if slab else Vl
            if e["in_elems"] >= limit and ("HALO201", e["site"]) not in seen:
                seen.add(("HALO201", e["site"]))
                findings.append(Finding(
                    "HALO201", e["site"],
                    f"per-round payload ships {e['in_elems']} entries >= "
                    f"{limit} (Vl={Vl}): the full local state (interior "
                    "entries included) crosses the wire — the boundary "
                    "selection was bypassed (recorded round "
                    f"{e['round']})", context))
        for site, message, rnd in rec.halo:
            if ("HALO202", site) not in seen:
                seen.add(("HALO202", site))
                findings.append(Finding(
                    "HALO202", site, f"{message} (recorded round {rnd})",
                    context))
    if not findings and widths:
        distinct = ",".join(str(w) for w in sorted(set(widths)))
        findings.append(Finding(
            "HALO101", "core/distributed.py:_bsp_local",
            f"exactness holds on the recorded run: {len(widths)} per-round "
            f"gather(s) over {len(recordings)} rank(s) (operand widths "
            f"{distinct}, all boundary/slab selections below Vl={Vl}); raw "
            "payload reaches no conflict compare, kernel or foreign table "
            "— every read routes through the [Vp] snapshot patch",
            context))
    return findings
