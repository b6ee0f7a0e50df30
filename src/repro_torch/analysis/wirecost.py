"""Static wire-cost model — bytes-on-wire accounting (WIRE codes; the port
of ``repro.analysis.wirecost``).

The three-tier distributed exchange has a *closed-form* per-round byte
count, documented in DESIGN.md §Perf and deliberately **re-derived here
from the documented formulas** rather than imported from the runtime
(``repro_torch.parallel.halo_bytes``,
``repro_torch.core.distributed.slab_entry_bytes``) — so the pass
cross-checks two independent implementations and drift in either becomes
a lint error (WIRE201):

* **H-C4 boundary halo** — ``D * ceil(Bl / k) * 4`` bytes/round, with
  ``k = 32 // (bit_length(wire_colors) + 1)`` packed entries per int32
  word;
* **H-C1 full spill** — ``Vp * 2`` bytes/round (the packed-int16 gather);
* **H-C3 frontier slab** — ``D * cap_v * 4`` when ``(gid, color)`` packs
  into one word (``bit_length(Vp) + bit_length(wire_colors) <= 32``),
  else two int32 gathers totalling ``D * cap_v * 8``;
* **setup** — one ``D * Bl * 4`` boundary-map gather, before the round
  loop (zero per-round id traffic).

:func:`check_wire_cost` reads the collectives every rank recorded
(``ProcessMesh`` reports each one, ``repro_torch.kernels.ops``), attributes
every all-gather to a tier by where it ran (before the round loop = setup;
in a round, the slab-wire function = slab; any other in a round = the
configured round tier) and compares its received bytes, round by round,
against the closed forms. Scalar all-reduce votes (<= 2 elements) are
control plane, inventoried but never gated. What runs after the loop (the
final colors and the history reduction) is the program's output, priced
outside the wire tiers, as the reference's sharded outputs are.

:func:`closed_form_table` / :func:`wire_cost_table` emit the
machine-readable cost table (``ColoringPlan.wire_cost()``,
``python -m repro_torch.analysis --distributed --json``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .findings import Finding
from .spmd import (SLAB_WIRE_SITE, VOTE_ELEMS, SpmdGeometry, by_phase,
                   distributed_geometry)


# ---------------------------------------------------------------------------
# the closed forms (DESIGN.md §Perf — independent of the runtime modules)
# ---------------------------------------------------------------------------
def halo_round_bytes(num_devices: int, boundary_local: int,
                     wire_colors: int) -> int:
    """H-C4: ``D * ceil(Bl/k) * 4`` — bit-packed boundary halo words."""
    if boundary_local <= 0:
        return 0
    bits = max(1, int(wire_colors).bit_length()) + 1
    k = max(1, 32 // bits)
    return num_devices * (-(-boundary_local // k)) * 4


def spill_round_bytes(verts_global: int) -> int:
    """H-C1: the full packed-int16 ``[Vp]`` gather."""
    return verts_global * 2


def slab_round_bytes(num_devices: int, frontier_cap_v: int,
                     verts_global: int, wire_colors: int) -> int:
    """H-C3: ``(gid, color)`` slab entries — one packed int32 word when
    both fields fit, else two int32 gathers."""
    if frontier_cap_v <= 0:
        return 0
    packed = (wire_colors > 0 and
              int(verts_global).bit_length()
              + int(wire_colors).bit_length() <= 32)
    return num_devices * frontier_cap_v * (4 if packed else 8)


def setup_bytes(num_devices: int, boundary_local: int) -> int:
    """The one-time boundary->halo id-map gather (``D * Bl * 4``)."""
    return num_devices * boundary_local * 4 if boundary_local > 0 else 0


def closed_form_table(*, num_devices: int, verts_local: int,
                      boundary_local: int, wire_colors: int,
                      frontier_cap_v: int = 0, wire: str = "boundary",
                      scheme: str = "1d") -> Dict:
    """The machine-readable cost table for one program geometry — raw
    numbers, no recording."""
    Vp = verts_local * num_devices
    tiers: Dict[str, Dict] = {}
    if wire == "boundary":
        tiers["halo"] = {
            "bytes_per_round": halo_round_bytes(num_devices, boundary_local,
                                                wire_colors),
            "formula": "D*ceil(Bl/k)*4, k=32//(bit_length(C)+1)"}
        tiers["setup"] = {
            "bytes_once": setup_bytes(num_devices, boundary_local),
            "formula": "D*Bl*4"}
    else:
        tiers["spill"] = {"bytes_per_round": spill_round_bytes(Vp),
                          "formula": "Vp*2"}
    if frontier_cap_v > 0:
        tiers["slab"] = {
            "bytes_per_round": slab_round_bytes(num_devices, frontier_cap_v,
                                                Vp, wire_colors),
            "formula": "D*cap_v*4 packed | D*cap_v*8 two-gather"}
    return {"wire": wire, "scheme": scheme, "num_devices": num_devices,
            "verts_local": verts_local, "verts_global": Vp,
            "boundary_local": boundary_local, "wire_colors": wire_colors,
            "frontier_cap_v": frontier_cap_v, "tiers": tiers}


def wire_cost_table(spec, statics) -> Optional[Dict]:
    """:func:`closed_form_table` for a plan spec/envelope (None for
    non-distributed strategies)."""
    from ..core.api import get_strategy
    if get_strategy(spec.strategy).wants != "host":
        return None
    g = distributed_geometry(spec, statics)
    return closed_form_table(
        num_devices=g.num_devices, verts_local=g.verts_local,
        boundary_local=g.boundary_cap, wire_colors=g.wire_colors,
        frontier_cap_v=g.frontier_cap_v, wire=g.wire,
        scheme=spec.partition)


# ---------------------------------------------------------------------------
# recorded-run attribution
# ---------------------------------------------------------------------------
def check_wire_cost(recordings: Sequence, geometry: SpmdGeometry, *,
                    context: str = "") -> List[Finding]:
    """Compare every rank's recorded collectives against the closed-form
    tier accounting for ``geometry``, round by round. Returns WIRE
    findings (the WIRE101 info carries the cost table and what the run
    gathered)."""
    g = geometry
    findings: List[Finding] = []
    D, Vp = g.num_devices, g.verts_global
    exp_halo = halo_round_bytes(D, g.boundary_cap, g.wire_colors)
    exp_spill = spill_round_bytes(Vp)
    exp_slab = slab_round_bytes(D, g.frontier_cap_v, Vp, g.wire_colors)
    exp_setup = setup_bytes(D, g.boundary_cap)
    slab_packed = (g.wire_colors > 0 and
                   int(Vp).bit_length()
                   + int(g.wire_colors).bit_length() <= 32)
    exp_round = exp_halo if g.wire == "boundary" else exp_spill
    tier_name = "halo" if g.wire == "boundary" else "spill"
    round_site = "core/distributed.py:" + (
        "boundary_wire" if g.wire == "boundary" else "full_wire")
    seen = set()

    def add(code, site, msg):
        if (code, site, msg) not in seen:
            seen.add((code, site, msg))
            findings.append(Finding(code, site, msg, context))

    summary = None
    for rec in recordings:
        setup, rounds, result = by_phase(rec)
        votes = 0
        for e in setup + [x for r in rounds.values() for x in r]:
            if e["kind"] != "all_gather":
                if e["out_elems"] <= VOTE_ELEMS:
                    votes += 1
                else:
                    add("WIRE202", e["site"],
                        f"non-scalar {e['kind']} ({e['out_bytes']} B) "
                        f"matches no documented wire tier (recorded run, "
                        f"{e['phase']})")
        got_setup = sum(e["out_bytes"] for e in setup
                        if e["kind"] == "all_gather")
        if got_setup != exp_setup:
            sites = [e["site"] for e in setup if e["kind"] == "all_gather"]
            add("WIRE203", sites[0] if sites else "core/distributed.py:"
                "_bsp_local",
                f"pre-loop exchange ships {got_setup} B, closed form says "
                f"D*Bl*4 = {exp_setup} B (D={D}, Bl={g.boundary_cap})")
        n_round = n_slab = 0
        for r, evs in sorted(rounds.items()):
            gathers = [e for e in evs if e["kind"] == "all_gather"]
            slab = [e for e in gathers if e["site"] == SLAB_WIRE_SITE]
            tier = [e for e in gathers if e["site"] != SLAB_WIRE_SITE]
            if slab:
                n_slab += 1
                got = sum(e["out_bytes"] for e in slab)
                want_n = 1 if slab_packed else 2
                if g.frontier_cap_v <= 0 or got != exp_slab \
                        or len(slab) != want_n:
                    add("WIRE201", SLAB_WIRE_SITE,
                        f"slab tier ships {got} B in {len(slab)} "
                        f"gather(s), closed form says {exp_slab} B in "
                        f"{want_n} (D={D}, cap_v={g.frontier_cap_v}, "
                        f"packed={slab_packed}; recorded round {r})")
            elif not tier:
                add("WIRE201", round_site,
                    f"{tier_name} tier ships nothing in recorded round {r}, "
                    f"closed form says {exp_round} B")
            if tier:
                n_round += 1
                for e in tier[1:] if not slab else tier:
                    add("WIRE202", e["site"],
                        f"extra per-round all_gather ({e['out_bytes']} B) "
                        f"beyond the single {tier_name}-tier exchange: "
                        "unaccounted wire bytes (recorded run)")
                if not slab and tier[0]["out_bytes"] != exp_round:
                    add("WIRE201", tier[0]["site"],
                        f"{tier_name} tier ships {tier[0]['out_bytes']} "
                        f"B/round, closed form says {exp_round} B (D={D}, "
                        f"Bl={g.boundary_cap}, Vp={Vp}, C={g.wire_colors}; "
                        f"recorded round {r})")
        if summary is None:
            out = sum(e["out_bytes"] for e in result)
            summary = (f"; recorded run: setup {got_setup} B, "
                       f"{n_round} {tier_name} round(s), {n_slab} slab "
                       f"round(s), output {out} B, votes {votes}")
    table = closed_form_table(
        num_devices=D, verts_local=g.verts_local,
        boundary_local=g.boundary_cap, wire_colors=g.wire_colors,
        frontier_cap_v=g.frontier_cap_v, wire=g.wire)
    parts = [f"{name}={t.get('bytes_per_round', t.get('bytes_once'))}B"
             for name, t in sorted(table["tiers"].items())]
    findings.append(Finding(
        "WIRE101", "core/distributed.py:_bsp_local",
        f"wire={g.wire} D={D} Vl={g.verts_local} Bl={g.boundary_cap} "
        f"C={g.wire_colors} cap_v={g.frontier_cap_v}: " + " ".join(parts)
        + (summary or ""), context))
    return findings
