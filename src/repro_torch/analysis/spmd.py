"""Shared geometry and recording helpers of the SPMD verifier passes (the
port of ``repro.analysis.spmd``).

The distributed strategy runs one process per rank; each rank's program is
a host round loop issuing ``ProcessMesh`` collectives
(``repro_torch.core.distributed``). The three SPMD passes
(:mod:`.collectives`, :mod:`.wirecost`, :mod:`.halo`) read the recordings
of every rank of one launch, and share two ingredients that live here:

* :class:`SpmdGeometry` — the static mesh/envelope geometry the recorded
  program was built for (``D``, ``Vl``, halo capacity, wire tier, packed
  color bound, frontier slab capacity). :func:`distributed_geometry`
  derives it from a spec/envelope exactly the way the analyzer builds the
  program it records, so closed-form expectations and recorded shapes are
  always about the *same* program. ``D`` is the spec's ``ProcessMesh``
  size (one rank without a mesh);
* the collectives of a recording grouped by phase (before the round loop,
  per round, after it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# the site of the frontier-slab wire: its gathers are the slab tier (the
# reference attributes them by the cond branch they sit in)
SLAB_WIRE_SITE = "core/distributed.py:slab_wire"
# all-reduce outputs at or below this element count are termination/fit
# votes (control plane), not wire payload
VOTE_ELEMS = 2


@dataclasses.dataclass(frozen=True)
class SpmdGeometry:
    """Static geometry of one recorded distributed program.

    ``wire`` is the *resolved* tier ("boundary" | "full" — a spec's
    "auto" records the boundary program; the spill program is the
    ``wire="full"`` sweep cell). ``boundary_cap`` is the halo slab width
    the program pins (with the reference's floor-2 rule for capless
    envelopes), ``wire_colors`` the uncapped provable Delta+1 bound
    sizing the packed payload.
    """

    num_devices: int
    verts_local: int
    edges_local: int
    boundary_cap: int
    wire: str
    wire_colors: int
    max_colors: int
    frontier_cap_v: int
    frontier_cap_e: int
    axis_names: Tuple[str, ...]

    @property
    def verts_global(self) -> int:
        return self.verts_local * self.num_devices


def distributed_geometry(spec, statics) -> SpmdGeometry:
    """The :class:`SpmdGeometry` of the program the analyzer records for
    this spec/envelope — one derivation shared by the recording and every
    closed-form expectation. The boundary program is recorded with a halo
    slab of at least 2 even when the envelope carries none (one rank has
    no boundary): the wire code is shape-generic, and a width-1 slab would
    be a single update row, which the race classifier would (correctly for
    THAT shape, wrongly for the fleet's) discharge."""
    from ..core.frontier import frontier_capacities
    from ..core.graph import pad_bucket

    D = spec.mesh.num_devices if spec.mesh is not None else 1
    V = int(statics.num_vertices)
    Vl = -(-V // D)
    slab = pad_bucket(int(-(-int(statics.padded_edges) // D) * 1.35))
    max_colors = int(statics.max_degree) + 1
    if spec.color_bound > 0:
        max_colors = min(max_colors, int(spec.color_bound))
    use_boundary = spec.wire != "full"
    bcap = max(2, min(Vl, int(statics.boundary_cap))) if use_boundary else 1
    fcv = fce = 0
    if spec.frontier != "off":
        fcv, fce = frontier_capacities(
            Vl, slab, int(statics.max_degree),
            capacity=int(spec.frontier_capacity))
    return SpmdGeometry(
        num_devices=D, verts_local=Vl, edges_local=slab,
        boundary_cap=(bcap if use_boundary else 0),
        wire=("boundary" if use_boundary else "full"),
        wire_colors=int(statics.max_degree) + 1, max_colors=max_colors,
        frontier_cap_v=fcv, frontier_cap_e=fce, axis_names=("x",))


def by_phase(recording) -> Tuple[List[dict], Dict[int, List[dict]],
                                 List[dict]]:
    """(setup collectives, round -> its collectives, result collectives)
    of one rank's recording, each in issue order."""
    setup, rounds, result = [], {}, []
    for e in recording.collectives():
        if e["phase"] == "setup":
            setup.append(e)
        elif e["phase"] == "round":
            rounds.setdefault(int(e["round"]), []).append(e)
        else:
            result.append(e)
    return setup, rounds, result


def signature(e: dict) -> tuple:
    """What must match across ranks for a collective sequence to be
    deadlock-free: kind, reduction, payload shape and dtype."""
    return (e["kind"], e["op"], tuple(e["shape"]), e["dtype"])


def fmt_signature(sig: tuple) -> str:
    kind, op, shape, dtype = sig
    return f"{kind}{'/' + op if op else ''}({list(shape)}:{dtype})"
