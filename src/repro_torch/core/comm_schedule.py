"""Coloring-driven collective scheduling — the framework-side application of
the paper's technique (PyTorch port of ``repro.core.comm_schedule``).

A set of point-to-point transfers (e.g. MoE expert all-to-all traffic, or
elastic re-shard moves) must be packed into *rounds* such that no two
transfers in a round share a source or a destination chip (port/link
conflicts). Transfers = vertices; port sharing = edges; rounds = colors:
exactly the distance-1 coloring abstraction of §1 of the paper, solved with
the paper's ITERATIVE algorithm.

The lower bound on rounds is the maximum port degree (max #transfers
touching one chip); greedy coloring of the conflict graph (a union of
cliques) is at most 2x that and in practice about equal to it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .graph import DeviceSpec, Graph
from .greedy_ref import greedy_color
from .iterative import color_iterative


@dataclasses.dataclass
class CommSchedule:
    rounds: List[List[int]]          # transfer indices per round
    num_rounds: int
    lower_bound: int                 # max port degree

    @property
    def optimality_gap(self) -> float:
        return self.num_rounds / max(1, self.lower_bound)


def _clique_edges(groups: np.ndarray) -> np.ndarray:
    """Edges of the union-of-cliques graph induced by equal group labels."""
    order = np.argsort(groups, kind="stable")
    sorted_groups = groups[order]
    edges = []
    start = 0
    for i in range(1, len(order) + 1):
        if i == len(order) or sorted_groups[i] != sorted_groups[start]:
            members = order[start:i]
            if len(members) > 1:
                ii, jj = np.triu_indices(len(members), k=1)
                edges.append(np.stack([members[ii], members[jj]], 1))
            start = i
    if not edges:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(edges, 0)


def schedule_transfers(
    transfers: Sequence[Tuple[int, int]],
    use_device: bool = False,
    max_rounds: int = 64,
    device: DeviceSpec = None,
) -> CommSchedule:
    """Pack (src_chip, dst_chip) transfers into conflict-free rounds.

    ``use_device=True`` runs the port's ITERATIVE algorithm on ``device``
    (``None`` = the card); otherwise the serial oracle on the host."""
    t = np.asarray(transfers, dtype=np.int64)
    n = t.shape[0]
    if n == 0:
        return CommSchedule([], 0, 0)
    # conflict graph: same-src cliques + same-dst cliques; offset dst labels
    src_e = _clique_edges(t[:, 0])
    dst_e = _clique_edges(t[:, 1] + (t[:, 0].max() + 1))
    g = Graph.from_edges(n, np.concatenate([src_e, dst_e], 0))
    if use_device and g.num_directed_edges > 0:
        colors = color_iterative(g, max_rounds=max_rounds,
                                 device=device).colors
    else:
        colors = greedy_color(g)
    k = int(colors.max())
    rounds = [list(np.nonzero(colors == c)[0]) for c in range(1, k + 1)]
    port_deg = max(
        int(np.bincount(t[:, 0]).max()),
        int(np.bincount(t[:, 1]).max()),
    )
    return CommSchedule(rounds=rounds, num_rounds=k, lower_bound=port_deg)


def moe_all_to_all_transfers(send_counts: np.ndarray) -> List[Tuple[int, int]]:
    """Transfers implied by a MoE dispatch matrix ``send_counts[D, D]``
    (tokens device i sends to device j); zero entries need no transfer."""
    src, dst = np.nonzero(send_counts)
    keep = src != dst
    return list(zip(src[keep].tolist(), dst[keep].tolist()))
