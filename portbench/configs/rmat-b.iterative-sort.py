"""Plain reference of ``rmat-b.iterative-sort``: ITERATIVE (Alg. 2) in the
lockstep model of the configuration's ``concurrency`` threads, the
semantics of ``plain.iterative`` (the same colors and per-round conflict
counts), solved superstep by superstep instead of by Jacobi sweeps; and its
control, the same with the conflicts of the first round left unrepaired
(it breaks the guarantee that no edge joins two vertices of one color).

In a round the pending vertices take ``offset = rank mod ceil(|U| / P)``,
and ``w`` forbids ``v`` iff ``w`` is committed or pending at a smaller
offset. So the offsets are levels of a DAG: taken in ascending order, each
level's colors are the mex over its own rows of colors already final
(committed, or set at a smaller level this round). A round costs O(E),
whatever the degree: each level's table is as wide as the largest color
its rows see, plus one, not the graph's max degree plus two.
"""
from typing import List

import numpy as np
import torch

from portbench import plain


def iterative_by_levels(g: plain.DeviceCsr, concurrency: int,
                        repair: bool = True) -> plain.Answer:
    n, dev = g.n, g.src.device
    colors = torch.zeros(n, dtype=torch.int32, device=dev)
    pending = torch.ones(n, dtype=torch.bool, device=dev)
    history: List[int] = []
    while True:
        ids = torch.nonzero(pending).flatten()      # ascending: rank order
        left = int(ids.numel())
        if not left:
            break
        bs = -(-left // concurrency)
        # a vertex's level this round: its offset if pending, else -1
        # (committed), so "w forbids a row of level k" is level[w] < k
        level = torch.full((n,), -1, dtype=torch.int64, device=dev)
        level[ids] = torch.arange(left, device=dev) % bs
        for k in range(bs):
            rows = ids[k::bs]
            start = g.row_ptr[rows]
            deg = g.row_ptr[rows + 1] - start
            local = torch.repeat_interleave(
                torch.arange(rows.numel(), device=dev), deg)
            first = torch.cumsum(deg, 0) - deg
            edge = start[local] + torch.arange(local.numel(), device=dev) \
                - first[local]
            w = g.dst[edge]
            forbids = level[w] < k
            fsrc, fcol = local[forbids], colors[w[forbids]]
            top = int(fcol.max()) if fcol.numel() else 0
            colors[rows] = plain.mex_rows(rows.numel(), fsrc, fcol, top + 1)
        same = (pending[g.src] & pending[g.dst]
                & (colors[g.src] == colors[g.dst]) & (g.src > g.dst))
        nxt = torch.zeros_like(pending)
        nxt[g.src[same]] = True
        history.append(int(nxt.sum()))
        pending = nxt
        if not repair:
            break
    return plain.Answer(colors.cpu().numpy(), np.asarray(history, np.int32))


def reference(g, config):
    return iterative_by_levels(g, int(config["spec"]["concurrency"]))


def control(g, config):
    return iterative_by_levels(g, int(config["spec"]["concurrency"]),
                               repair=False)
