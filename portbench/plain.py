"""Plain PyTorch pieces of the references: distance-1 first-fit colorings as
the fixpoint of their defining equations, and the checks that judge an
answer against them.

Nothing here imports the program. Each reference takes the benchmark's own
CSR (``portbench.gen.Csr``) and works its colors out from the graph alone.

Both of the paper's algorithms define their colors by equations of the form

    c[v] = mex{ c[w] : (v, w) an edge that forbids v }    for every active v

where the forbidding edges form a DAG (DATAFLOW: ``w < v``; ITERATIVE: ``w``
committed, or pending at a smaller lockstep offset). Such a system has one
solution, and Jacobi sweeps from zero reach it: after ``k`` sweeps every
vertex of DAG depth below ``k`` holds its final value, and a sweep that
changes nothing is at the solution. The mex of each sweep is taken over a
dense ``[rows, colors]`` table in blocks of rows, so that a block stays under
:data:`TABLE_CELLS` entries whatever the degree.

A stream's graphs are rebuilt from the records of its batches by
:func:`apply_delta`, with the set semantics the program documents for an
edge delta.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from portbench import gen

TABLE_CELLS = 1 << 28


class DeviceCsr(NamedTuple):
    """A CSR's directed edges on the device, sources in ascending order."""

    n: int
    row_ptr: torch.Tensor  # [V + 1] int64
    src: torch.Tensor      # [2E] int64
    dst: torch.Tensor      # [2E] int64
    max_degree: int


def to_device(csr, device) -> DeviceCsr:
    row_ptr = torch.from_numpy(np.asarray(csr.row_ptr, np.int64)).to(device)
    deg = row_ptr[1:] - row_ptr[:-1]
    src = torch.repeat_interleave(
        torch.arange(csr.num_vertices, device=device), deg)
    dst = torch.from_numpy(np.asarray(csr.col_idx)).to(device).long()
    return DeviceCsr(csr.num_vertices, row_ptr, src, dst,
                     int(deg.max()) if csr.num_vertices else 0)


def _delta_keys(pairs, n: int, device) -> torch.Tensor:
    """Both directed keys ``u * n + v`` of each pair of an ``[M, 2]`` array,
    self-loops dropped."""
    if pairs is None:
        return torch.zeros(0, dtype=torch.int64, device=device)
    e = torch.from_numpy(np.asarray(pairs, np.int64).reshape(-1, 2)).to(device)
    if e.numel() and (int(e.min()) < 0 or int(e.max()) >= n):
        raise ValueError(f"delta edge endpoint out of range [0, {n})")
    e = e[e[:, 0] != e[:, 1]]
    return torch.cat([e[:, 0] * n + e[:, 1], e[:, 1] * n + e[:, 0]])


def apply_delta(csr, inserts, deletes, device) -> gen.Csr:
    """The graph ``csr`` after one batch of edge changes, worked out on
    ``device``: the deletes first, then the inserts, both ``[M, 2]``
    endpoint arrays in either orientation (or None). Set semantics: repeats,
    self-loops, inserts of present edges and deletes of absent ones change
    nothing, and an edge in both lists ends present. The vertex set stays
    as it is; an endpoint outside it raises ``ValueError``."""
    n = csr.num_vertices
    g = to_device(csr, device)
    key = g.src * n + g.dst                           # ascending, no repeats
    del g
    key = key[~torch.isin(key, _delta_keys(deletes, n, device))]
    key = torch.unique(torch.cat([key, _delta_keys(inserts, n, device)]))
    return gen.csr_from_keys(key, n)


def stale_ends(g: DeviceCsr, before: DeviceCsr,
               colors: np.ndarray) -> np.ndarray:
    """[V] bool: the ends of each edge of ``g`` absent from ``before`` whose
    two ends share a color under ``colors`` (the previous state's): what a
    batch leaves to repair, as a streaming recolor seeds it."""
    n, dev = g.n, g.src.device
    fresh = ~torch.isin(g.src * n + g.dst, before.src * n + before.dst)
    fresh &= g.src < g.dst
    c = torch.from_numpy(np.asarray(colors, np.int32)).to(dev)
    u, v = g.src[fresh], g.dst[fresh]
    hit = c[u] == c[v]
    ends = torch.zeros(n, dtype=torch.bool, device=dev)
    ends[u[hit]] = True
    ends[v[hit]] = True
    return ends.cpu().numpy()


def mex_rows(n: int, fsrc: torch.Tensor, fcol: torch.Tensor,
             max_color: int) -> torch.Tensor:
    """[n] int32: for each row v the least color >= 1 absent from
    ``fcol[fsrc == v]``. ``fsrc`` ascending; colors outside
    ``[1, max_color]`` are ignored (a row forbids at most ``max_color - 1``
    colors, so its mex is at most ``max_color``)."""
    width = max_color + 1
    block = max(1, TABLE_CELLS // width)
    out = torch.empty(n, dtype=torch.int32, device=fsrc.device)
    starts = torch.arange(0, n, block, device=fsrc.device)
    bounds = torch.searchsorted(fsrc, torch.cat(
        [starts, torch.tensor([n], device=fsrc.device)])).tolist()
    for i, lo in enumerate(range(0, n, block)):
        hi = min(n, lo + block)
        rows = fsrc[bounds[i]:bounds[i + 1]] - lo
        cols = fcol[bounds[i]:bounds[i + 1]].long()
        ok = (cols >= 1) & (cols <= max_color)
        table = torch.zeros((hi - lo, width), dtype=torch.bool,
                            device=fsrc.device)
        table[rows[ok], cols[ok]] = True
        table[:, 0] = True
        out[lo:hi] = (~table).to(torch.uint8).argmax(1).to(torch.int32)
    return out


def fixpoint(colors: torch.Tensor, active: torch.Tensor, fsrc: torch.Tensor,
             fdst: torch.Tensor, max_color: int) -> torch.Tensor:
    """Jacobi sweeps of ``c[v] = mex{c[w] : (v, w) forbidding}`` over the
    active rows, from ``colors`` with the active rows cleared, to the
    solution. ``(fsrc, fdst)`` are the forbidding edges, ``fsrc``
    ascending."""
    c = torch.where(active, torch.zeros_like(colors), colors)
    while True:
        new = torch.where(active, mex_rows(c.shape[0], fsrc, c[fdst],
                                           max_color), c)
        if torch.equal(new, c):
            return c
        c = new


class Answer(NamedTuple):
    """What a coloring run says: colors in vertex ids, and for ITERATIVE the
    pending count after each round (None where the algorithm has none)."""

    colors: np.ndarray
    conflicts_per_round: Optional[np.ndarray]


def iterative(g: DeviceCsr, concurrency: int, repair: bool = True,
              colors: Optional[np.ndarray] = None,
              pending: Optional[np.ndarray] = None) -> Answer:
    """Alg. 2 (speculation and iteration) in the lockstep model of ``P =
    concurrency`` OpenMP-static threads. Each round: pending vertices take
    ``offset = rank mod ceil(|U| / P)`` (rank within the pending set); their
    colors are the solution of the first-fit equations in which ``w``
    forbids ``v`` iff ``w`` is committed or pending at a smaller offset;
    then every pending vertex with a pending neighbour of smaller id and
    the same color stays pending. ``repair=False`` stops after the first
    round and keeps its conflicts (a control, not Alg. 2).

    The start is cold (no colors, every vertex pending) unless ``colors``
    ([V] committed colors) and ``pending`` ([V] bool: the vertices to
    recolor) give a warm one; with nothing pending no round runs."""
    n, src, dst = g.n, g.src, g.dst
    colors = (torch.zeros(n, dtype=torch.int32, device=src.device)
              if colors is None else torch.from_numpy(
                  np.asarray(colors, np.int32)).to(src.device))
    pending = (torch.ones(n, dtype=torch.bool, device=src.device)
               if pending is None else torch.from_numpy(
                   np.asarray(pending, np.bool_)).to(src.device))
    history: List[int] = []
    while bool(pending.any()):
        left = int(pending.sum())
        bs = max(1, -(-left // concurrency))
        rank = torch.cumsum(pending.long(), 0) - 1
        offset = torch.where(pending, rank % bs, torch.zeros_like(rank))
        forb = pending[src] & (~pending[dst] | (offset[dst] < offset[src]))
        colors = fixpoint(colors, pending, src[forb], dst[forb],
                          g.max_degree + 1)
        same = (pending[src] & pending[dst] & (colors[src] == colors[dst])
                & (src > dst))
        nxt = torch.zeros_like(pending)
        nxt[src[same]] = True
        history.append(int(nxt.sum()))
        pending = nxt
        if not repair:
            break
    return Answer(colors.cpu().numpy(), np.asarray(history, np.int32))


def greedy(g: DeviceCsr, reverse: bool = False) -> Answer:
    """Serial first-fit in index order (the DATAFLOW DAG ``w -> v`` iff
    ``w < v``). ``reverse=True`` is first-fit in the reverse order (a
    control: a valid coloring, but not the one the order defines)."""
    forb = (g.dst > g.src) if reverse else (g.dst < g.src)
    colors = fixpoint(torch.zeros(g.n, dtype=torch.int32,
                                  device=g.src.device),
                      torch.ones(g.n, dtype=torch.bool, device=g.src.device),
                      g.src[forb], g.dst[forb], g.max_degree + 1)
    return Answer(colors.cpu().numpy(), None)


def bad_edges(g: DeviceCsr, colors: np.ndarray) -> int:
    """Edges whose ends share a color, plus vertices without a color >= 1:
    what keeps an answer from being a distance-1 coloring."""
    c = torch.from_numpy(np.asarray(colors, np.int32)).to(g.src.device)
    if c.shape[0] != g.n:
        return g.n + int(g.src.shape[0])
    same = int(((c[g.src] == c[g.dst]) & (g.src < g.dst)).sum())
    return same + int((c < 1).sum())
