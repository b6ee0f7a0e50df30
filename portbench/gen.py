"""R-MAT graphs made on the device from a seed (the paper's §4 test graphs).

A ``torch.Generator`` on the device draws each edge's quadrant at every
recursion level with probabilities (a, b, c, d); the device shuffles the
vertex ids with a seeded permutation (paper §5.1), drops self-loops,
symmetrises the edges and removes duplicates by one sort of int64 keys
``src * n + dst``. The sorted keys are the CSR: rows in id order, neighbours
sorted within each row. One copy brings the CSR to the host.

A stream of edge changes to such a graph is drawn batch by batch
(:func:`edge_batch`), as the project's own stream benchmark draws them:
inserts with both ends uniform over the vertices, deletes uniform without
repeats over the edges present, each batch from a generator seeded by the
run's seed, the chain and the batch's number.

This is the benchmark's own generator: it does not call the program's
``rmat`` module and does not reproduce numpy's PCG64 stream. The same seed on
the same device type gives the same graphs and the same batches.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# raw edges drawn per call: bounds the [rows, scale] uniform block
_CHUNK_ROWS = 1 << 23


class Csr(NamedTuple):
    """A simple undirected graph in CSR form, on the host."""

    num_vertices: int
    row_ptr: np.ndarray  # [V + 1] int64
    col_idx: np.ndarray  # [2E] int32, sorted within each row

    @property
    def num_directed_edges(self) -> int:
        return int(self.col_idx.shape[0])

    def max_degree(self) -> int:
        return int(np.diff(self.row_ptr).max()) if self.num_vertices else 0


def rmat_csr(scale: int, edge_factor: int, params: Sequence[float],
             gen: torch.Generator, device: torch.device) -> Csr:
    """One R-MAT graph of ``2**scale`` vertices and ``edge_factor * 2**scale``
    raw edges, drawn from ``gen`` (which lives on ``device``)."""
    a, b, c, _ = (float(p) for p in params)
    n = 1 << scale
    m = edge_factor << scale
    cuts = torch.tensor([a, a + b, a + b + c], device=device)
    bits = (1 << torch.arange(scale - 1, -1, -1, device=device,
                              dtype=torch.int64))
    perm = torch.randperm(n, generator=gen, device=device)
    keys = []
    for start in range(0, m, _CHUNK_ROWS):
        rows = min(_CHUNK_ROWS, m - start)
        u = torch.rand((rows, scale), generator=gen, device=device)
        quad = torch.bucketize(u, cuts, right=True)    # 0 a, 1 b, 2 c, 3 d
        src = perm[((quad >= 2).long() * bits).sum(1)]
        dst = perm[((quad % 2).long() * bits).sum(1)]
        del u, quad
        keep = src != dst
        src, dst = src[keep], dst[keep]
        keys += [src * n + dst, dst * n + src]
        del src, dst, keep
    key = torch.unique(torch.cat(keys))                 # sorted, no repeats
    del keys
    return csr_from_keys(key, n)


def csr_from_keys(key: torch.Tensor, n: int) -> Csr:
    """The CSR of the directed edge keys ``src * n + dst``, sorted and
    without repeats, brought to the host in one copy each."""
    src = key // n
    col = (key - src * n).to(torch.int32)
    counts = torch.bincount(src, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return Csr(n, row_ptr.cpu().numpy(), col.cpu().numpy())


def make_pool(graph_cfg: dict, scale: int, count: int, seed: int,
              device: torch.device) -> List[Csr]:
    """``count`` graphs of the configuration's family at ``scale``, drawn in
    turn from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return [rmat_csr(scale, int(graph_cfg["edge_factor"]),
                     graph_cfg["params"], gen, device)
            for _ in range(count)]


def _batch_seed(seed: int, chain: int, step: int) -> int:
    """The generator seed of batch ``step`` of chain ``chain`` in a run of
    ``seed``: mixed, so that no two batches and no pool share a stream."""
    state = np.random.SeedSequence(
        [int(seed) % (1 << 63), int(chain), int(step)]).generate_state(
            1, np.uint64)
    return int(state[0]) % (1 << 63)


def edge_batch(csr: Csr, inserts: int, deletes: int, seed: int, chain: int,
               step: int, device: torch.device
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch ``step`` of chain ``chain`` of edge changes to ``csr``, the
    graph as it stands before the batch: ``inserts`` pairs with both ends
    uniform over the vertices (self-loops, repeats and present edges
    included; they change nothing), and ``deletes`` distinct edges drawn
    uniformly from those present (all of them where fewer are). Host
    ``[M, 2]`` int64 arrays, each pair ``u < v`` among the deletes; the
    vertex set stays as it is."""
    n = csr.num_vertices
    gen = torch.Generator(device=device)
    gen.manual_seed(_batch_seed(seed, chain, step))
    ins = torch.randint(0, n, (inserts, 2), generator=gen, device=device)
    row_ptr = torch.from_numpy(np.asarray(csr.row_ptr, np.int64)).to(device)
    src = torch.repeat_interleave(torch.arange(n, device=device),
                                  row_ptr[1:] - row_ptr[:-1])
    dst = torch.from_numpy(np.asarray(csr.col_idx)).to(device).long()
    half = src < dst
    present = torch.stack([src[half], dst[half]], 1)
    pick = torch.randperm(present.shape[0], generator=gen,
                          device=device)[:deletes]
    return ins.cpu().numpy(), present[pick].cpu().numpy()
