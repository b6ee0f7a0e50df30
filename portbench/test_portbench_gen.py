"""The benchmark's R-MAT generator: a simple undirected CSR with sorted rows,
the same graphs from the same seed, and the statistics of the program's own
generator (which draws numpy's stream instead)."""
import numpy as np
import pytest
import torch

from portbench import gen

PARAMS = {"RMAT-ER": (0.25, 0.25, 0.25, 0.25),
          "RMAT-G": (0.45, 0.15, 0.15, 0.25),
          "RMAT-B": (0.55, 0.15, 0.15, 0.15)}
CPU = torch.device("cpu")


def _pool(family, scale, count, seed):
    return gen.make_pool({"edge_factor": 8, "params": PARAMS[family]},
                         scale, count, seed, CPU)


@pytest.mark.parametrize("family", sorted(PARAMS))
def test_simple_undirected_sorted_csr(family):
    (g,) = _pool(family, 11, 1, 2**31 + 3)
    n = g.num_vertices
    assert n == 2**11 and g.row_ptr.dtype == np.int64
    assert g.col_idx.dtype == np.int32 and g.row_ptr[0] == 0
    assert g.row_ptr[-1] == g.num_directed_edges
    src = np.repeat(np.arange(n), np.diff(g.row_ptr))
    dst = g.col_idx.astype(np.int64)
    assert (src != dst).all()                                 # no self-loop
    key = src * n + dst
    assert (np.diff(key) > 0).all()             # rows sorted, no duplicates
    assert np.array_equal(np.sort(dst * n + src), key)          # symmetric


def test_same_seed_same_graphs_and_pool_graphs_differ():
    a = _pool("RMAT-G", 10, 2, 123)
    b = _pool("RMAT-G", 10, 2, 123)
    for x, y in zip(a, b):
        assert np.array_equal(x.row_ptr, y.row_ptr)
        assert np.array_equal(x.col_idx, y.col_idx)
    assert not np.array_equal(a[0].col_idx, a[1].col_idx)
    c = _pool("RMAT-G", 10, 1, 124)
    assert not np.array_equal(a[0].col_idx, c[0].col_idx)


@pytest.mark.parametrize("family", sorted(PARAMS))
def test_statistics_near_the_programs_generator(family):
    from repro_torch.core import rmat
    ours = _pool(family, 14, 3, 77)
    theirs = [rmat.paper_graph(family, 14, seed=s) for s in range(3)]
    e_ours = np.mean([g.num_directed_edges for g in ours])
    e_theirs = np.mean([g.num_directed_edges for g in theirs])
    assert abs(e_ours - e_theirs) <= 0.005 * e_theirs
    d_ours = np.mean([g.max_degree() for g in ours])
    d_theirs = np.mean([g.max_degree() for g in theirs])
    assert abs(d_ours - d_theirs) <= 0.15 * d_theirs


@pytest.mark.cuda
def test_on_the_card(card):
    (g,) = gen.make_pool({"edge_factor": 8, "params": PARAMS["RMAT-ER"]},
                         12, 1, 5, card)
    src = np.repeat(np.arange(g.num_vertices), np.diff(g.row_ptr))
    key = src * g.num_vertices + g.col_idx
    assert (np.diff(key) > 0).all() and (src != g.col_idx).all()
