"""The coloring helpers the benchmarks and tools call, held bit for bit
against the reference: ``dataflow_levels`` (``repro.core.dataflow``),
``ell_gather_colors`` and ``ell_mex`` (``repro.kernels.ops``; the
reference's ``firstfit`` runs in Pallas interpret mode here) and
``tile_conflict_counts`` (``repro.kernels.round_fused``). The functions are
integer-valued, so the bar is exact equality. On the card ``ell_mex``
launches the port's ``firstfit`` kernel (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.kernels import ell_gather_colors as ref_gather
from repro.kernels import ell_mex as ref_ell_mex
from repro.kernels import tile_conflict_counts as ref_tile_counts
import repro_torch.core as T
from repro_torch.kernels import (ell_gather_colors, ell_mex, firstfit,
                                 tile_conflict_counts)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family", ["RMAT-ER", "RMAT-G", "RMAT-B"])
@pytest.mark.parametrize("pad", [False, True])
def test_dataflow_levels_match_reference(family, pad):
    """Levels and depth, with and without pad edges (src = dst = V)."""
    rg = R.rmat.paper_graph(family, 8, seed=2)
    tg = T.rmat.paper_graph(family, 8, seed=2)
    kw = {"pad_edges_to": rg.num_directed_edges + 37} if pad else {}
    rl, rd = R.dataflow_levels(rg.to_device(**kw))
    tl, td = T.dataflow_levels(tg.to_device(device="cpu", **kw))
    assert tl.dtype == torch.int32
    assert np.array_equal(tl.numpy(), np.asarray(rl)) and td == rd


def test_dataflow_levels_of_an_edgeless_graph():
    rg = R.Graph.from_edges(5, np.zeros((0, 2), np.int64))
    tg = T.Graph.from_edges(5, np.zeros((0, 2), np.int64))
    rl, rd = R.dataflow_levels(rg.to_device())
    tl, td = T.dataflow_levels(tg.to_device(device="cpu"))
    assert np.array_equal(tl.numpy(), np.asarray(rl)) and td == rd == 1


@pytest.mark.parametrize("v,d,words,hi", [(37, 9, 2, 73), (100, 33, 1, 40),
                                          (64, 70, 3, 120), (1, 5, 1, 3)])
def test_ell_gather_and_mex_match_reference(v, d, words, hi):
    """Pad slots (id V) read color 0; rows whose 32·words colors are all
    taken give INT32_MAX, as in the reference's kernel."""
    rng = np.random.default_rng(v + d)
    colors = rng.integers(0, hi, v).astype(np.int32)
    ell = rng.integers(0, v + 1, (v, d)).astype(np.int32)
    got = ell_gather_colors(torch.from_numpy(colors), torch.from_numpy(ell))
    want = ref_gather(jnp.asarray(colors), jnp.asarray(ell))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = ell_mex(torch.from_numpy(colors), torch.from_numpy(ell), words=words)
    want = ref_ell_mex(jnp.asarray(colors), jnp.asarray(ell), words=words)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_ell_mex_goes_through_firstfit():
    """``ell_mex`` is ``firstfit`` on the gathered slab, so on the card it
    launches the kernel (the CPU takes the plain version)."""
    rng = np.random.default_rng(0)
    colors = torch.from_numpy(rng.integers(0, 9, 20).astype(np.int32))
    ell = torch.from_numpy(rng.integers(0, 21, (20, 6)).astype(np.int32))
    assert torch.equal(ell_mex(colors, ell, words=1),
                       firstfit(ell_gather_colors(colors, ell), words=1))


@pytest.mark.parametrize("v", [1, 511, 512, 513, 2000])
@pytest.mark.parametrize("block_v", [128, 512])
def test_tile_conflict_counts_match_reference(v, block_v):
    flags = np.random.default_rng(v).integers(0, 2, v).astype(np.int32)
    got = tile_conflict_counts(torch.from_numpy(flags), block_v)
    want = ref_tile_counts(jnp.asarray(flags), block_v)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
