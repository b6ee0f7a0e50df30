"""repro_torch on an NVIDIA card: each CUDA kernel against its plain PyTorch
version on the card (exact equality — the functions are integer-valued),
every launch counted, and the whole ITERATIVE/DATAFLOW path on the card
equal to the same path on the CPU. Every test here needs a card and skips
without one; the file imports neither JAX nor the reference, so it runs on
a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import (COLOR_MASK, conflict_mask,
                                 conflict_mask_plain, firstfit,
                                 firstfit_plain, launch_counts, pack_entries,
                                 round_fused, round_fused_plain)

pytestmark = pytest.mark.cuda

# (rows, width, words, color range[, layout]): ragged V, D=1, W=1 and W=63
# with full rows (INT32_MAX), negative and >= 32*W colors, one row; W=8 and
# W=9 across the switch from register to shared bitsets; a base 4 bytes past
# a 16-byte boundary; contiguous S = D slabs whose last tile ends inside a
# 16-byte word (V not a multiple of the tile, V below one tile, D=1); and
# the RMAT-B scale-16 skew shape. The layout is the [:V, :D] view of a
# (V+1, D+1) slab unless it says otherwise.
SLABS = [(37, 9, 2, (-5, 73)), (13, 1, 1, (-2, 40)), (21, 31, 1, None),
         (18, 2048, 63, None), (50, 12, 3, (-100, 196)), (1, 33, 2, (0, 40)),
         (300, 300, 8, None), (300, 300, 9, None),
         (999, 39, 2, (-3, 70), "misaligned"),
         (70, 2100, 63, None, "misaligned"),
         (1001, 39, 2, (-3, 70), "contiguous"),
         (5, 39, 2, (-3, 70), "contiguous"),
         (513, 1, 1, (-2, 40), "contiguous"),
         (65536, 1999, 63, (-3, 2021))]


def _slab_id(s):
    return f"{s[0]}x{s[1]}w{s[2]}" + (f"-{s[4]}" if len(s) > 4 else "")


@pytest.fixture
def card():
    # decided at run time, never at import: every test worker collects the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "`python3 chip_smoke.py` or `pytest -m cuda`")
    return torch.device("cuda")


def _slab(v, d, words, colors, seed):
    rng = np.random.default_rng(seed)
    if colors is None:  # the first rows hold every color 1..32*words-1
        x = rng.integers(-3, 32 * words + 7, size=(v, d)).astype(np.int32)
        n = 32 * words - 1
        for r in range(min(v, 4)):
            x[r, :n] = rng.permutation(np.arange(1, n + 1))
    else:
        x = rng.integers(*colors, size=(v, d)).astype(np.int32)
    return x


def _equal(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def _layout(x, layout, card):
    """x (numpy, 1-D or 2-D) on the card. A 2-D x is the [:V, :D] view of a
    (V+1, D+1) slab, as the engines pass it, unless the layout is
    "contiguous"; "misaligned" also puts the base 4 bytes past a 16-byte
    boundary."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if layout == "contiguous" or (t.dim() == 1 and layout == "sink"):
        return t.to(card)
    shift = int(layout == "misaligned")
    if t.dim() == 1:
        out = torch.full((t.numel() + shift,), 7, dtype=torch.int32,
                         device=card)[shift:]
    else:
        v, d = t.shape
        out = torch.full(((v + 1) * (d + 1) + shift,), 7, dtype=torch.int32,
                         device=card)[shift:].view(v + 1, d + 1)[:v, :d]
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 * shift
    return out


@pytest.mark.parametrize("shape", SLABS, ids=_slab_id)
def test_kernels_match_plain_on_card(shape, card):
    v, d, words, colors = shape[:4]
    layout = shape[4] if len(shape) > 4 else "sink"
    x = _slab(v, d, words, colors, v * d)
    view = _layout(x, layout, card)
    rng = np.random.default_rng(v)
    forbid = torch.from_numpy(rng.random((v, d)) < 0.6).to(card)
    elig = torch.from_numpy(rng.random((v, d)) < 0.3).to(card)
    own = torch.where(torch.from_numpy(rng.random(v) < 0.5).to(card),
                      view[:, 0] & COLOR_MASK,
                      torch.from_numpy(rng.integers(0, 200, v).astype(np.int32)).to(card))
    own = _layout(own.cpu().numpy(), layout, card)
    before = launch_counts()
    _equal(firstfit(view, words=words), firstfit_plain(view, words=words))
    ent = _layout(pack_entries(view, forbid, elig).cpu().numpy(), layout, card)
    for a, b in zip(round_fused(ent, own, words=words),
                    round_fused_plain(ent, own, words=words)):
        _equal(a, b)
    ids = torch.from_numpy(rng.integers(0, 100, (2, v)).astype(np.int32)).to(card)
    cols = (view[:, 0].contiguous(), view[:, -1].contiguous(), ids[0], ids[1])
    _equal(conflict_mask(*cols), conflict_mask_plain(*cols))
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


@pytest.mark.parametrize("engine", ["sort", "bitmap", "ell_pallas",
                                    "fused_pallas"])
def test_card_run_equals_cpu_run(engine, card):
    g = T.rmat.paper_graph("RMAT-B", 9, seed=0)
    for spec in (T.ColoringSpec(engine=engine, concurrency=64),
                 T.ColoringSpec(strategy="dataflow", engine=engine)):
        got, want = T.color(g, spec), T.color(g, spec, device="cpu")
        _equal(torch.from_numpy(got.colors), torch.from_numpy(want.colors))
        assert got.rounds == want.rounds
        for f in ("conflicts_per_round", "sweeps_per_round",
                  "frontier_sizes_per_round"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _same_report(got, want):
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.rounds == want.rounds
    for f in ("conflicts_per_round", "sweeps_per_round",
              "frontier_sizes_per_round"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("engine", ["ell_pallas", "fused_pallas"])
def test_d2_plan_on_card_equals_cpu(engine, card):
    """A d2 plan at scale 10 on the card == the same plan on the CPU. The
    square's Delta is 682, so the kernels take their wide path (W = 22)."""
    g = T.rmat.paper_graph("RMAT-G", 10, seed=0)
    spec = T.ColoringSpec(strategy="iterative", model="d2", engine=engine,
                          concurrency=16, max_rounds=256)
    before = launch_counts()
    got = T.compile_plan(spec, g)(g)
    after = launch_counts()
    want = T.compile_plan(spec, g, device="cpu")(g)
    _same_report(got, want)
    assert T.validate_d2_coloring(g, got.colors)
    kernel = "firstfit" if engine == "ell_pallas" else "round_fused"
    assert after[kernel] > before[kernel]


@pytest.mark.parametrize("engine", ["sort", "fused_pallas"])
def test_warm_start_repair_on_card_equals_cpu(engine, card):
    """A DynamicColoring delta batch on the card == the same batch on the
    CPU: same seed, same repair histories (round 0 on the frontier path)."""
    g = T.rmat.paper_graph("RMAT-ER", 12, seed=0)
    rng = np.random.default_rng(1)
    V = g.num_vertices
    ins = np.stack([rng.integers(0, V, 256), rng.integers(0, V, 256)], 1)
    dels = g.undirected_edges()[rng.integers(0, g.num_edges, 64)]
    spec = T.ColoringSpec(strategy="recolor", engine=engine, concurrency=256)
    card_dyn = T.DynamicColoring(g, spec)
    cpu_dyn = T.DynamicColoring(g, spec, device="cpu")
    np.testing.assert_array_equal(card_dyn.colors, cpu_dyn.colors)
    got, want = (card_dyn.apply_batch(ins, dels),
                 cpu_dyn.apply_batch(ins, dels))
    assert got.seed_size == want.seed_size > 0
    _same_report(got.report, want.report)
    assert got.report.frontier_sizes_per_round[0] == got.seed_size
    assert T.validate_coloring(card_dyn.graph, card_dyn.colors)
    assert card_dyn.plan.traces == 1
