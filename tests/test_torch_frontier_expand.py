"""repro_torch.kernels.frontier_expand: the frontier's row-owner flood.

On the CPU: the plain version (what ``compact_frontier`` runs for a CPU
tensor) against the flood's definition — entry ``e`` belongs to the largest
row with edges that starts at or before it, row 0 if there is none —
written here with ``searchsorted``, on the shapes the CUDA kernel must get
right: one graph and a batch of 8, rows spanning many of the kernel's
2,048-entry tiles (a hub of 13,000 edges), runs of empty rows and of empty
slab rows, ``ne > cap_e``, ``nv > cap_v``, ``ne = 0``, ``E = 0``,
``cap_v = 0`` and a ``dst_pad`` other than V; the wrapper's routing and its
argument checks. On a card (``-m cuda``): the kernel against the plain
version bit for bit on the same shapes, and one launch for each
``compact_frontier`` call of a one-shot ITERATIVE and DATAFLOW plan. The
file imports neither JAX nor the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_frontier_expand.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import dataflow, iterative
from repro_torch.kernels import (frontier_expand, frontier_expand_plain,
                                 launch_counts)

TILE = 2048  # the kernel's entries per block


@pytest.fixture
def card():
    # decided at run time, never at import: every test worker collects the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "`pytest -m cuda`")
    return torch.device("cuda")


def _power_law(rng, n, top):
    """Degrees of a skewed graph: most rows short, a few up to ``top``."""
    return np.minimum(rng.zipf(1.7, n), top)


def _case(name):
    """(degrees [B, V], active [B, V], cap_v, cap_e, E or None, dst_pad)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one-graph":
        deg = rng.integers(0, 30, (1, 5000))
        return deg, rng.random((1, 5000)) < 0.2, 2048, 1 << 16, None, None
    if name == "batch-of-8":  # graphs from idle to all active: some spill
        deg = rng.integers(0, 12, (8, 3000))
        act = rng.random((8, 3000)) < np.linspace(0, 1, 8)[:, None]
        return deg, act, 1024, 3 * TILE + 5, None, None
    if name == "rmat-g-hub":  # rows span tiles; one hub of 13,000 edges
        deg = _power_law(rng, 1 << 16, 880)[None]
        deg[0, 777] = 13_000
        act = rng.random((1, 1 << 16)) < 0.3
        act[0, 777] = True
        return deg, act, 1 << 15, 1 << 19, None, None
    if name == "empty-runs":  # isolated vertices in runs; empty slab rows
        deg = rng.integers(1, 9, (2, 4000))
        for lo in (0, 700, 1500, 3900):
            deg[:, lo:lo + 300] = 0
        act = rng.random((2, 4000)) < 0.5
        return deg, act, 4096, 1 << 15, None, None
    if name == "ne-over-cap_e":
        deg = rng.integers(0, 40, (2, 2000))
        return deg, rng.random((2, 2000)) < 0.5, 2048, 5000, None, None
    if name == "nv-over-cap_v":  # the rows past cap_v are cut
        deg = rng.integers(0, 40, (2, 2000))
        return deg, rng.random((2, 2000)) < 0.5, 300, 1 << 16, None, None
    if name == "both-over":
        deg = rng.integers(0, 40, (2, 2000))
        return deg, np.ones((2, 2000), bool), 300, 4000, None, None
    if name == "ne-zero":  # nothing active, then only vertices of degree 0
        deg = rng.integers(0, 5, (2, 1000))
        deg[1, ::3] = 0
        act = np.zeros((2, 1000), bool)
        act[1, ::3] = True
        return deg, act, 512, 4096, None, None
    if name == "no-edges":  # E = 0
        return (np.zeros((2, 500), np.int64), rng.random((2, 500)) < 0.5,
                128, 1024, 0, None)
    if name == "no-rows":  # cap_v = 0
        deg = rng.integers(0, 9, (2, 500))
        return deg, rng.random((2, 500)) < 0.5, 0, 1024, None, None
    if name == "dst-pad":  # global edge targets, a phantom past them
        deg = rng.integers(0, 20, (3, 1500))
        return deg, rng.random((3, 1500)) < 0.3, 512, 1 << 14, None, 10**6
    raise KeyError(name)


CASES = ("one-graph", "batch-of-8", "rmat-g-hub", "empty-runs",
         "ne-over-cap_e", "nv-over-cap_v", "both-over", "ne-zero",
         "no-edges", "no-rows", "dst-pad")


def _rows(active, inc_ptr, cap_v):
    """compact_frontier's vertex half: vert, vdeg, starts and ne."""
    B, V = active.shape
    i32 = dict(dtype=torch.int32, device=active.device)
    deg = inc_ptr[:, 1:] - inc_ptr[:, :-1]
    ne = torch.where(active, deg, torch.zeros_like(deg)).sum(
        -1, dtype=torch.int32)
    rank = torch.cumsum(active.to(torch.int32), 1, dtype=torch.int32) - 1
    row = torch.where(active & (rank < cap_v), rank,
                      torch.full_like(rank, cap_v))
    vert = torch.full((B, cap_v + 1), V, **i32)
    vert.scatter_(1, row.long(), torch.arange(V, **i32).expand(B, V))
    vert = vert[:, :cap_v]
    degp = torch.cat([deg, deg.new_zeros((B, 1))], 1)
    vdeg = degp.gather(1, torch.clamp(vert, max=V).long())
    starts = torch.cumsum(vdeg, 1, dtype=torch.int32) - vdeg
    return vert, vdeg, starts, ne


def _inputs(name, device):
    """The wrapper's arguments for a case, on ``device``: (vert, vdeg,
    starts, ne, inc_ptr, dst), cap_e and the pad."""
    deg, act, cap_v, cap_e, E, pad = _case(name)
    rng = np.random.default_rng(len(name))
    B, V = deg.shape
    inc = np.zeros((B, V + 1), np.int64)
    inc[:, 1:] = np.cumsum(deg, 1)
    E = int(inc[:, -1].max()) + 7 if E is None else E  # padded past 2E
    hi = V if pad is None else pad
    dst = rng.integers(0, hi + 1, (B, E))
    inc_ptr = torch.from_numpy(inc.astype(np.int32)).to(device)
    rows = _rows(torch.from_numpy(act).to(device), inc_ptr, cap_v)
    dst = torch.from_numpy(dst.astype(np.int32)).to(device)
    return (*rows, inc_ptr, dst), cap_e, pad


def _by_definition(vert, vdeg, starts, ne, inc_ptr, dst, cap_e, fill):
    """The flood's definition, per graph, with searchsorted over the starts
    of the rows that hold edges (strictly increasing)."""
    out = []
    for b in range(vert.shape[0]):
        V, E = inc_ptr.shape[1] - 1, dst.shape[1]
        v, d, s = (x[b].numpy().astype(np.int64) for x in (vert, vdeg,
                                                            starts))
        e = np.arange(cap_e)
        rows = np.flatnonzero(d > 0)
        owner = np.zeros(cap_e, np.int64)
        if rows.size:
            k = np.searchsorted(s[rows], e, side="right") - 1
            owner = np.where(k >= 0, rows[np.maximum(k, 0)], 0)
        if v.size:
            slot, src = e - s[owner], v[owner]
        else:
            slot, src = e, np.full(cap_e, V)
        if E:
            g = inc_ptr[b].numpy()[np.minimum(src, V)] + slot
            tgt = dst[b].numpy()[np.clip(g, 0, E - 1)]
        else:
            tgt = np.full(cap_e, fill)
        live = e < min(int(ne[b]), cap_e)
        out.append([np.where(live, owner, v.size), np.where(live, src, V),
                    np.where(live, tgt, fill), np.where(live, slot, 0)])
    return [np.stack([o[i] for o in out]) for i in range(4)]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_is_the_floods_definition(case):
    args, cap_e, pad = _inputs(case, "cpu")
    fill = args[4].shape[1] - 1 if pad is None else pad
    got = frontier_expand_plain(*args, cap_e, fill)
    for a, want in zip(got, _by_definition(*args, cap_e, fill)):
        assert a.dtype == torch.int32 and a.shape == (args[0].shape[0], cap_e)
        np.testing.assert_array_equal(a.numpy(), want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args, cap_e, pad = _inputs("batch-of-8", "cpu")
    before = launch_counts()["frontier_expand"]
    got = frontier_expand(*args, cap_e, dst_pad=pad)
    assert launch_counts()["frontier_expand"] == before
    for a, b in zip(got, frontier_expand_plain(*args, cap_e,
                                               args[4].shape[1] - 1)):
        assert torch.equal(a, b)


def _bad(kind):
    """The wrapper's arguments with one fault, and the message it raises."""
    (vert, vdeg, starts, ne, inc_ptr, dst), cap_e, _ = _inputs("batch-of-8",
                                                               "cpu")
    args = dict(vert=vert, vdeg=vdeg, starts=starts, ne=ne, inc_ptr=inc_ptr,
                dst=dst, cap_e=cap_e, dst_pad=None)
    if kind == "int64":
        args["vdeg"] = vdeg.long()
        return args, "int32"
    if kind == "one-dimensional":
        args["starts"] = starts[0]
        return args, "2-D"
    if kind == "strided-rows":
        args["inc_ptr"] = inc_ptr.repeat_interleave(2, 1)[:, ::2]
        return args, "unit stride"
    if kind == "ne-int64":
        args["ne"] = ne.long()
        return args, "ne must"
    if kind == "ne-strided":
        args["ne"] = torch.cat([ne, ne])[::2]
        return args, "contiguous"
    if kind == "rows-differ":
        args["vdeg"] = vdeg[:, :-1]
        return args, r"one \[B, cap_v\]"
    if kind == "batch-differs":
        args["dst"] = dst[:-1]
        return args, "B = 8"
    if kind == "no-row-pointer":
        args["inc_ptr"] = inc_ptr[:, :0]
        return args, r"V\+1"
    if kind == "negative-cap_e":
        args["cap_e"] = -1
        return args, "cap_e"
    if kind == "huge-cap_e":
        args["cap_e"] = 2**31
        return args, "cap_e"
    if kind == "pad-past-int32":
        args["dst_pad"] = 2**31
        return args, "int32"
    if kind == "two-devices":
        args["dst"] = dst.to("meta")
        return args, "different devices"
    if kind == "unsupported-device":
        args = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}
        return args, "unsupported device"
    raise KeyError(kind)


BAD = ("int64", "one-dimensional", "strided-rows", "ne-int64", "ne-strided",
       "rows-differ", "batch-differs", "no-row-pointer", "negative-cap_e",
       "huge-cap_e", "pad-past-int32", "two-devices", "unsupported-device")


@pytest.mark.parametrize("kind", BAD)
def test_frontier_expand_rejects_what_the_kernel_does_not_take(kind):
    args, message = _bad(kind)
    with pytest.raises(ValueError, match=message):
        frontier_expand(**args)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain_on_card(case, card):
    args, cap_e, pad = _inputs(case, card)
    fill = args[4].shape[1] - 1 if pad is None else pad
    before = launch_counts()["frontier_expand"]
    got = frontier_expand(*args, cap_e, dst_pad=pad)
    assert launch_counts()["frontier_expand"] == before + 1
    want = frontier_expand_plain(*args, cap_e, fill)
    torch.cuda.synchronize()
    for name, a, b in zip(("owner", "src", "dst", "slot"), got, want):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), name)


@pytest.mark.cuda
def test_an_empty_slab_launches_nothing_on_card(card):
    args, _, _ = _inputs("one-graph", card)
    before = launch_counts()["frontier_expand"]
    got = frontier_expand(*args, 0)
    assert launch_counts()["frontier_expand"] == before
    assert all(a.shape == (1, 0) for a in got)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,engine", [("iterative", "sort"),
                                             ("dataflow", "fused_pallas")])
def test_one_launch_per_compaction_in_a_plan(strategy, engine, card,
                                             monkeypatch):
    """Every ``compact_frontier`` call of a one-shot plan on the card
    launches the kernel once, and the colors and histories are the CPU
    run's."""
    module = iterative if strategy == "iterative" else dataflow
    real, calls = module.compact_frontier, []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "compact_frontier", counted)
    g = T.rmat.paper_graph("RMAT-B", 12, seed=1)
    spec = T.ColoringSpec(strategy=strategy, engine=engine, concurrency=64)
    plan = T.compile_plan(spec, g, device="cuda")
    before = launch_counts()["frontier_expand"]
    got = plan(g)
    torch.cuda.synchronize()
    assert calls and launch_counts()["frontier_expand"] - before == len(calls)
    want = T.compile_plan(spec, g, device="cpu")(g)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.rounds == want.rounds
    for f in ("conflicts_per_round", "sweeps_per_round",
              "frontier_sizes_per_round"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
