"""repro_torch on an NVIDIA card: each CUDA kernel against its plain PyTorch
version on the card (exact equality — the functions are integer-valued),
every launch counted, the whole ITERATIVE/DATAFLOW path on the card
equal to the same path on the CPU, and the LM lane (every arch's smoke
config) on the card against the same module on the CPU. Every test here needs a card and skips
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
    for k in ("firstfit", "round_fused", "conflict_mask"):
        assert after[k] == before[k] + 1, k


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


def dist_rank(mesh):
    """One rank of the distributed test below: both ELL engines, frontier
    off and auto, and this rank's kernel launches."""
    from repro_torch.kernels import reset_launch_counts
    g = T.rmat.paper_graph("RMAT-B", 10, seed=3)
    reset_launch_counts()
    out = {}
    for engine in ("ell_pallas", "fused_pallas"):
        for fr in ("off", "auto"):
            rep = T.color(g, T.ColoringSpec(strategy="distributed", mesh=mesh,
                                            engine=engine, frontier=fr))
            out[f"{engine}/{fr}"] = dict(
                colors=rep.colors.tolist(), rounds=rep.rounds,
                conf=rep.conflicts_per_round.tolist(),
                sweeps=rep.sweeps_per_round.tolist(),
                front=rep.frontier_sizes_per_round.tolist())
    out["launches"] = launch_counts()
    out["route"] = mesh.route
    return out


def test_distributed_two_ranks_on_card_equal_cpu(card, tmp_path):
    """Two gloo ranks sharing the card (payloads staged through pinned host
    memory) equal the same two ranks on CPU tensors."""
    from repro_torch.launch import run_ranks
    on_card = run_ranks("test_torch_cuda:dist_rank", 2, device="cuda",
                        timeout=300, workdir=str(tmp_path / "cuda"))
    on_cpu = run_ranks("test_torch_cuda:dist_rank", 2, device="cpu",
                       timeout=300, workdir=str(tmp_path / "cpu"))
    for a, b in zip(on_card, on_cpu):
        assert a["route"] == "host" and b["route"] == "device"
        for key in a:
            if "/" in key:
                assert a[key] == b[key], key
        assert a["ell_pallas/off"] == a["fused_pallas/auto"] | {
            "front": a["ell_pallas/off"]["front"]}
        for name in ("firstfit", "round_fused", "conflict_mask"):
            assert a["launches"][name] > 0, name
            assert b["launches"][name] == 0, name


# --------------------------------------------------------------------------
# the static analyzer on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["iterative", "dataflow", "recolor",
                                      "distributed"])
@pytest.mark.parametrize("engine", ["sort", "ell_pallas", "fused_pallas"])
def test_verify_on_card_gives_the_cpu_findings(strategy, engine, card):
    from repro_torch.analysis import verify_plan
    spec = T.ColoringSpec(strategy=strategy, engine=engine)
    shape = T.PlanShape(num_vertices=48, padded_edges=512, max_degree=8)

    def found(device):
        return sorted((f.code, f.site, f.message) for f in
                      verify_plan(spec, shape, mode="error", device=device))
    assert found("cuda") == found("cpu")


@pytest.mark.parametrize("words,width", [(2, 39), (9, 300), (63, 1999)])
def test_kernel_attributes_report_registers(words, width, card):
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.ops import kernel_attributes
    for k in KERNELS:
        a = kernel_attributes(k.name, words=words, width=width)
        assert a["registers"] > 0, (k.name, a)
        assert 0 < a["block_threads"] <= a["max_threads"], (k.name, a)
        assert a["optin_smem_bytes"] > 0


# --------------------------------------------------------------------------
# the LM serving lane on the card
# --------------------------------------------------------------------------
LM_ARCHS = ["mistral-nemo-12b", "qwen3-4b", "starcoder2-3b", "gemma2-2b",
            "mamba2-130m", "whisper-medium", "recurrentgemma-2b",
            "llama-3.2-vision-11b", "grok-1-314b", "deepseek-v2-lite-16b"]
LM_MOE = {"grok-1-314b", "deepseek-v2-lite-16b"}


def _lm(arch, device, capacity=None, t=16, window=None):
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    if capacity and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    if window:
        cfg = dataclasses.replace(cfg, local_window=window)
    module, _ = models.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(size=(
            2, cfg.vlm.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(
            2, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    return (cfg, module.to(device),
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()})


def _route_moe(monkeypatch, replay=None):
    """Record the expert indices each MoE layer picks, in call order; with
    ``replay``, the layers take those experts instead, at their own router
    probabilities. Returns the recorded picks and the routes left."""
    from repro_torch.models import moe
    real, seen, queue = moe.top_k_lower_index, [], list(replay or [])

    def top_k(probs, k):
        vals, idx = real(probs, k)
        seen.append(idx.cpu())
        if replay is not None:
            idx = queue.pop(0).to(idx.device)
            vals = torch.gather(probs, -1, idx)
        return vals, idx

    monkeypatch.setattr(moe, "top_k_lower_index", top_k)
    return seen, queue


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_logits_on_card_equal_cpu(arch, card, monkeypatch):
    """The same weights and tokens on the card and on the CPU, bf16 as
    configured: the reference's bar on every token. A rounding difference
    may flip a token's expert, so the MoE archs replay the CPU run's
    expert choices on the card."""
    from repro_torch import models
    out, routes = {}, None
    for dev in ("cpu", card):
        cfg, module, batch = _lm(arch, dev)
        if arch in LM_MOE:
            seen, left = _route_moe(monkeypatch, replay=routes)
        with torch.inference_mode():
            out[str(dev)] = models.forward(cfg, module, batch)[0].float().cpu()
        if arch in LM_MOE:
            assert seen and not left
            routes = seen
    got, want = out[str(card)], out["cpu"]
    assert torch.isfinite(got).all() and got.shape == want.shape
    bar = 0.05 * max(float(want.abs().max()), 10.0)
    assert float((got - want).abs().max()) < bar


def _prefill_decode_full(cfg, module, batch, dev, max_len, steps):
    """Prefill ``batch``, decode ``steps`` tokens; per step the decode
    logits, the full forward's last logits, and ``(err, max|full|)``."""
    from repro_torch import models
    rng = np.random.default_rng(1)
    b = batch["tokens"].shape[0]
    out = []
    with torch.inference_mode():
        caches = models.init_cache(cfg, b, max_len, device=dev)
        _, _, caches = models.forward(cfg, module, batch, caches=caches)
        toks = batch["tokens"]
        for _ in range(steps):
            nt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b,)).astype(
                np.int32)).to(dev)
            logits, caches = models.decode_step(cfg, module, caches, nt)
            toks = torch.cat([toks, nt[:, None]], dim=1)
            full = models.forward(cfg, module, dict(batch, tokens=toks))[0][:, -1]
            out.append((logits.float().cpu(), full.float().cpu(),
                        float((logits.float() - full.float()).abs().max()),
                        float(full.float().abs().max())))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_then_decode_on_card_matches_full(arch, card):
    """Prefill + two decode steps on the card == the full forward on the
    card, under the reference's bar (grok's MoE decode drifts in the
    reference too: reported, not asserted)."""
    cfg, module, batch = _lm(arch, card, capacity=8.0)
    errs = [(e, r) for _, _, e, r in
            _prefill_decode_full(cfg, module, batch, card, 32, 2)]
    ok = all(e < 0.05 * max(r, 10.0) for e, r in errs)
    if arch == "grok-1-314b":
        print(f"grok-1-314b decode vs full forward (err, max|ref|): {errs}")
    else:
        assert ok, errs


@pytest.mark.parametrize("t", [6, 20])
@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b"])
def test_lm_local_ring_buffer_wraps_on_card(arch, t, card):
    """The local-attention ring buffer of 8 slots around its wrap on the
    card (a 6-token prefill then four steps: one slot empty, full, slots 0
    and 1 overwritten; a 20-token prefill that wraps): each decode step ==
    the full forward on the card, and == the same decode on the CPU, under
    the reference's bar."""
    runs = {}
    for dev in ("cpu", card):
        cfg, module, batch = _lm(arch, dev, t=t, window=8)
        runs[str(dev)] = _prefill_decode_full(cfg, module, batch, dev, 32, 4)
    for (lg, _, e, r), (lc, _, _, _) in zip(runs[str(card)], runs["cpu"]):
        assert torch.isfinite(lg).all()
        assert e < 0.05 * max(r, 10.0), (e, r)
        assert float((lg - lc).abs().max()) < \
            0.05 * max(float(lc.abs().max()), 10.0)


def test_ell_mex_launches_firstfit_on_card(card):
    from repro_torch.kernels import ell_gather_colors, ell_mex
    rng = np.random.default_rng(0)
    colors = torch.from_numpy(rng.integers(0, 70, 500).astype(np.int32))
    ell = torch.from_numpy(rng.integers(0, 501, (500, 39)).astype(np.int32))
    before = launch_counts()["firstfit"]
    got = ell_mex(colors.to(card), ell.to(card), words=3)
    assert launch_counts()["firstfit"] == before + 1
    want = firstfit_plain(ell_gather_colors(colors, ell), words=3)
    assert torch.equal(got.cpu(), want)


# --------------------------------------------------------------------------
# the device layout on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["iterative", "dataflow"])
def test_plan_layout_on_card_equals_cpu(strategy, card, monkeypatch):
    """One ``plan(g)`` on the card: the DeviceGraph its run gets equals
    ``to_device(device="cpu")`` with the plan's envelope, field by field,
    and the report equals the CPU plan's."""
    import dataclasses
    g = T.rmat.paper_graph("RMAT-G", 11, seed=3)
    spec = T.ColoringSpec(strategy=strategy, engine="fused_pallas")
    plan = T.compile_plan(spec, g)
    seen = []
    run = plan._run
    monkeypatch.setattr(plan, "_run",
                        lambda canon, *st: seen.append(canon) or run(canon, *st))
    got = plan(g)
    (dg,) = seen
    st = plan.statics
    want = dataclasses.replace(
        g.to_device(layout=("edges", "ell"), pad_edges_to=st.padded_edges,
                    ell_width=max(1, st.max_degree), device="cpu"),
        num_directed_edges=st.padded_edges, max_degree=st.max_degree)
    for f in dataclasses.fields(dg):
        a, b = getattr(dg, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.device.type == "cuda", f.name
            _equal(a, b)
        else:
            assert a == b, f.name
    _same_report(got, T.compile_plan(spec, g, device="cpu")(g))


# --------------------------------------------------------------------------
# the sort engine's segment-min (sorted_mex) on the card
# --------------------------------------------------------------------------
def _segments(lengths, seed, num_vertices, sink=0):
    """Sorted (vertex, color) pairs as int32 numpy arrays: segment ``i``
    of ``lengths[i]`` pairs for vertex ``i``, its colors by ``i % 4``:
    0..L-1 (one gap, at its end), 0..L-1 with random holes, 0, 2, 4, ...
    (every pair a gap) or repeats of few colors. Then ``sink`` pairs of the
    inert id ``num_vertices``."""
    rng = np.random.default_rng(seed)
    vs, cs = [], []
    for i, n in enumerate(lengths):
        kind = i % 4
        if kind == 0:
            c = np.arange(n)
        elif kind == 1:
            c = np.sort(rng.choice(n + n // 8 + 1, n, replace=False))
        elif kind == 2:
            c = 2 * np.arange(n)
        else:
            c = np.sort(rng.integers(0, 3, n))
        vs.append(np.full(n, i))
        cs.append(c)
    vs.append(np.full(sink, num_vertices))
    cs.append(np.sort(rng.integers(0, 9, sink)))
    return (np.concatenate(vs).astype(np.int32),
            np.concatenate(cs).astype(np.int32))


def _mex_on_card(v, c, num_vertices, card, offset=(0, 0)):
    """sorted_mex against its plain version on the card, one launch; the
    inputs start ``offset`` int32 words past their allocations' bases."""
    from repro_torch.kernels import sorted_mex, sorted_mex_plain

    def placed(x, k):
        buf = torch.zeros(x.size + k, dtype=torch.int32, device=card)
        buf[k:] = torch.from_numpy(x).to(card)
        return buf[k:]

    vs, cs = placed(v, offset[0]), placed(c, offset[1])
    before = launch_counts()["sorted_mex"]
    got = sorted_mex(vs, cs, num_vertices)
    assert launch_counts()["sorted_mex"] == before + (1 if v.size else 0)
    want = sorted_mex_plain(vs, cs, num_vertices)
    torch.cuda.synchronize()
    _equal(got, want)
    return got


MEX_LENGTHS = {
    # runs across lanes (32), warp chunks (512 pairs), blocks (4,096) alike
    "straddle": [1, 2, 31, 32, 33, 1, 511, 512, 513, 3, 4095, 4096, 4097,
                 7, 9000, 1, 1, 30, 600, 5000] * 3,
    "short": [1, 2, 3, 5] * 700,
    "one-pair": [1],
}
MEX_CASES = [(k, sink, off) for k in MEX_LENGTHS for sink in (0, 5_003)
             for off in ((0, 0), (1, 0), (0, 3))]


@pytest.mark.parametrize("lengths,sink,offset", MEX_CASES,
                         ids=[f"{k}-sink{s}-off{o[0]}{o[1]}"
                              for k, s, o in MEX_CASES])
def test_sorted_mex_matches_plain_on_card(lengths, sink, offset, card):
    """Segments straddling lanes, the kernel's 512-pair warp chunks and its
    4,096-pair blocks, with and without an inert tail, M not a multiple of
    4, bases off a 16-byte boundary."""
    sizes = MEX_LENGTHS[lengths]
    v, c = _segments(sizes, len(sizes) + sink, len(sizes) + 2, sink)
    _mex_on_card(v, c, len(sizes) + 2, card, offset)


def test_sorted_mex_on_a_hub_of_gaps_and_on_empty_input(card):
    """A 13,000-pair hub whose every pair is a gap (colors 0, 2, 4, ...),
    with no other vertex; no pair at all."""
    none = 2**31 - 1
    hub = 2 * np.arange(13_000, dtype=np.int32)
    got = _mex_on_card(np.full(13_000, 1, np.int32), hub, 3, card)
    assert got.tolist() == [none, 1, none]
    empty = np.zeros(0, np.int32)
    assert _mex_on_card(empty, empty, 4, card).tolist() == [none] * 4


def test_sorted_mex_at_the_b21_full_sweep_shape(card):
    """``b21.oneshot``'s round-0 sweep: M = 2^25 padded edges + 2^21
    synthetic pairs, V = 2^21, about half the pairs on the inert id, hubs
    of ~13,000 pairs, sorted on the card as ``segment_mex`` sorts them."""
    V, E = 1 << 21, 1 << 25
    gen = torch.Generator(card).manual_seed(21)
    live = E // 2
    # skewed ids: a few hubs of ~13,000 pairs, the rest uniform
    hubs = torch.randint(0, V, (64,), generator=gen, device=card)
    ids = torch.randint(0, V, (live,), generator=gen, device=card)
    ids[:64 * 13_000] = hubs.repeat_interleave(13_000)
    vertex = torch.cat([ids.int(), torch.full((E - live,), V, dtype=torch.int32,
                                              device=card),
                        torch.arange(V, dtype=torch.int32, device=card)])
    color = torch.randint(0, 40, (E,), generator=gen, device=card).int()
    color = torch.cat([color, torch.zeros(V, dtype=torch.int32, device=card)])
    order = torch.sort(vertex.long() * (1 << 32) + color.long()).indices
    v_s, c_s = vertex[order], color[order]
    assert v_s.numel() == 35_651_584
    from repro_torch.kernels import sorted_mex, sorted_mex_plain
    before = launch_counts()["sorted_mex"]
    got = sorted_mex(v_s, c_s, V)
    assert launch_counts()["sorted_mex"] == before + 1
    _equal(got, sorted_mex_plain(v_s, c_s, V))


def test_sort_engine_on_card_equals_cpu_and_launches_once_a_sweep(card):
    """One RMAT-B ITERATIVE run on the sort engine: the CPU run's colors
    and per-round conflicts, and one sorted_mex launch per ``mex.sort``
    span (every sweep, full and slab)."""
    from repro_torch.kernels import ops
    g = T.rmat.paper_graph("RMAT-B", 11, seed=2)
    ops.disable()
    ops.reset()
    before = launch_counts()["sorted_mex"]
    ops.enable()
    try:
        got = T.color_iterative(g, concurrency=64, engine="sort")
    finally:
        ops.disable()
    spans = sum(r.name == "mex.sort" for r in ops.spans())
    ops.reset()
    assert spans > 0 and launch_counts()["sorted_mex"] - before == spans
    want = T.color_iterative(g, concurrency=64, engine="sort", device="cpu")
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.rounds == want.rounds
    np.testing.assert_array_equal(got.conflicts_per_round,
                                  want.conflicts_per_round)
    np.testing.assert_array_equal(got.sweeps_per_round,
                                  want.sweeps_per_round)


# --------------------------------------------------------------------------
# the LM training lane on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-130m", "whisper-medium",
                                  "deepseek-v2-lite-16b"])
def test_train_step_on_card_matches_cpu(arch, card):
    """One train step of a float32 copy of the smoke config from the same
    weights and batch on the card and on the CPU: loss within 1e-4 and
    grad_norm within 1e-3 relative, the moments within 1e-4·max(1,
    max|cpu|), the params within 2·lr + 1e-6 (the CPU tests' bars)."""
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import (AdamWConfig, data, init_opt_state,
                                   make_train_step)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dcfg = data.data_config_for(cfg, models.ShapeConfig("t", 16, 2, "train"))
    batch = {k: torch.from_numpy(v) for k, v in
             data.batch_for_step(dcfg, 0).items()}
    out = {}
    for dev in ("cpu", card):
        module, _ = models.init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
        module = module.to(dev)
        state = init_opt_state(module, opt_cfg)
        _, _, m = make_train_step(cfg, opt_cfg)(
            module, state, {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (m, dict(module.named_parameters()), state)
    (mc, pc, sc), (mh, ph, sh) = out[str(card)], out["cpu"]
    assert int(mc["skipped"]) == 0
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= 1e-4 * float(mh["loss"])
    assert abs(float(mc["grad_norm"]) - float(mh["grad_norm"])) <= \
        1e-3 * float(mh["grad_norm"])
    for name, want in ph.items():
        got = pc[name].detach().cpu()
        assert float((got - want.detach()).abs().max()) <= 2 * 1e-3 + 1e-6
        for key in ("m", "v"):
            w = sh[key][name]
            assert float((sc[key][name].cpu() - w).abs().max()) <= \
                1e-4 * max(1.0, float(w.abs().max()))


def test_async_save_of_card_tensors_restores_onto_the_card(card, tmp_path):
    """The snapshot is taken before save returns: card tensors changed at
    once in place are written as they were, and restore puts each leaf back
    on the card, in its dtype, bit for bit (bf16 included)."""
    from repro_torch.train import checkpoint
    gen = torch.Generator(card).manual_seed(0)
    tree = {"p": torch.randn(64, 33, generator=gen, device=card),
            "opt": {"m": torch.randn(64, 33, generator=gen,
                                     device=card).to(torch.bfloat16),
                    "step": torch.tensor(7, dtype=torch.int32, device=card)}}
    want = {"p": tree["p"].clone(), "m": tree["opt"]["m"].clone()}
    th = checkpoint.save(str(tmp_path), 7, tree, async_write=True)
    tree["p"].add_(1.0)
    tree["opt"]["m"].zero_()
    th.join(timeout=60)
    assert not th.is_alive()
    got, step = checkpoint.restore(str(tmp_path), tree)
    assert step == 7 and got["p"].device.type == "cuda"
    assert got["opt"]["m"].dtype == torch.bfloat16
    assert torch.equal(got["p"], want["p"])
    assert torch.equal(got["opt"]["m"], want["m"])
    assert int(got["opt"]["step"]) == 7
