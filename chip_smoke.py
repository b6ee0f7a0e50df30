#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts and
is right on an NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero.
They run in the order 1-4, 6-8, 5: the timings come last, on the slabs the
other phases colored.

1. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
              with nvcc (seconds, registers per kernel);
2. kernels  — each kernel against its plain PyTorch version on the card, at
              the main path's and the skew cell's shapes and at edge cases
              (W = 8/9 across the register/shared bitset switch, misaligned
              bases, last tiles that end inside a 16-byte word); exact
              equality;
3. main     — ITERATIVE (paper Alg. 2) on RMAT-ER scale 22: one
              ``compile_plan`` (engine ``fused_pallas``, 16384 lockstep
              threads) serves seeds 0 and 1, then ``color()`` with
              ``ell_pallas`` on seed 0 must match bit for bit; the launch
              counters must show every kernel ran;
4. skew     — RMAT-B scale 16 (Delta 1999, 63-word bitsets) under
              ``ell_pallas``/``fused_pallas``/``sort``, all bit-identical;
              DATAFLOW on RMAT-G scale 16 equals serial greedy;
5. timings  — each kernel at the main path's shapes, and the two slab
              kernels also at the RMAT-B skew shape and at the d2 slab
              [262,144 x 617]: device ms per launch (CUDA events around a
              run of back-to-back launches), the bound (the bytes these
              inputs need, at 3.35 TB/s), launches per colored graph, the
              plain version's ms;
6. models   — distance-2 coloring of RMAT-ER scale 18 (G^2: Delta 617, 20
              bitset words, the kernels' wide path) through a
              ``compile_plan`` with ``model="d2"`` and ``fused_pallas``,
              equal to ``color(square(g))`` with ``ell_pallas``; partial
              distance-2 coloring of a 2^18 x 2^17 random bipartite graph
              (Delta 408, W 13) under both ELL engines; DATAFLOW under d2
              equal to the serial D2 oracle; phase 2's exact check on the
              real d2 and pd2 slabs;
7. stream   — ``DynamicColoring`` (strategy ``recolor``) on phase 3's
              scale-22 graph: 3 batches of 65,536 inserts + 16,384 deletes,
              each repair valid, one program for the whole stream;
8. serve    — ``AsyncColoringService`` on its worker thread: 48 RMAT-G
              scale-16 requests from 3 tenants, one RMAT-ER scale-18 stream
              per tenant (4 delta batches each), then drain, checkpoint,
              restore, and one more batch on the live and the restored
              streams, whose colors must be identical.

Ends with a ``{"kernels": [...]}`` line, the card's name and power limit,
and the result line ``{"ok": true, "device": {...}}``. Imports no JAX and
nothing of the JAX package. Exits non-zero, printing no result, without a
card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT_OPS_PER_S = 67e12       # H100 SXM CUDA-core rate (no tensor cores)
INT32_MAX = 2**31 - 1
SCALE_MAIN = 22
SCALE_SKEW = 16
CONCURRENCY = 16384
SCALE_D2 = 18               # RMAT-ER; its square has Delta 617
LOG_PD2_LEFT = 18           # pd2: 2^18 x 2^17 bipartite, 8 pairs per left
SCALE_D2_DATAFLOW = 12      # the serial D2 oracle is a Python loop
STREAM_BATCHES = 3          # phase 7: 65,536 inserts + 16,384 deletes each
SERVE_REQUESTS = 48         # phase 8: RMAT-G scale 16, seeds 0-47
SERVE_TENANTS = 3
SCALE_SERVE = 16
SCALE_SERVE_STREAM = 18
SERVE_STREAM_BATCHES = 4    # 4,096 inserts + 1,024 deletes each


def log(*args):
    print(*args, flush=True)


def max_abs_err(got, want) -> int:
    import torch
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def device_ms(fn, launches: int, runs: int = 5) -> float:
    """Device ms per call of fn: CUDA events around ``launches`` calls
    issued back to back, divided by the count; the median over ``runs``
    such runs. The host enqueues ahead of the card, so its launch latency
    stays out of the number."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def kernel_cases(dev, main_v: int, main_d: int, main_w: int, main_e: int,
                 skew_v: int, skew_d: int, skew_w: int):
    """Yield (kernel, case name, got, want) over the main path's shapes,
    the skew shape and the edge cases; the caller checks exact equality."""
    import torch
    from repro_torch.kernels import (COLOR_MASK, CONFLICT_BIT, FORBID_BIT,
                                     conflict_mask, conflict_mask_plain,
                                     firstfit, firstfit_plain, round_fused,
                                     round_fused_plain)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def sink_view(v, d, lo, hi):
        # a (V+1, D+1) slab's [:V, :D] view, as the engines hand it over
        return rint(lo, hi, (v + 1, d + 1))[:v, :d]

    def misaligned(t):
        # t's values in a view whose base lies 4 bytes past a 16-byte
        # boundary; a slab keeps a sink column (row stride D + 1)
        if t.dim() == 1:
            out = torch.empty(t.numel() + 1, dtype=torch.int32,
                              device=dev)[1:]
        else:
            v, d = t.shape
            flat = torch.empty((v + 1) * (d + 1) + 1, dtype=torch.int32,
                               device=dev)
            out = flat[1:].view(v + 1, d + 1)[:v, :d]
        out.copy_(t)
        assert out.data_ptr() % 16 == 4
        return out

    def full_rows(v, d, w):
        # rows 0..k hold every color 1..32w-1: their mex is INT32_MAX
        x = rint(-3, 32 * w + 7, (v, d))
        n = 32 * w - 1
        k = min(v, 8)
        if d >= n:
            base = torch.arange(1, n + 1, device=dev, dtype=torch.int32)
            for r in range(k):
                x[r, :n] = base[torch.randperm(n, generator=gen, device=dev)]
        return x

    slabs = [
        ("main", sink_view(main_v, main_d, 0, main_w * 32 - 4), main_w),
        ("ragged", rint(-5, 70, (1000, 37)), 2),
        ("D=1", rint(-2, 40, (513, 1)), 1),
        ("W=1 full rows", full_rows(67, 31, 1), 1),
        ("W=63 full rows", full_rows(300, 2100, 63), 63),
        ("out of range", rint(-100, 32 * 3 + 100, (777, 19)), 3),
        ("strided sink view", sink_view(999, 45, -3, 70), 2),
        ("one row", rint(0, 40, (1, 33)), 1),
        # across the switch from register bitsets (W <= 8) to shared ones
        ("W=8 full rows", full_rows(300, 300, 8), 8),
        ("W=9 full rows", full_rows(300, 300, 9), 9),
        ("misaligned base", misaligned(sink_view(999, 39, -3, 70)), 2),
        ("misaligned W=63", misaligned(full_rows(70, 2100, 63)), 63),
        # S = D: the last tile's span ends 12 bytes past a 16-byte boundary
        ("contiguous ragged tail", rint(-3, 70, (1001, 39)), 2),
        ("V < R", rint(-3, 70, (5, 39)), 2),
        ("D=1 sink view", sink_view(1025, 1, -2, 40), 1),
        ("skew shape", sink_view(skew_v, skew_d, -3, 32 * skew_w + 5),
         skew_w),
    ]
    for name, x, w in slabs:
        got = firstfit(x, words=w)
        want = firstfit_plain(x, words=w)
        if "full rows" in name:
            assert int((want == INT32_MAX).sum()) >= 8, name
        yield "firstfit", name, got, want
        bits = ((rint(0, 10, x.shape) < 6).to(torch.int32) * FORBID_BIT
                | (rint(0, 10, x.shape) < 3).to(torch.int32) * CONFLICT_BIT)
        ent = (x & COLOR_MASK) | bits
        own = torch.where(rint(0, 2, (x.shape[0],)) == 1,
                          x[:, 0] & COLOR_MASK,
                          rint(0, 32 * w, (x.shape[0],)))
        if name.startswith("misaligned"):
            ent, own = misaligned(ent), misaligned(own)
        elif name == "strided sink view":
            own = misaligned(own)   # only the own colors are misaligned
        m_got, c_got = round_fused(ent, own, words=w)
        m_want, c_want = round_fused_plain(ent, own, words=w)
        if name == "main":
            assert int(c_want.sum()) > 0, "conflict lane not exercised"
        yield "round_fused", name + " (mex)", m_got, m_want
        yield "round_fused", name + " (conflict)", c_got, c_want

    for name, e, hi in [("main", main_e, 64), ("ragged", 1001, 5),
                        ("one edge", 1, 3)]:
        cs, cd = rint(-2, hi, (e,)), rint(-2, hi, (e,))
        s, d = rint(0, 1 << 22, (e,)), rint(0, 1 << 22, (e,))
        yield ("conflict_mask", name, conflict_mask(cs, cd, s, d),
               conflict_mask_plain(cs, cd, s, d))


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------
def device_busy(fn):
    """(device-busy seconds, [(name, calls, device ms)] by falling device
    time) of fn() from torch.profiler: the device-side events only
    (kernels, copies, fills), so no time is counted twice under the host
    op that launched it; busy is None when the profiler reports none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = ev.device_time_total or ev.self_device_time_total
        if ev.device_type == DeviceType.CUDA and us > 0:
            rows.append((ev.key, ev.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    total_ms = sum(r[2] for r in rows)
    return (total_ms / 1e3 if total_ms > 0 else None), rows


def slab_paths(rows):
    """The slab kernels' variants a profile shows, decoded from their
    names ``slab_rows_kernel<P, G, fused, bulk>``: P = 0 is the wide path
    (a warp per row, shared bitset), bulk = true the staged bulk-copy
    path."""
    out = []
    for name, calls, ms in rows:
        if "slab_rows_kernel<" not in name:
            continue
        p, _g, fused, bulk = (a.strip() for a in
                              name.split("slab_rows_kernel<")[1]
                              .split(">")[0].split(",")[:4])
        out.append(f"{'round_fused' if fused == 'true' else 'firstfit'} "
                   f"{'wide' if p == '0' else 'narrow'}/"
                   f"{'bulk' if bulk == 'true' else 'plain'} "
                   f"({calls} launches, {ms:.3f} ms)")
    return out


def busy_text(busy, wall):
    if busy is None:
        return "not measured"
    return (f"{busy:.3f} s ({100 * (1 - busy / wall):.1f}% idle of "
            f"{wall:.3f} s wall)")


def real_slabs(g, colors, w):
    """The slab firstfit reads and the packed slab round_fused reads, from
    a colored graph's ELL layout (the [:V, :D] sink views), as closures
    (run, plain, bytes, operations) per kernel."""
    import torch
    from repro_torch.core.engine import ell_slab
    from repro_torch.kernels import (FORBID_BIT, firstfit, firstfit_plain,
                                     round_fused, round_fused_plain)
    dev = torch.device("cuda")
    dg = g.to_device(layout=("edges", "ell"), device=dev)
    c = torch.from_numpy(colors).to(dev)
    cpad = torch.cat([c, c.new_zeros(1)])
    V, D = g.num_vertices, dg.ell_width
    slab = ell_slab(V, D, dg.src, dg.ell_slot, cpad[dg.dst])
    ent = ell_slab(V, D, dg.src, dg.ell_slot, cpad[dg.dst] | FORBID_BIT)
    return dg, c, cpad, V, D, {
        "firstfit": (lambda: firstfit(slab, words=w),
                     lambda: firstfit_plain(slab, words=w),
                     4 * V * D + 4 * V, 4 * V * D),
        "round_fused": (lambda: round_fused(ent, c, words=w),
                        lambda: round_fused_plain(ent, c, words=w),
                        4 * V * D + 4 * V + 8 * V, 6 * V * D),
    }


def check_real_slab(tag, g, colors, w, errors):
    """Phase 2 on a real slab: both ELL kernels against their plain
    versions, exactly, on the neighbor colors a colored graph gives them;
    then the same geometry with random colors over the whole bitset and
    random FORBID/CONFLICT bits, against own colors that tie."""
    import torch
    from repro_torch.kernels import (COLOR_MASK, firstfit, firstfit_plain,
                                     pack_entries, round_fused,
                                     round_fused_plain)
    *_, V, D, runs = real_slabs(g, colors, w)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(-3, 32 * w + 5, (V + 1, D + 1), generator=gen,
                      device="cuda", dtype=torch.int32)[:V, :D]
    forbid = torch.rand((V, D), generator=gen, device="cuda") < 0.6
    elig = torch.rand((V, D), generator=gen, device="cuda") < 0.3
    ent = torch.zeros((V + 1, D + 1), dtype=torch.int32, device="cuda")
    ent[:V, :D] = pack_entries(x, forbid, elig)
    ent = ent[:V, :D]
    own = (x[:, D // 2] & COLOR_MASK).contiguous()
    cases = [(f"{tag} slab", name, run, plain)
             for name, (run, plain, *_b) in runs.items()]
    cases += [(f"{tag} geometry, random colors", "firstfit",
               lambda: firstfit(x, words=w),
               lambda: firstfit_plain(x, words=w)),
              (f"{tag} geometry, random colors", "round_fused",
               lambda: round_fused(ent, own, words=w),
               lambda: round_fused_plain(ent, own, words=w))]
    for label, name, run, plain in cases:
        got, want = run(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for lane, a, b in zip(("mex", "conflict"), got, want):
            torch.cuda.synchronize()
            err = max_abs_err(a, b)
            errors[name] = max(errors[name], err)
            log(f"phase 2 {name} [{label}, W={w}] ({lane}) "
                f"shape=({V}, {D}) max_abs_err={err}")
            assert err == 0, f"{name} disagrees on the {label}"


def same_report(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.colors, b.colors) and a.rounds == b.rounds
            and np.array_equal(a.conflicts_per_round, b.conflicts_per_round)
            and np.array_equal(a.sweeps_per_round, b.sweeps_per_round)
            and np.array_equal(a.frontier_sizes_per_round,
                               b.frontier_sizes_per_round))


def describe(tag, g, rep, wall_s):
    log(f"{tag}: V={g.num_vertices} E={g.num_directed_edges} "
        f"max_degree={g.max_degree()} rounds={rep.rounds} sweeps={rep.sweeps} "
        f"colors={rep.num_colors} conflicts={rep.total_conflicts} "
        f"wall_s={wall_s:.3f}")
    log(f"  sweeps_per_round={rep.sweeps_per_round.tolist()}")
    log(f"  conflicts_per_round={rep.conflicts_per_round.tolist()}")
    log(f"  frontier_sizes_per_round={rep.frontier_sizes_per_round.tolist()}")


def phase_models():
    """Phase 6: d2 and pd2 at full size, and DATAFLOW under d2. Returns
    {tag: (constraint graph, colors, words)} for the slab checks and the
    timings, and the launch counts of the phase."""
    import numpy as np
    import torch
    from repro_torch.core import (BipartiteGraph, ColoringSpec, PlanShape,
                                  color, compile_plan, greedy_color_d2,
                                  pad_bucket, partial_square, rmat, square,
                                  validate_d2_coloring, validate_pd2_coloring)
    from repro_torch.core.engine import num_color_words
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def sync_time(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def report_line(tag, host, rep, lower_s, wall, busy, busy_wall, rows):
        delta = host.max_degree()
        w = num_color_words(delta + 1)
        log(f"phase 6 {tag}: V={host.num_vertices} "
            f"constraint_edges={host.num_directed_edges} Delta={delta} "
            f"W={w} ({'narrow' if w <= 8 else 'wide'} path) "
            f"rounds={rep.rounds} sweeps={rep.sweeps} "
            f"colors={rep.num_colors} conflicts={rep.total_conflicts} "
            f"host lowering {lower_s:.2f} s; request wall {wall:.3f} s "
            f"(lowering included)")
        log(f"  sweeps_per_round={rep.sweeps_per_round.tolist()}")
        log(f"  conflicts_per_round={rep.conflicts_per_round.tolist()}")
        log(f"  frontier_sizes_per_round="
            f"{rep.frontier_sizes_per_round.tolist()}")
        log(f"  ell_pallas on the lowered graph: device busy "
            f"{busy_text(busy, busy_wall)} (profiler on)")
        for p in slab_paths(rows):
            log(f"  kernel path: {p}")
        for name, calls, ms in rows[:6]:
            log(f"  device time: {ms:9.3f} ms in {calls:5d} calls of "
                f"{name[:70]}")
        return w

    out = {}
    reset_launch_counts()
    spec = ColoringSpec(strategy="iterative", model="d2",
                        engine="fused_pallas", concurrency=CONCURRENCY)
    ell = ColoringSpec(strategy="iterative", engine="ell_pallas",
                       concurrency=CONCURRENCY)

    # ---- d2: RMAT-ER scale 18 --------------------------------------------
    g = rmat.paper_graph("RMAT-ER", SCALE_D2, seed=0)
    sq, lower_s = sync_time(lambda: square(g))
    shape = PlanShape(num_vertices=sq.num_vertices,
                      padded_edges=pad_bucket(sq.num_directed_edges),
                      max_degree=sq.max_degree())
    plan = compile_plan(spec, shape, device="cuda")
    rep, wall = sync_time(lambda: plan(g))   # squares g again inside
    assert plan.traces == 1, f"d2 plan.traces={plan.traces}"
    box = []
    busy_wall = time.perf_counter()
    busy, rows = device_busy(lambda: box.append(color(sq, ell, device="cuda")))
    busy_wall = time.perf_counter() - busy_wall
    w = report_line(f"d2 RMAT-ER scale {SCALE_D2}", sq, rep, lower_s, wall,
                    busy, busy_wall, rows)
    assert same_report(box[0], rep), "d2: ell_pallas and fused_pallas differ"
    t = time.perf_counter()
    assert validate_d2_coloring(g, rep.colors), "d2 coloring invalid"
    log(f"  validate_d2_coloring: ok ({time.perf_counter() - t:.2f} s); "
        f"color(square(g), ell_pallas) == plan(g) under d2")
    out["d2"] = (sq, rep.colors, w)
    del g

    # ---- pd2: the d2_compare bipartite generator at L = 2^18 -------------
    L, R = 1 << LOG_PD2_LEFT, 1 << (LOG_PD2_LEFT - 1)
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, L, 8 * L), rng.integers(0, R, 8 * L)],
                     1)
    bg = BipartiteGraph.from_edges(L, R, edges)
    ps, lower_s = sync_time(lambda: partial_square(bg))
    pspec = dataclasses.replace(spec, model="pd2")
    prep, wall = sync_time(lambda: color(bg, pspec, device="cuda"))
    box = []
    busy_wall = time.perf_counter()
    busy, rows = device_busy(lambda: box.append(color(ps, ell, device="cuda")))
    busy_wall = time.perf_counter() - busy_wall
    w = report_line(f"pd2 bipartite {L}x{R} ({bg.num_edges} pairs)", ps,
                    prep, lower_s, wall, busy, busy_wall, rows)
    assert same_report(box[0], prep), "pd2: ell_pallas and fused_pallas differ"
    assert validate_pd2_coloring(bg, prep.colors), "pd2 coloring invalid"
    log("  validate_pd2_coloring: ok; color(partial_square(bg), ell_pallas)"
        " == color(bg) under pd2")
    out["pd2"] = (ps, prep.colors, w)

    # ---- DATAFLOW under d2, against the serial D2 oracle -----------------
    gs = rmat.paper_graph("RMAT-ER", SCALE_D2_DATAFLOW, seed=0)
    df, wall = sync_time(lambda: color(gs, ColoringSpec(
        strategy="dataflow", model="d2", engine="fused_pallas"),
        device="cuda"))
    assert np.array_equal(df.colors, greedy_color_d2(gs)), \
        "DATAFLOW under d2 differs from the serial D2 oracle"
    log(f"phase 6 dataflow d2 RMAT-ER scale {SCALE_D2_DATAFLOW}: "
        f"sweeps={df.sweeps} colors={df.num_colors} slab_sweeps="
        f"{df.frontier_sizes_per_round.tolist()} wall_s={wall:.3f}; "
        f"equal to greedy_color_d2")
    counts = launch_counts()
    log(f"phase 6 launches: {counts}")
    for name, n in counts.items():
        assert n > 0, f"kernel {name} was never launched in phase 6"
    log("phase 6 models: ok")
    return out, counts


def phase_stream(g):
    """Phase 7: DynamicColoring over phase 3's scale-22 graph."""
    import numpy as np
    import torch
    from repro_torch.core import ColoringSpec, DynamicColoring, \
        validate_coloring
    from repro_torch.kernels import launch_counts, reset_launch_counts

    spec = ColoringSpec(strategy="recolor", engine="fused_pallas",
                        concurrency=CONCURRENCY)
    reset_launch_counts()
    t = time.perf_counter()
    dyn = DynamicColoring(g, spec, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 7 cold start: {time.perf_counter() - t:.3f} s, "
        f"colors={dyn.num_colors}, envelope {dyn.plan.statics}")
    rng = np.random.default_rng(1)
    V = g.num_vertices
    for b in range(STREAM_BATCHES):
        ins = np.stack([rng.integers(0, V, 65536), rng.integers(0, V, 65536)],
                       1)
        cur = dyn.graph.undirected_edges()
        dels = cur[rng.integers(0, cur.shape[0], 16384)]
        t = time.perf_counter()
        dr = dyn.apply_batch(inserts=ins, deletes=dels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        assert validate_coloring(dyn.graph, dyn.colors), f"batch {b} invalid"
        # the repair's layout step, timed as its own call
        st = dyn.plan.statics
        t = time.perf_counter()
        dyn.graph.to_device(layout=("edges", "ell"),
                            pad_edges_to=st.padded_edges,
                            ell_width=st.max_degree, device="cuda")
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t
        rep = dr.report
        log(f"phase 7 batch {b}: +{dr.inserted}/-{dr.deleted} edges, "
            f"seed_size={dr.seed_size}, wall {wall:.3f} s = host "
            f"delta_info+seed {dr.host_s:.3f} s + repair "
            f"{wall - dr.host_s:.3f} s (of it Graph.to_device ~{layout_s:.3f}"
            f" s, the rest the round loop on the card); "
            f"colors={dyn.num_colors} (bound {dyn.color_bound})")
        if rep is not None:
            log(f"  rounds={rep.rounds} sweeps={rep.sweeps} "
                f"sweeps_per_round={rep.sweeps_per_round.tolist()} "
                f"conflicts_per_round={rep.conflicts_per_round.tolist()} "
                f"frontier_sizes_per_round="
                f"{rep.frontier_sizes_per_round.tolist()}")
    assert dyn.plan.traces == 1, f"stream plan.traces={dyn.plan.traces}"
    counts = launch_counts()
    log(f"phase 7 plan.traces={dyn.plan.traces} recompiles={dyn.recompiles}; "
        f"launches {counts}")
    for name in ("round_fused", "conflict_mask"):
        assert counts[name] > 0, f"kernel {name} never launched in phase 7"
    log("phase 7 stream: ok")
    return counts


def phase_serve(root):
    """Phase 8: the async service on its worker thread, then checkpoint,
    restore and one more batch on both."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import ColoringSpec, rmat, validate_coloring
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.coloring import AsyncColoringService

    t = time.perf_counter()
    graphs = [rmat.paper_graph("RMAT-G", SCALE_SERVE, seed=s)
              for s in range(SERVE_REQUESTS)]
    tenants = [f"t{i}" for i in range(SERVE_TENANTS)]
    streams = {t_: rmat.paper_graph("RMAT-ER", SCALE_SERVE_STREAM, seed=i)
               for i, t_ in enumerate(tenants)}
    rng = np.random.default_rng(2)
    deltas = {}
    for t_, g in streams.items():
        V, base = g.num_vertices, g.undirected_edges()
        deltas[t_] = [(np.stack([rng.integers(0, V, 4096),
                                 rng.integers(0, V, 4096)], 1),
                       base[rng.integers(0, base.shape[0], 1024)])
                      for _ in range(SERVE_STREAM_BATCHES + 1)]
    log(f"phase 8 host set-up (graphs and deltas): "
        f"{time.perf_counter() - t:.1f} s")

    spec = ColoringSpec(strategy="iterative", engine="fused_pallas",
                        concurrency=CONCURRENCY)
    sspec = ColoringSpec(strategy="recolor", engine="fused_pallas",
                         concurrency=CONCURRENCY)
    cfg = dict(default_spec=spec, max_batch=8, max_delay_s=0.02,
               max_queue_depth=256, device="cuda")
    reset_launch_counts()
    svc = AsyncColoringService(**cfg)
    t = time.perf_counter()
    for t_, g in streams.items():
        svc.open_stream(t_, g, sspec)
    torch.cuda.synchronize()
    log(f"phase 8 opened {len(streams)} streams (cold starts) in "
        f"{time.perf_counter() - t:.2f} s")
    t0 = time.perf_counter()
    svc.start()
    try:
        handles, dhandles = [], []
        per_batch = SERVE_REQUESTS // SERVE_STREAM_BATCHES
        for i, g in enumerate(graphs):
            handles.append(svc.submit(g, tenant=tenants[i % SERVE_TENANTS]))
            if (i + 1) % per_batch == 0:
                b = (i + 1) // per_batch - 1
                for t_ in tenants:
                    dhandles.append(svc.submit_delta(t_, *deltas[t_][b]))
        served = [h.result(timeout=600) for h in handles]
        dserved = [h.result(timeout=600) for h in dhandles]
    finally:
        svc.stop()
    svc.drain()
    wall = time.perf_counter() - t0
    for g, r in zip(graphs, served):
        assert validate_coloring(g, r.report.colors), "served coloring invalid"
    for t_ in tenants:
        dyn = svc.stream(t_)
        assert validate_coloring(dyn.graph, dyn.colors), f"stream {t_}"
    snap = svc.metrics.snapshot()
    cum, win = snap["cumulative"], snap["window"]
    log(f"phase 8 served {len(served)} requests + {len(dserved)} delta "
        f"batches from {SERVE_TENANTS} tenants in {wall:.2f} s on the "
        f"worker thread; tenant_served={svc.tenant_served}")
    log(f"  latency p50={win['p50_ms']:.1f} ms p99={win['p99_ms']:.1f} ms "
        f"max={win['max_ms']:.1f} ms; max queue age "
        f"{cum['max_queue_age_s'] * 1e3:.1f} ms; longest flush "
        f"{cum['max_exec_s'] * 1e3:.1f} ms")
    log(f"  flushes {cum['flushes']}: {cum['flush_reasons']}; cache hit "
        f"rate {snap['cache_hit_rate']:.3f} ({cum['cache_hits']} hits, "
        f"{cum['cache_misses']} misses); program builds {cum['retraces']}; "
        f"seed sizes {[d.result.seed_size for d in dserved]}")

    shutil.rmtree(root, ignore_errors=True)
    step = svc.checkpoint(root)
    back = AsyncColoringService.restore(root, **cfg)
    for t_ in tenants:
        assert np.array_equal(back.stream(t_).colors, svc.stream(t_).colors)
        for s_ in (svc, back):
            s_.submit_delta(t_, *deltas[t_][-1])
            s_.drain()
        assert np.array_equal(back.stream(t_).colors,
                              svc.stream(t_).colors), \
            f"restored stream {t_} differs after one more batch"
        assert validate_coloring(back.stream(t_).graph, back.stream(t_).colors)
    counts = launch_counts()
    log(f"phase 8 checkpoint step {step} -> restore: one more batch on the "
        f"live and the restored streams, colors identical; launches "
        f"{counts}")
    for name in ("round_fused", "conflict_mask"):
        assert counts[name] > 0, f"kernel {name} never launched in phase 8"
    shutil.rmtree(root, ignore_errors=True)
    log("phase 8 serve: ok")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    import numpy as np
    from repro_torch.core import (ColoringSpec, PlanShape, color,
                                  compile_plan, greedy_color, pad_bucket,
                                  rmat, validate_coloring)
    from repro_torch.core.engine import num_color_words
    from repro_torch.kernels import (KERNELS, conflict_mask,
                                     conflict_mask_plain, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}")

    # ---- phase 1: build -------------------------------------------------
    t = time.perf_counter()
    lib_path, build_log = _build.build()
    _build.load()
    log(f"phase 1 build: {time.perf_counter() - t:.2f} s -> "
        f"{os.path.relpath(lib_path)}")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    # ---- host graphs for the main path ----------------------------------
    t = time.perf_counter()
    graphs = [rmat.paper_graph("RMAT-ER", SCALE_MAIN, seed=s) for s in (0, 1)]
    gen_s = time.perf_counter() - t
    log(f"host: generated 2 RMAT-ER scale-{SCALE_MAIN} graphs in {gen_s:.1f} s")
    shape = PlanShape(
        num_vertices=graphs[0].num_vertices,
        padded_edges=pad_bucket(max(g.num_directed_edges for g in graphs)),
        max_degree=max(g.max_degree() for g in graphs))
    words = num_color_words(shape.max_degree + 1)
    log(f"plan shape: {shape}, bitset words W={words}")
    gb = rmat.paper_graph("RMAT-B", SCALE_SKEW, seed=0)
    skew_words = num_color_words(gb.max_degree() + 1)

    # ---- phase 2: kernels vs plain --------------------------------------
    errors = {k.name: 0 for k in KERNELS}
    for kernel, case, got, want in kernel_cases(
            dev, shape.num_vertices, shape.max_degree, words,
            shape.padded_edges, gb.num_vertices, gb.max_degree(),
            skew_words):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errors[kernel] = max(errors[kernel], err)
        log(f"phase 2 {kernel} [{case}] shape={tuple(got.shape)} "
            f"max_abs_err={err}")
        assert err == 0, f"{kernel} [{case}] disagrees with its plain version"
    log("phase 2 kernels vs plain: ok (exact)")

    # ---- phase 3: the main path -----------------------------------------
    spec = ColoringSpec(strategy="iterative", engine="fused_pallas",
                        concurrency=CONCURRENCY)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    plan = compile_plan(spec, shape, device="cuda")
    reports = []
    for seed, g in enumerate(graphs):
        t = time.perf_counter()
        rep = plan(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        describe(f"phase 3 plan request seed={seed}", g, rep, wall)
        assert validate_coloring(g, rep.colors), f"seed {seed}: invalid"
        reports.append(rep)
    assert plan.traces == 1, f"plan.traces={plan.traces}"
    fused_counts = launch_counts()
    t = time.perf_counter()
    ell = color(graphs[0], ColoringSpec(strategy="iterative",
                                        engine="ell_pallas",
                                        concurrency=CONCURRENCY),
                device="cuda")
    torch.cuda.synchronize()
    describe("phase 3 color() ell_pallas seed=0", graphs[0], ell,
             time.perf_counter() - t)
    main_counts = launch_counts()
    assert same_report(ell, reports[0]), \
        "ell_pallas and fused_pallas differ on seed 0"
    log(f"phase 3 launches: plan (2 graphs, fused_pallas) {fused_counts}; "
        f"whole main path {main_counts}")
    for name, n in main_counts.items():
        assert n > 0, f"kernel {name} was never launched on the main path"
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    graphs[0].to_device(layout=("edges", "ell"), pad_edges_to=shape.padded_edges,
                        ell_width=shape.max_degree, device="cuda")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t
    busy, rows = device_busy(lambda: plan(graphs[0]))
    t = time.perf_counter()
    plan(graphs[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"phase 3 seed 0 repeat: host wall {wall:.3f} s; device busy "
        f"{busy_text(busy, wall)}; of the wall, Graph.to_device "
        f"{layout_s:.3f} s; "
        f"host graph generation {gen_s / 2:.1f} s per graph; "
        f"peak device memory {peak / 2**30:.2f} GiB; traces {plan.traces}")
    for name, calls, ms in rows[:12]:
        log(f"  device time: {ms:9.3f} ms in {calls:5d} calls of {name[:70]}")
    log("phase 3 main path: ok")

    # ---- phase 4: skew and exactness ------------------------------------
    log(f"phase 4 RMAT-B scale {SCALE_SKEW}: V={gb.num_vertices} "
        f"E={gb.num_directed_edges} max_degree={gb.max_degree()} "
        f"W={skew_words}")
    skew = {}
    for engine in ("ell_pallas", "fused_pallas", "sort"):
        t = time.perf_counter()
        skew[engine] = color(gb, ColoringSpec(strategy="iterative",
                                              engine=engine,
                                              concurrency=CONCURRENCY),
                             device="cuda")
        torch.cuda.synchronize()
        describe(f"phase 4 {engine}", gb, skew[engine], time.perf_counter() - t)
        assert validate_coloring(gb, skew[engine].colors)
        assert same_report(skew[engine], skew["ell_pallas"]), \
            f"{engine} differs from ell_pallas on RMAT-B"
    gg = rmat.paper_graph("RMAT-G", SCALE_SKEW, seed=0)
    t = time.perf_counter()
    df = color(gg, ColoringSpec(strategy="dataflow", engine="fused_pallas"),
               device="cuda")
    torch.cuda.synchronize()
    log(f"phase 4 dataflow RMAT-G scale {SCALE_SKEW}: sweeps={df.sweeps} "
        f"colors={df.num_colors} slab_sweeps="
        f"{df.frontier_sizes_per_round.tolist()} "
        f"wall_s={time.perf_counter() - t:.3f}")
    assert np.array_equal(df.colors, greedy_color(gg)), \
        "DATAFLOW differs from serial greedy"
    log("phase 4 skew and exactness: ok")

    # ---- phases 6-8: the models, the stream, the service -------------------
    models, counts_models = phase_models()
    for tag, (host, colors, w) in models.items():
        check_real_slab(tag, host, colors, w, errors)
    log("phase 2 kernels vs plain on the d2 and pd2 slabs: ok (exact)")
    counts_stream = phase_stream(graphs[0])
    counts_serve = phase_serve(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "serve_ckpt"))
    by_path = {"main": main_counts, "models": counts_models,
               "stream": counts_stream, "serve": counts_serve}

    # ---- phase 5: timings at the main path's shapes ---------------------
    dg, c, cpad, V, D, runs = real_slabs(graphs[0], reports[0].colors, words)
    E = dg.padded_edges
    csrc, cdst = cpad[dg.src], cpad[dg.dst]
    # conflict_mask reads src/dst only where the colors tie and are > 0
    ties = int(((csrc == cdst) & (csrc > 0)).sum())
    runs["conflict_mask"] = (
        lambda: conflict_mask(csrc, cdst, dg.src, dg.dst),
        lambda: conflict_mask_plain(csrc, cdst, dg.src, dg.dst),
        12 * E + 8 * ties, 3 * E)
    graphs_per_kernel = {"firstfit": 1, "round_fused": 2, "conflict_mask": 3}

    def timed(name, run, plain, nbytes, nops):
        got, want = run(), plain()
        if isinstance(got, tuple):
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
        else:
            err = max_abs_err(got, want)
        assert err == 0, f"{name} disagrees with its plain version"
        ms = device_ms(run, 50)
        plain_ms = device_ms(plain, 3, runs=3)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nops / INT_OPS_PER_S
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        bound = max(bytes_ms, ops_ms)
        log(f"phase 5 {name}: {ms:.4f} ms (bound {bound:.4f} ms by {by}, "
            f"{nbytes / 1e6:.1f} MB; {100 * bound / ms:.1f}% of roofline); "
            f"plain {plain_ms:.3f} ms")
        return err, ms, plain_ms, bound, by

    rows = []
    for k in KERNELS:
        err, ms, plain_ms, bound, by = timed(k.name, *runs[k.name])
        launches = main_counts[k.name]
        log(f"  {k.name} launches on the main path {launches} "
            f"({launches / graphs_per_kernel[k.name]:.1f} per colored graph)")
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches,
            "max_abs_err": max(err, errors[k.name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "launches_by_path": {p: c[k.name] for p, c in by_path.items()},
        })
    # the wide path (W > 8) at the skew cell's shape
    *_, V, D, skew_runs = real_slabs(gb, skew["ell_pallas"].colors,
                                     skew_words)
    log(f"phase 5 skew shape: [{V} x {D}], W={skew_words}")
    for name, args in skew_runs.items():
        timed(f"{name} (skew)", *args)
    # the wide path at the d2 slab (G^2 of RMAT-ER scale 18)
    sq, d2_colors, d2_words = models["d2"]
    *_, V, D, d2_runs = real_slabs(sq, d2_colors, d2_words)
    log(f"phase 5 d2 shape: [{V} x {D}], W={d2_words}")
    for name, args in d2_runs.items():
        timed(f"{name} (d2)", *args)
    log("phase 5 timings: ok")

    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
