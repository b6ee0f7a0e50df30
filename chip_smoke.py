#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts and
is right on an NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero.
They run in the order 1-4, 6-10, 5: the timings come last, on the slabs the
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
              streams, whose colors must be identical;
9. distributed — ``strategy="distributed"`` on phase 3's scale-22 graph
              as 4 gloo ranks sharing the card (one process per rank, the
              payloads staged through pinned host memory): the
              ``fused_pallas`` run bit-identical to ``ell_pallas``,
              ``sort``, ``wire="full"`` and ``frontier="off"``, and to a
              run whose vertex slab (196,608 per rank) holds the last
              round's pending set, so that round takes the frontier-halo
              wire (the higher global id recolors, so after round r the
              first r + 1 ranks of the 1d blocks hold nothing pending, and
              the last round's set lies on the last rank); valid under
              the 1d and 2d partitions, a plan on seed 0 serving seeds 0
              and 1 with one program (compiled with ``verify="error"``),
              the bytes each plan request gathered equal to its
              ``plan.wire_cost()``; RMAT-B scale 16 on the card equal to the
              same 4 ranks on CPU tensors; a 1-rank NCCL group (and, with
              2+ cards, NCCL with a card per rank against gloo);
10. analysis — ``repro_torch.analysis`` on the card: the registry and
              distributed sweeps on the card equal the same sweeps on CPU
              tensors and the committed baseline (no new finding, no stale
              entry, no ANALYSIS000); ``compile_plan(verify="error")`` passes
              for the scale-22 main plan (which then serves seed 0 as in
              phase 3), the phase-6 d2 plan and phase 9's 4-rank plan (the
              SPMD passes over all four ranks' recordings); the skew plan's
              shared memory fits the card's opt-in limit, and a color bound
              whose bitset does not raises VMEM001; registers and local
              bytes per kernel from ``cudaFuncGetAttributes``.

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
DIST_RANKS = 4              # phase 9: gloo ranks sharing the card
SCALE_DIST_CPU = 16         # phase 9: RMAT-B, the card against the CPU
DIST_TIMEOUT_S = 420        # a rank that fails or outlives this fails
DIST_SLAB_CAP = 196608      # phase 9: a vertex slab the last round fits


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


# --------------------------------------------------------------------------
# phase 9: the distributed strategy
# --------------------------------------------------------------------------
def _summary(rep) -> dict:
    import hashlib
    return dict(sha256=hashlib.sha256(rep.colors.tobytes()).hexdigest(),
                rounds=rep.rounds, colors=rep.num_colors,
                sweeps=rep.sweeps_per_round.tolist(),
                conflicts=rep.conflicts_per_round.tolist(),
                frontier=rep.frontier_sizes_per_round.tolist())


def _same(a: dict, b: dict) -> bool:
    keys = ("sha256", "rounds", "sweeps", "conflicts")
    return all(a[k] == b[k] for k in keys)


def wire_cost_bytes(r: dict) -> int:
    """The bytes a distributed plan request gathers by its plan's
    ``wire_cost()`` table: per tier, and the final colors."""
    tiers = r["cost"]["tiers"]
    slab = sum(f > 0 for f in r["frontier"])
    per_round = tiers["halo" if "halo" in tiers else "spill"]
    return (tiers.get("setup", {}).get("bytes_once", 0)
            + (r["rounds"] - slab) * per_round["bytes_per_round"]
            + slab * tiers.get("slab", {}).get("bytes_per_round", 0)
            + r["cost"]["verts_global"] * 4)


def dist_rank(mesh, graph_dir: str) -> dict:
    """Phase 9, one rank (``repro_torch.launch`` runs it in a process of
    its own): the scale-22 runs, then RMAT-B scale 16 on the card and on
    CPU tensors over the same group. Checks what one rank can check and
    returns its numbers."""
    import collections
    import numpy as np
    import torch
    from repro_torch.core import (ColoringSpec, Graph, ProcessMesh, color,
                                  compile_plan, pad_bucket, partition_graph,
                                  rmat, validate_coloring)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    D = mesh.num_devices
    out = dict(rank=mesh.rank, route=mesh.route, device=str(mesh.device),
               backend=mesh.backend)
    t = time.perf_counter()
    graphs = []
    for seed in (0, 1):
        meta = json.load(open(os.path.join(graph_dir, f"g{seed}.json")))
        graphs.append(Graph(meta["V"],
                            np.load(os.path.join(graph_dir,
                                                 f"g{seed}_row_ptr.npy")),
                            np.load(os.path.join(graph_dir,
                                                 f"g{seed}_col_idx.npy"))))
    out["load_s"] = time.perf_counter() - t
    g = graphs[0]
    t = time.perf_counter()
    lay = partition_graph(g, D)
    out["partition_1d_s"] = time.perf_counter() - t
    out.update(Bl=lay.boundary_local, El=lay.edges_local,
               Vp=lay.padded_vertices)
    del lay

    main = dict(strategy="distributed", mesh=mesh, engine="fused_pallas")
    runs = {}

    def run(tag, graph=g, **kw):
        torch.cuda.synchronize()
        mesh.bytes_gathered = 0
        t = time.perf_counter()
        rep = color(graph, ColoringSpec(**{**main, **kw}))
        torch.cuda.synchronize()
        runs[tag] = dict(_summary(rep), wall_s=time.perf_counter() - t,
                         gathered=mesh.bytes_gathered)
        return rep

    # the envelope of both seeds, the halo capacity read off seed 0
    shape = dataclasses.replace(
        compile_plan(ColoringSpec(**main), g).statics,
        padded_edges=pad_bucket(max(x.num_directed_edges for x in graphs)),
        max_degree=max(x.max_degree() for x in graphs))

    def run_plan(tag, graph=g, plan=None, **kw):
        """A plan request on the seeds' envelope, its gathered bytes and
        the plan's closed-form cost table."""
        plan = plan or compile_plan(ColoringSpec(**{**main, **kw}), shape)
        torch.cuda.synchronize()
        mesh.bytes_gathered = 0
        t = time.perf_counter()
        rep = plan(graph)
        torch.cuda.synchronize()
        runs[tag] = dict(_summary(rep), wall_s=time.perf_counter() - t,
                         gathered=mesh.bytes_gathered, cost=plan.wire_cost())
        return rep

    # ---- the main path and its variations, counted ----------------------
    reset_launch_counts()
    rep_main = run("main")
    run("ell_pallas", engine="ell_pallas")
    run("sort", engine="sort")
    run("wire=full", wire="full")
    run_plan("frontier=off", frontier="off")
    run_plan("wire=full frontier=off", wire="full", frontier="off")
    run_plan("frontier slab", frontier_capacity=DIST_SLAB_CAP)
    t = time.perf_counter()
    partition_graph(g, D, scheme="2d")
    out["partition_2d_s"] = time.perf_counter() - t
    rep_2d = run("partition=2d", partition="2d")
    # phase 10: the seeds' plan gated by the analyzer; every rank records
    # its program, and the SPMD passes read all four recordings
    t = time.perf_counter()
    plan = compile_plan(ColoringSpec(**main), shape, verify="error")
    out["verify_s"] = time.perf_counter() - t
    out["verify_codes"] = dict(sorted(collections.Counter(
        f.code for f in plan.findings).items()))
    out["verify_spmd"] = sorted({f.format() for f in plan.findings
                                 if f.code[:4] in ("COLL", "WIRE", "HALO")})
    for seed, graph in enumerate(graphs):
        prep = run_plan(f"plan seed {seed}", graph, plan)
        if seed == 1 and mesh.rank == 0:
            out["valid_plan_seed1"] = bool(validate_coloring(graph,
                                                             prep.colors))
    out["plan_traces"] = plan.traces
    out["launches"] = launch_counts()
    if mesh.rank == 0:
        out["valid_1d"] = bool(validate_coloring(g, rep_main.colors))
        out["valid_2d"] = bool(validate_coloring(g, rep_2d.colors))
    for tag in ("ell_pallas", "sort", "wire=full", "frontier=off",
                "wire=full frontier=off", "frontier slab", "plan seed 0"):
        assert _same(runs[tag], runs["main"]), f"rank {mesh.rank}: {tag}"
    for tag, r in runs.items():
        for i, f in enumerate(r["frontier"]):
            assert f == 0 or f == r["conflicts"][i - 1], (tag, i)
    slab_rounds = sum(f > 0 for f in runs["frontier slab"]["frontier"])
    assert slab_rounds > 0, ("no round took the slab wire",
                             runs["frontier slab"])
    # every plan request gathers what its plan.wire_cost() says: the setup
    # tier once, the round tier in each round, the slab tier in each slab
    # round, plus the final colors (Vp * 4 B, the program's output)
    for tag, r in runs.items():
        if "cost" in r:
            want = wire_cost_bytes(r)
            assert r["gathered"] == want, (tag, r["gathered"], want,
                                           r["cost"])
    out["slab_rounds"] = slab_rounds
    out["runs"] = runs

    # device-busy share of one more main request, profiled
    wall = time.perf_counter()
    busy, rows = device_busy(lambda: color(g, ColoringSpec(**main)))
    wall = time.perf_counter() - wall
    out["busy_s"], out["busy_wall_s"] = busy, wall
    out["device_time"] = [(n[:60], c, ms) for n, c, ms in rows[:6]]
    del graphs, g

    # ---- RMAT-B scale 16: the card against CPU tensors on one group ------
    gb = rmat.paper_graph("RMAT-B", SCALE_DIST_CPU, seed=0)
    cpu = ProcessMesh(mesh.group, "cpu")
    small = {}
    for tag, m, engine in (("card fused_pallas", mesh, "fused_pallas"),
                           ("card sort", mesh, "sort"),
                           ("cpu sort", cpu, "sort")):
        t = time.perf_counter()
        rep = color(gb, ColoringSpec(**{**main, "mesh": m,
                                        "engine": engine}))
        small[tag] = dict(_summary(rep), wall_s=time.perf_counter() - t,
                          route=m.route)
    assert _same(small["card sort"], small["cpu sort"])
    assert _same(small["card fused_pallas"], small["cpu sort"])
    out["small"] = small
    return out


def nccl_rank(mesh) -> dict:
    """Phase 9 under NCCL: RMAT-B scale 16 under both wires; a 1-rank
    group must equal the same run with no group at all."""
    from repro_torch.core import ColoringSpec, color, rmat
    gb = rmat.paper_graph("RMAT-B", SCALE_DIST_CPU, seed=0)
    out = dict(rank=mesh.rank, route=mesh.route, backend=mesh.backend)
    for wire in ("boundary", "full"):
        spec = ColoringSpec(strategy="distributed", engine="fused_pallas",
                            wire=wire)
        out[wire] = _summary(color(gb, dataclasses.replace(spec, mesh=mesh)))
        if mesh.num_devices == 1:
            alone = _summary(color(gb, spec, device=mesh.device))
            assert _same(out[wire], alone), f"NCCL {wire} != no group"
    assert _same(out["boundary"], out["full"])
    return out


def phase_distributed(root, graphs):
    """Phase 9: the distributed strategy on the card (see the docstring
    at the top)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import run_ranks

    shutil.rmtree(root, ignore_errors=True)
    gdir = os.path.join(root, "graphs")
    os.makedirs(gdir)
    for seed, g in enumerate(graphs):
        np.save(os.path.join(gdir, f"g{seed}_row_ptr.npy"), g.row_ptr)
        np.save(os.path.join(gdir, f"g{seed}_col_idx.npy"), g.col_idx)
        with open(os.path.join(gdir, f"g{seed}.json"), "w") as f:
            json.dump({"V": g.num_vertices}, f)
    t = time.perf_counter()
    ranks = run_ranks("chip_smoke:dist_rank", DIST_RANKS,
                      dict(graph_dir=gdir), backend="gloo", device="cuda",
                      timeout=DIST_TIMEOUT_S,
                      workdir=os.path.join(root, "gloo"))
    log(f"phase 9 {DIST_RANKS} gloo ranks on "
        f"{torch.cuda.get_device_name(0)}: {time.perf_counter() - t:.1f} s "
        f"for the launch (process start, graph load, every run)")
    r0 = ranks[0]
    halo = r0["runs"]["frontier=off"]["cost"]["tiers"]["halo"]
    full = r0["runs"]["wire=full frontier=off"]["cost"]["tiers"]["spill"]
    log(f"  graph V={graphs[0].num_vertices} "
        f"E={graphs[0].num_directed_edges}: Vp={r0['Vp']} El={r0['El']} "
        f"Bl={r0['Bl']}; wire bytes per round (plan.wire_cost()): boundary "
        f"halo {halo['bytes_per_round']} vs full {full['bytes_per_round']} "
        f"({full['bytes_per_round'] / max(1, halo['bytes_per_round']):.2f}x)")
    for r in ranks:
        m = r["runs"]["main"]
        busy = (f"device busy {r['busy_s']:.3f} s, "
                f"{100 * (1 - r['busy_s'] / m['wall_s']):.1f}% idle of the "
                f"main wall (profiled run {r['busy_wall_s']:.3f} s)"
                if r["busy_s"] else "device busy not measured")
        log(f"  rank {r['rank']} ({r['device']}, {r['backend']}, route "
            f"{r['route']}): load {r['load_s']:.1f} s, partition 1d "
            f"{r['partition_1d_s']:.2f} s / 2d {r['partition_2d_s']:.2f} s; "
            f"main wall {m['wall_s']:.3f} s, rounds={m['rounds']} "
            f"sweeps={m['sweeps']}; {busy}; launches {r['launches']}")
        for name, calls, ms in r["device_time"]:
            log(f"    device time: {ms:9.3f} ms in {calls:5d} calls of {name}")
    for tag, run in r0["runs"].items():
        log(f"  {tag}: wall {run['wall_s']:.3f} s rounds={run['rounds']} "
            f"colors={run['colors']} sweeps={run['sweeps']} "
            f"conflicts={run['conflicts']} frontier={run['frontier']}"
            + (f" gathered {run['gathered']} B" if "gathered" in run else ""))
    for r in ranks:
        for tag in r0["runs"]:
            assert _same(r["runs"][tag], r0["runs"][tag]), \
                f"rank {r['rank']} disagrees with rank 0 on {tag}"
        assert r["plan_traces"] == 1, r["plan_traces"]
    assert r0["valid_1d"] and r0["valid_2d"] and r0["valid_plan_seed1"]
    slab_cost = r0["runs"]["frontier slab"]["cost"]["tiers"]["slab"]
    log(f"  frontier slab of {DIST_SLAB_CAP} per rank: "
        f"{r0['slab_rounds']} round(s) on the slab wire, "
        f"{slab_cost['bytes_per_round']} B per slab round")
    for tag, run in r0["runs"].items():
        if "cost" in run:
            log(f"  {tag}: gathered {run['gathered']} B == plan.wire_cost() "
                f"{json.dumps(run['cost']['tiers'])} + final colors "
                f"{run['cost']['verts_global'] * 4} B")
    log("  fused_pallas == ell_pallas == sort == wire=full == frontier=off "
        "== frontier slab == plan (bit-identical); 1d, 2d and plan seed 1 "
        "valid; plan.traces 1; every plan request's gathered bytes equal "
        "its plan.wire_cost()")
    for tag, run in r0["small"].items():
        log(f"  RMAT-B scale {SCALE_DIST_CPU} {tag} ({run['route']} route):"
            f" wall {run['wall_s']:.3f} s rounds={run['rounds']} "
            f"sweeps={run['sweeps']} colors={run['colors']}")
    log(f"  RMAT-B scale {SCALE_DIST_CPU}: the card equals CPU tensors")
    counts = {k.name: sum(r["launches"][k.name] for r in ranks)
              for k in KERNELS}
    for name, n in counts.items():
        assert n > 0, f"kernel {name} never launched in phase 9"

    t = time.perf_counter()
    one = run_ranks("chip_smoke:nccl_rank", 1, backend="nccl",
                    device="cuda", timeout=DIST_TIMEOUT_S,
                    workdir=os.path.join(root, "nccl1"))
    log(f"phase 9 NCCL, 1 rank: {time.perf_counter() - t:.1f} s; rounds "
        f"{one[0]['boundary']['rounds']}, equal to the run with no group "
        f"under both wires")
    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(cards, DIST_RANKS)
        nccl = run_ranks("chip_smoke:nccl_rank", n, backend="nccl",
                         device="cuda", timeout=DIST_TIMEOUT_S,
                         workdir=os.path.join(root, f"nccl{n}"))
        gloo = run_ranks("chip_smoke:nccl_rank", n, backend="gloo",
                         device="cuda", timeout=DIST_TIMEOUT_S,
                         workdir=os.path.join(root, f"gloo{n}"))
        for a, b in zip(nccl, gloo):
            assert _same(a["boundary"], b["boundary"])
        log(f"phase 9 NCCL, {n} ranks on {n} cards == gloo")
    else:
        log("phase 9 NCCL across cards: not run (one card)")
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 9 launches (sum over ranks): {counts}")
    log("phase 9 distributed: ok")
    return counts, ranks


# --------------------------------------------------------------------------
# phase 10: the static analyzer
# --------------------------------------------------------------------------
def phase_analysis(graphs, main_report, models, gb, dist_ranks):
    """Phase 10: ``repro_torch.analysis`` on the card (see the docstring at
    the top)."""
    import collections
    import torch
    from repro_torch.analysis import (AnalysisError, compare, dedupe,
                                      lint_tree, load_baseline,
                                      sweep_distributed, sweep_registry)
    from repro_torch.analysis.budgets import (check_spec_budgets,
                                              default_smem_ceiling)
    from repro_torch.core import ColoringSpec, PlanShape, compile_plan
    from repro_torch.core import pad_bucket
    from repro_torch.core.engine import num_color_words
    from repro_torch.kernels import (KERNELS, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.firstfit import smem_estimate
    from repro_torch.kernels.ops import kernel_attributes

    def by_code(fs):
        return dict(sorted(collections.Counter(f.code for f in fs).items()))

    reset_launch_counts()

    # ---- 1. the registry sweeps, on the card and on CPU tensors -----------
    found = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        fs = dedupe(sweep_registry(device=dev) + sweep_distributed(device=dev))
        torch.cuda.synchronize()
        found[dev] = fs
        log(f"phase 10 registry + distributed sweep on {dev}: "
            f"{time.perf_counter() - t:.2f} s, {len(fs)} findings "
            f"{by_code(fs)}")
    card = {(f.code, f.site, f.message) for f in found["cuda"]}
    host = {(f.code, f.site, f.message) for f in found["cpu"]}
    assert card == host, ("card and CPU findings differ",
                          sorted(card ^ host)[:6])
    new, allowed, stale = compare(dedupe(found["cuda"] + lint_tree()),
                                  load_baseline())
    assert not new, [f.format() for f in new]
    assert not stale, stale
    assert "ANALYSIS000" not in by_code(found["cuda"])
    log(f"  card findings == CPU findings; against the baseline: 0 new, "
        f"{len(allowed)} allowlisted, 0 stale; no ANALYSIS000")

    # ---- 2. the main plan on the scale-22 seed-0 graph --------------------
    spec = ColoringSpec(strategy="iterative", engine="fused_pallas",
                        concurrency=CONCURRENCY)
    t = time.perf_counter()
    compile_plan(spec, graphs[0], device="cuda")
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    plan = compile_plan(spec, graphs[0], device="cuda", verify="error")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    log(f"phase 10 main plan (RMAT-ER scale {SCALE_MAIN}, fused_pallas, "
        f"concurrency {CONCURRENCY}) verify='error': passed; plan build "
        f"{build_s:.3f} s, verify {total_s - build_s:.3f} s; findings "
        f"{by_code(plan.findings)}")
    rep = plan(graphs[0])
    assert same_report(rep, main_report), "verified plan differs from phase 3"
    log("  the verified plan serves seed 0: equal to phase 3")

    # ---- 3. shared memory on the card -------------------------------------
    optin = default_smem_ceiling("cuda")
    sq = models["d2"][0]
    d2_spec = ColoringSpec(strategy="iterative", model="d2",
                           engine="fused_pallas", concurrency=CONCURRENCY)
    d2_shape = PlanShape(num_vertices=sq.num_vertices,
                         padded_edges=pad_bucket(sq.num_directed_edges),
                         max_degree=sq.max_degree())
    t = time.perf_counter()
    d2_plan = compile_plan(d2_spec, d2_shape, device="cuda", verify="error")
    torch.cuda.synchronize()
    log(f"phase 10 d2 plan ({d2_shape}, W="
        f"{num_color_words(d2_shape.max_degree + 1)}) verify='error': "
        f"passed in {time.perf_counter() - t:.3f} s; findings "
        f"{by_code(d2_plan.findings)}")
    skew_shape = PlanShape(num_vertices=gb.num_vertices,
                           padded_edges=pad_bucket(gb.num_directed_edges),
                           max_degree=gb.max_degree())
    skew_w = num_color_words(skew_shape.max_degree + 1)
    skew = check_spec_budgets(ColoringSpec(engine="fused_pallas"), skew_shape,
                              vmem_ceiling=optin)
    assert not [f for f in skew if f.code == "VMEM001"], skew
    log(f"  skew plan W={skew_w}: {smem_estimate(skew_w)} B of shared memory "
        f"per block against the card's opt-in {optin} B "
        f"(cudaDevAttrMaxSharedMemoryPerBlockOptin): fits")
    big = ColoringSpec(engine="fused_pallas", color_bound=1_900_000)
    big_shape = PlanShape(num_vertices=1024, padded_edges=4096,
                          max_degree=2_000_000)
    big_w = num_color_words(big.color_bound)
    try:
        compile_plan(big, big_shape, device="cuda", verify="error")
    except AnalysisError as e:
        assert "VMEM001" in str(e), str(e)
        log(f"  a color_bound of {big.color_bound} (W={big_w}, "
            f"{smem_estimate(big_w)} B per block > {optin} B): "
            "verify='error' raises VMEM001")
    else:
        raise AssertionError("a bitset above the card's shared memory "
                             "passed verify='error'")

    # ---- 4. registers, as the budget pass reads them ----------------------
    shapes = {"main": (num_color_words(graphs[0].max_degree() + 1),
                       graphs[0].max_degree()),
              "skew": (skew_w, gb.max_degree()),
              "d2": (num_color_words(d2_shape.max_degree + 1),
                     d2_shape.max_degree)}
    for k in KERNELS:
        for tag, (w, d) in shapes.items():
            if k.name == "conflict_mask" and tag != "main":
                continue
            a = kernel_attributes(k.name, words=w, width=d)
            assert a["registers"] > 0 and a["max_threads"] >= \
                a["block_threads"] > 0, (k.name, tag, a)
            slab = k.name != "conflict_mask"
            log(f"phase 10 {k.name} [{tag}" + (f", W={w}" if slab else "")
                + f"]: {a['registers']} registers, {a['local_bytes']} B "
                f"local, {a['static_smem_bytes']} B static shared, block "
                f"{a['block_threads']} of max {a['max_threads']} threads, "
                f"dynamic shared {smem_estimate(w) if slab else 0} B of "
                f"{a['optin_smem_bytes']} B")

    # ---- 5. the distributed plan (phase 9's 4-rank launch) ----------------
    r0 = dist_ranks[0]
    for r in dist_ranks:
        assert r["verify_spmd"] == r0["verify_spmd"], r["rank"]
        log(f"phase 10 distributed rank {r['rank']}: compile_plan(verify="
            f"'error') passed in {r['verify_s']:.3f} s; findings "
            f"{r['verify_codes']}")
    for line in r0["verify_spmd"]:
        log(f"  {line[:300]}")
    cost = r0["runs"]["plan seed 0"]["cost"]
    log(f"  plan.wire_cost(): {json.dumps(cost)}")
    for tag in ("plan seed 0", "plan seed 1"):
        run = r0["runs"][tag]
        log(f"  {tag}: gathered {run['gathered']} B == plan.wire_cost() "
            f"over {run['rounds']} round(s) + final colors")
    counts = launch_counts()
    log(f"phase 10 launches (the card sweep, the verified plans): {counts}")
    for name, n in counts.items():
        assert n > 0, f"kernel {name} never launched in phase 10"
    log("phase 10 analysis: ok")
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
    counts_dist, dist_ranks = phase_distributed(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "dist"), graphs)
    counts_analysis = phase_analysis(graphs, reports[0], models, gb,
                                     dist_ranks)
    by_path = {"main": main_counts, "models": counts_models,
               "stream": counts_stream, "serve": counts_serve,
               "distributed": counts_dist, "analysis": counts_analysis}

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
