#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts and
is right on an NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

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
              kernels also at the RMAT-B skew shape: device ms per launch
              (CUDA events around a run of back-to-back launches), the
              bound (the bytes these inputs need, at 3.35 TB/s), launches
              per colored graph, the plain version's ms.

Ends with a ``{"kernels": [...]}`` line, the card's name and power limit,
and the result line ``{"ok": true, "device": {...}}``. Imports no JAX and
nothing of the JAX package. Exits non-zero, printing no result, without a
card.
"""
from __future__ import annotations

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
def device_busy(fn, top: int = 8):
    """(device-busy seconds, [(name, calls, device ms)] of the ``top``
    entries) of fn() from torch.profiler: the device-side events only
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
    return (total_ms / 1e3 if total_ms > 0 else None), rows[:top]


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
    from repro_torch.core.engine import ell_slab, num_color_words
    from repro_torch.kernels import (FORBID_BIT, KERNELS, conflict_mask,
                                     conflict_mask_plain, firstfit,
                                     firstfit_plain, launch_counts,
                                     reset_launch_counts, round_fused,
                                     round_fused_plain)
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
    busy, top = device_busy(lambda: plan(graphs[0]), top=12)
    t = time.perf_counter()
    plan(graphs[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    busy_txt = ("not measured" if busy is None else
                f"{busy:.3f} s ({100 * (1 - busy / wall):.1f}% idle of "
                f"{wall:.3f} s wall)")
    log(f"phase 3 seed 0 repeat: host wall {wall:.3f} s; device busy "
        f"{busy_txt}; of the wall, Graph.to_device {layout_s:.3f} s; "
        f"host graph generation {gen_s / 2:.1f} s per graph; "
        f"peak device memory {peak / 2**30:.2f} GiB; traces {plan.traces}")
    for name, calls, ms in top:
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

    # ---- phase 5: timings at the main path's shapes ---------------------
    def slabs(g, colors, w):
        # the slab firstfit reads and the packed slab round_fused reads,
        # from a colored graph's ELL layout (the [:V, :D] sink views)
        dg = g.to_device(layout=("edges", "ell"), device="cuda")
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

    dg, c, cpad, V, D, runs = slabs(graphs[0], reports[0].colors, words)
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
        })
    # the wide path (W > 8) at the skew cell's shape
    *_, V, D, skew_runs = slabs(gb, skew["ell_pallas"].colors, skew_words)
    log(f"phase 5 skew shape: [{V} x {D}], W={skew_words}")
    for name, args in skew_runs.items():
        timed(f"{name} (skew)", *args)
    log("phase 5 timings: ok")

    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
