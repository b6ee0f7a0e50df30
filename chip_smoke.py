#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts and
is right on an NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero.
They run in the order 1-4, 6-16, 5: the timings come last, on the slabs the
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
              streams, whose colors must be identical; it counts the
              flushes that went through the batched program (``map``);
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
              bytes per kernel from ``cudaFuncGetAttributes``;
11. lm      — the LM serving lane: ``python -m repro_torch.launch.serve``'s
              ``main`` serves the full qwen3-4b config (36 layers, d_model
              2560, 4.41 B params; batch 8, prompt 64, 32 new tokens:
              prefill and decode tok/s, step p50/p99, peak memory), then
              checks that decoding leaks nothing across batch rows; every
              arch (qwen3-4b on the served weights; the others full size,
              or full width with the depth cut to one pattern group)
              prefills and decodes two tokens, each held against the full
              forward under the reference's bar (grok-1-314b's error is
              printed, not asserted: its decode drifts in the reference
              too; whisper-medium is held with one key chunk over its 1500
              frames, and its error as configured, where the full forward
              attends to zero-padded keys as the reference's does, is
              printed). The lane launches none of the three kernels;
12. train   — the LM training lane: ``python -m repro_torch.launch.train``'s
              ``main`` trains mamba2-130m at its full config (batch 8, seq
              512, 40 steps, asynchronous checkpoints every 20), then a
              fresh ``build`` restores step 20 (bit for bit against the
              file) and replays steps 20-39 to main's losses (tolerance
              printed); qwen3-4b at its full config (4.41 B params, bf16
              moments, remat) takes 5 steps of batch 4 x 512: losses, step
              time, tokens/s, model FLOPs share, device busy share and top
              ops, peak memory; its one-layer float32 cut takes one step on
              the card and on CPU tensors from the same weights and batch;
              every other arch but grok-1-314b takes one step at phase
              11's widths and depth cuts. The lane launches none of the
              three kernels;
13. train-sharded — the sharded trainer (``launch.train.build(mesh=)``,
              DTensor params and moments over a ``("data", "model")``
              mesh) on qwen3-4b at full width cut to 2 layers, float32.
              The route is fixed (``SHARDED_ROUTE``): gloo cannot carry
              DTensor's all_gather on CUDA tensors and NCCL takes one rank
              per card, so (b) a 1 x 1 NCCL mesh on the card takes step 0
              against the one-device ``build`` (the step bars of
              ``tests/test_torch_train.py``), then 2 warm steps of batch
              4 x 512 (p50, peak memory, collectives); a 2 x 2 mesh of
              four CPU ranks takes one step of batch 2 x 32, each rank's
              shards held against the same blocks of the one-device step
              on the card from the same weights; per rank, the bytes of
              params and moments it holds, its step wall and its
              collectives by kind, count and bytes; (c) at the smoke
              config, a checkpoint of a 2 x 2 run restored onto (4, 1)
              with ``restore(shardings=)`` and onto the card, each next
              step held to the 2 x 2 run's; (e) ROADMAP C11: mamba2-130m's
              float32 step on the 2 x 2 CPU mesh, each rank's shards held
              to the one-device step in float64; (f) ROADMAP C13: the
              same for qwen3-4b's smoke config with batch 2 in 2
              microbatches, one row each over the 2 data ranks. Each of
              its five ranks counts its own kernel launches from 0; the
              phase reports their sum, which is 0: the lane launches none
              of the kernels;
14. dryrun  — the multi-pod dry run (``python -m repro_torch.launch.dryrun``'s
              ``run_cell``) in worker processes side by side, one fake
              process group each: (a) on the production meshes, fake CUDA
              tensors, full configs: qwen3-4b x {train_4k, prefill_32k,
              decode_32k}, mamba2-130m x {train_4k, long_500k},
              deepseek-v2-lite-16b train_4k on (16, 16), and the
              rmat-coloring cell on (16, 16) and (2, 16, 16): per cell the
              trace seconds, per-rank argument and peak bytes against
              80 GB, FLOPs, collectives by kind and the dominant term; (b)
              the dry run of phase 13's two cells held to what phase 13
              measured in this run: the 2 x 2 CPU cell's rank-0
              collectives (kind, count, result and sent bytes) and held
              bytes exactly, the 1 x 1 card cell's held bytes and local
              matmul FLOPs exactly, its predicted peak printed beside the
              measured ``max_memory_allocated``. The workers launch no
              kernel (their counts are summed: 0);
15. batched — ``plan.map``'s batched program (the graphs stacked into one
              block-diagonal ``BatchedGraph``, each sweep one launch per
              kernel for the whole batch) on the service's ``max_batch``
              of graphs: 8 RMAT-ER scale-19 graphs (seeds 0-7, one
              ``PlanShape``; the union is phase 3's size) under
              ``fused_pallas`` and ``ell_pallas`` (concurrency 16384,
              frontier ``"auto"``), each map bit-identical to
              ``[plan(g) for g in gs]`` and to the other engine's map,
              every coloring valid, each kernel's launches by the map
              against the loop's (> 0, never more), the wall and device
              busy share of map and loop; phase 2's exact checks on the
              union's slab and edges; DATAFLOW ``fused_pallas`` on 8
              RMAT-G scale-16 graphs, map equal to the loop;
16. examples — the port's examples (``examples/*_torch.py``) through their
              ``main(argv)`` on the card: the quickstart at scale 12 under
              ``fused_pallas``, ``ell_pallas`` and DATAFLOW (every result
              validated against the serial oracle; the kernels' launch
              counts before and after each run, and each kernel launched),
              the comm scheduler on 64 devices (ITERATIVE on the card),
              the LM serving wrapper at the smoke config, and the
              training wrapper at the reference example's defaults
              (mamba2-130m, 30 steps, batch 4 x 256), whose loss must
              fall.

Ends with a ``{"kernels": [...]}`` line, the card's name and power limit,
and the result line ``{"ok": true, "device": {...}}``. Imports no JAX and
nothing of the JAX package. Exits non-zero, printing no result, without a
card.

``python3 chip_smoke.py --only main`` (or ``--only batched``) runs the
build and phase 3 (or phase 15) alone and prints no result line: a short
run to time the main path, e.g. against an older tree's ``src`` with this
script copied into it.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
BATCH_GRAPHS = 8            # phase 15: the service's max_batch
SCALE_BATCH = 19            # RMAT-ER; the union is phase 3's size
SCALE_BATCH_DATAFLOW = 16   # RMAT-G
DIST_RANKS = 4              # phase 9: gloo ranks sharing the card
SCALE_DIST_CPU = 16         # phase 9: RMAT-B, the card against the CPU
DIST_TIMEOUT_S = 420        # a rank that fails or outlives this fails
DIST_SLAB_CAP = 196608      # phase 9: a vertex slab the last round fits
LM_SERVE = ["--arch", "qwen3-4b", "--batch", "8", "--prompt-len", "64",
            "--gen", "32"]  # phase 11: the full qwen3-4b config
LM_FULL = ("starcoder2-3b", "gemma2-2b", "mamba2-130m", "whisper-medium",
           "recurrentgemma-2b")
# phase 11: full width, depth cut to one pattern group (deepseek keeps its
# dense prefix layer): num_layers
LM_CUT = {"mistral-nemo-12b": 1, "llama-3.2-vision-11b": 5,
          "deepseek-v2-lite-16b": 2, "grok-1-314b": 1}
# phase 12: the driver's default run at the full mamba2-130m config
TRAIN_MAIN = ["--arch", "mamba2-130m", "--batch", "8", "--seq", "512",
              "--steps", "40", "--ckpt-every", "20", "--log-every", "10"]
TRAIN_RESTORE_STEP = 20
TRAIN_REPLAY_TOL = 1e-3     # replayed losses: x max(1, |loss|)
TRAIN_BIG = ("qwen3-4b", 4, 512, 5)   # arch, batch, seq, steps
BF16_DENSE_FLOPS = 989e12   # H100 SXM dense bf16 peak
# grok-1-314b's one-layer cut holds 6.53 B params: fp32 params and
# gradients plus bf16 moments are 78.4 GB before any activation. Ranks that
# share one card share its memory, so no sharding fits it on one card
TRAIN_SKIP = {"grok-1-314b": "its one-layer cut needs 78.4 GB of fp32 "
                             "params and gradients plus bf16 moments; it "
                             "waits for a machine with 2 or more cards"}
# phase 13: the sharded trainer on qwen3-4b at full width, depth cut
SHARDED_ARCH = "qwen3-4b"
SHARDED_LAYERS = 2
SHARDED_CARD = (4, 512, 3)  # batch, seq, steps on the 1 x 1 NCCL mesh
SHARDED_CPU = (2, 32)       # batch, seq on the 2 x 2 mesh of CPU ranks
SHARDED_TIMEOUT_S = 300
C11_BATCH = (4, 16)         # mamba2's 2 x 2 step: tests/test_torch_train_sharded
C13_BATCH = (2, 16)         # one row per microbatch on 2 x 2 (ROADMAP C13)
# phase 14: the dry run's cells on the production meshes (fake CUDA
# tensors, full configs), each worker a process of its own (one fake
# process group per mesh), the workers run side by side
DRYRUN_WORKERS = [
    [("qwen3-4b", "train_4k", False)],
    [("qwen3-4b", "prefill_32k", False), ("qwen3-4b", "decode_32k", False)],
    [("mamba2-130m", "train_4k", False), ("mamba2-130m", "long_500k", False)],
    [("deepseek-v2-lite-16b", "train_4k", False)],
    [("rmat-coloring", "coloring", False), ("rmat-coloring", "coloring", True)],
]
DRYRUN_TIMEOUT_S = 420

SHARDED_ROUTE = (
    "NCCL refuses two ranks on one card, and gloo cannot carry DTensor's "
    "collectives on CUDA tensors under torch 2.11.0+cu128: its functional "
    "all_gather_into_tensor (every Shard -> Replicate) kills the rank with "
    "SIGSEGV (the c10d all_gather, reduce_scatter, all_reduce and "
    "all_to_all calls pass; launch.mesh.make_mesh refuses such a mesh). "
    "So the 2 x 2 mesh runs on four CPU ranks, and the card runs the same "
    "step on a 1 x 1 NCCL mesh; cross-card sharding waits for a machine "
    "with four cards")
SHARDED_MOE_SKIP = (
    "(d) deepseek-v2-lite-16b not run: on CPU ranks its step does not fit "
    "the phase's time; the MoE constrain sites and expert parallelism on "
    "model are held on the CPU by tests/test_torch_train_sharded.py")
# decode vs the full forward misses the bar in the reference too, and the
# port reproduces the reference: reported, not asserted
LM_REPORTED = {
    "grok-1-314b": "its MoE decode drifts from the full forward in the "
                   "reference (tests/test_decode.py xfails it)",
}
# at 1500 frames the full forward's non-causal attention pads the keys to
# two 1024-key chunks and attends to the zero pad, which decode's
# cache_attention does not (as in the reference, ROADMAP C9): whisper is
# held with one key chunk over all its keys, its error as configured printed
LM_ONE_KV_CHUNK = ("whisper-medium",)


def torch_version() -> str:
    import torch
    return torch.__version__


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
    from repro_torch.core import (ColoringPlan, ColoringSpec, rmat,
                                  validate_coloring)
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
    # count the flushes that go through the batched program (plan.map)
    maps, plan_map = [], ColoringPlan.map

    def counted_map(self, graphs):
        graphs = list(graphs)
        maps.append(len(graphs))
        return plan_map(self, graphs)

    ColoringPlan.map = counted_map
    try:
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
                handles.append(svc.submit(g,
                                          tenant=tenants[i % SERVE_TENANTS]))
                if (i + 1) % per_batch == 0:
                    b = (i + 1) // per_batch - 1
                    for t_ in tenants:
                        dhandles.append(svc.submit_delta(t_,
                                                         *deltas[t_][b]))
            served = [h.result(timeout=600) for h in handles]
            dserved = [h.result(timeout=600) for h in dhandles]
        finally:
            svc.stop()
        svc.drain()
    finally:
        ColoringPlan.map = plan_map
    wall = time.perf_counter() - t0
    # the service marks each request its flush served through plan.map
    assert sum(r.batched for r in served) == sum(maps), \
        "the service's batched flags disagree with the plan.map calls"
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
    log(f"  {len(maps)} of {cum['flushes']} flushes went through the "
        f"batched program (plan.map), {sum(maps)} requests, batch sizes "
        f"{sorted(maps)}")

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


# --------------------------------------------------------------------------
# phase 11: the LM serving lane
# --------------------------------------------------------------------------
def _lm_batch(cfg, b, t, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(size=(
            b, cfg.vlm.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(
            b, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).cuda() for k, v in out.items()}


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


class _one_kv_chunk:
    """Within the block, ``flash_attention`` takes all keys in one chunk,
    so no zero-padded key exists."""

    def __enter__(self):
        from repro_torch.models import layers
        self.real = real = layers.flash_attention

        def one_chunk(q, k, v, **kw):
            kw["kv_chunk"] = max(k.shape[1], kw.get("kv_chunk", 1024))
            return real(q, k, v, **kw)
        layers.flash_attention = one_chunk
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.flash_attention = self.real


def _decode_vs_full(cfg, params):
    """Prefill 16 tokens in 2 rows, then 2 decode steps, each against the
    full forward: [(max abs err, max|full|)] per step."""
    import numpy as np
    import torch
    from repro_torch import models
    batch = _lm_batch(cfg, 2, 16)
    rng = np.random.default_rng(0)
    errs = []
    with torch.inference_mode():
        caches = models.init_cache(cfg, 2, 32, device="cuda")
        _, _, caches = models.forward(cfg, params, batch, caches=caches)
        assert caches["cur_len"].tolist() == [16, 16]
        toks = batch["tokens"]
        for _ in range(2):
            nt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2,)).astype(np.int32)).cuda()
            logits, caches = models.decode_step(cfg, params, caches, nt)
            toks = torch.cat([toks, nt[:, None]], dim=1)
            full = models.forward(cfg, params, dict(batch, tokens=toks))[0]
            assert torch.isfinite(logits).all() and \
                logits.shape == (2, cfg.vocab_size)
            errs.append((float((logits.float() - full[:, -1].float())
                               .abs().max()),
                         float(full[:, -1].float().abs().max())))
    torch.cuda.synchronize()
    return errs


def _errs_text(errs) -> str:
    return ", ".join(f"({e:.4g}, {r:.4g})" for e, r in errs)


def _held(errs) -> bool:
    return all(e < 0.05 * max(r, 10.0) for e, r in errs)


def phase_lm():
    """Phase 11 (see the docstring at the top). Returns the kernel launches
    of the phase (the lane has no kernel of its own)."""
    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as lm_serve

    _free_card()
    reset_launch_counts()
    t0 = time.perf_counter()
    # ---- the serving command at the full qwen3-4b config -----------------
    res = lm_serve.main(LM_SERVE)
    cfg = get_config("qwen3-4b")
    toks = res["tokens"]
    assert toks.shape == (8, 32) and toks.min() >= 0 \
        and toks.max() < cfg.vocab_size, toks.shape
    log(f"phase 11 serve qwen3-4b (full: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.param_count():,} params, fp32 weights, bf16 "
        f"compute; batch 8, prompt 64, gen 32): prefill "
        f"{res['prefill_s']:.4f} s ({res['prefill_tok_s']:.1f} tok/s), "
        f"decode {res['decode_s']:.4f} s ({res['decode_tok_s']:.2f} tok/s), "
        f"step p50 {res['step_p50_ms']:.3f} ms p99 {res['step_p99_ms']:.3f} "
        f"ms max {res['step_max_ms']:.3f} ms, max_memory_allocated "
        f"{res['peak_bytes']:,} B ({res['peak_bytes'] / 2**30:.2f} GiB)")
    del res
    _free_card()

    # ---- decode leaks nothing across batch rows (qwen3-4b, full) ---------
    gen = torch.Generator("cuda").manual_seed(0)
    params, _ = models.init_params(cfg, gen, device="cuda")
    batch = _lm_batch(cfg, 2, 8, seed=1)
    nt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2,)).astype(np.int32)).cuda()
    with torch.inference_mode():
        out = []
        for order in ((0, 1), (1, 0)):
            rows = list(order)
            caches = models.init_cache(cfg, 2, 16, device="cuda")
            _, _, caches = models.forward(
                cfg, params, {"tokens": batch["tokens"][rows]}, caches=caches)
            out.append(models.decode_step(cfg, params, caches, nt[rows])[0])
        iso = float((out[0].float() - out[1].flip(0).float()).abs().max())
    log(f"phase 11 qwen3-4b decode batch isolation: rows swapped, max abs "
        f"logit difference {iso:.3g}")
    assert iso <= 2e-2, f"decode leaks across batch rows: {iso}"

    # ---- prefill + 2 decode steps vs the full forward (qwen3-4b, full) ---
    errs = _decode_vs_full(cfg, params)
    log(f"phase 11 qwen3-4b (full size): prefill + 2 decode steps vs full "
        f"forward: (max abs err, max|ref|) {_errs_text(errs)}; bar "
        f"0.05*max(max|ref|, 10): " + ("held" if _held(errs) else "MISSED"))
    assert _held(errs), ("qwen3-4b", errs)

    # ---- where a decode step's time goes (batch 8, after a 64-token prefill)
    batch = _lm_batch(cfg, 8, 64)
    with torch.inference_mode():
        caches = models.init_cache(cfg, 8, 96, device="cuda")
        _, _, caches = models.forward(cfg, params, batch, caches=caches)
        tok = batch["tokens"][:, -1]
        state = {"caches": caches}

        def steps(n):
            for _ in range(n):
                logits, state["caches"] = models.decode_step(
                    cfg, params, state["caches"], tok)
            torch.cuda.synchronize()
        steps(1)
        t = time.perf_counter()
        steps(8)
        wall = (time.perf_counter() - t) / 8
        busy, rows = device_busy(lambda: steps(4))
    per_step = busy / 4 if busy is not None else None
    log(f"phase 11 qwen3-4b decode step (batch 8, warm): host wall "
        f"{1e3 * wall:.3f} ms; device busy "
        + ("not measured (the profiler reported no device time)"
           if per_step is None else
           f"{1e3 * per_step:.3f} ms ({100 * (1 - per_step / wall):.1f} % "
           f"idle)") + f" (profiled over 4 steps)")
    for name, calls, ms in rows[:8]:
        log(f"  device time: {ms / 4:9.3f} ms/step in {calls // 4:5d} "
            f"calls/step of {name[:70]}")
    del params, caches, out, state
    _free_card()

    # ---- every other arch: prefill + 2 decode steps vs the full forward ---
    import dataclasses
    for arch in LM_FULL + tuple(LM_CUT):
        t = time.perf_counter()
        cfg = get_config(arch)
        if arch in LM_CUT:
            cfg = dataclasses.replace(cfg, num_layers=LM_CUT[arch])
        if cfg.moe is not None:
            # capacity dropping is batch-context dependent, so the check
            # takes a capacity no expert can overflow: cf = E/k gives
            # T + 1 slots per row (the reference's test uses 8, which
            # still drops at deepseek's 64 experts, top 6)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        params, _ = models.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
        errs = _decode_vs_full(cfg, params)
        cut = (f"depth cut to {cfg.num_layers} of {get_config(arch).num_layers}"
               if arch in LM_CUT else "full size")
        note = ""
        if arch in LM_ONE_KV_CHUNK:
            note = (f"; as configured, where the full forward attends to "
                    f"zero-padded keys (ROADMAP C9, reported): "
                    f"{_errs_text(errs)}")
            with _one_kv_chunk():
                errs = _decode_vs_full(cfg, params)
            cut += ", one key chunk over all keys"
        ok = _held(errs)
        log(f"phase 11 {arch} ({cut}, {cfg.param_count():,} params): prefill "
            f"+ 2 decode steps vs full forward: (max abs err, max|ref|) "
            + _errs_text(errs)
            + f"; bar 0.05*max(max|ref|, 10): "
            + ("held" if ok else "MISSED")
            + ("" if arch not in LM_REPORTED else
               f" (reported, not asserted: {LM_REPORTED[arch]})")
            + note + f"; {time.perf_counter() - t:.1f} s")
        assert ok or arch in LM_REPORTED, (arch, errs)
        del params
        _free_card()
    counts = launch_counts()
    log(f"phase 11 launches: {counts} (the LM lane has no kernel of its own)")
    log(f"phase 11 lm: ok ({time.perf_counter() - t0:.1f} s)")
    return counts


# --------------------------------------------------------------------------
# phase 12: the LM training lane
# --------------------------------------------------------------------------
def _train_batch(cfg, b, t):
    """The data pipeline's step-0 batch of ``b`` x ``t`` (CPU tensors)."""
    import torch
    from repro_torch.models import ShapeConfig
    from repro_torch.train import data
    dcfg = data.data_config_for(cfg, ShapeConfig("smoke", t, b, "train"))
    return {k: torch.from_numpy(v) for k, v in data.batch_for_step(dcfg, 0).items()}


def _finite_step(m) -> bool:
    import math
    return (all(math.isfinite(float(m[k])) for k in ("loss", "grad_norm"))
            and int(m["skipped"]) == 0)


def _train_restore_replay(argv, losses):
    """(a): restore step 20 of the driver's run into a fresh ``build``,
    hold it to the file bit for bit, replay steps 20-39 on the same data
    stream against the driver's losses."""
    import torch
    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint
    args = lt.parse_args(argv)
    cfg, opt_cfg, ts_cfg, dcfg = lt.configs(args)
    params, opt_state, step_fn, _ = lt.build(cfg, opt_cfg, ts_cfg,
                                             device="cuda")
    opt_state, step = lt.restore_into(args.ckpt_dir, params, opt_state,
                                      step=TRAIN_RESTORE_STEP)
    saved, _, _ = checkpoint.load(args.ckpt_dir, step=TRAIN_RESTORE_STEP)
    pairs = [(params.get_parameter(n), saved["params"][n])
             for n in saved["params"]]
    pairs += [(opt_state[k][n], saved["opt"][k][n]) for k in ("m", "v")
              for n in saved["opt"][k]]
    pairs.append((opt_state["step"], saved["opt"]["step"]))
    for got, want in pairs:
        want = want if isinstance(want, torch.Tensor) else torch.from_numpy(want)
        got = got.detach().cpu()
        assert got.dtype == want.dtype and torch.equal(got, want)
    log(f"phase 12 restore step {step} into a fresh build: {len(pairs)} "
        f"tensors equal the saved ones bit for bit")
    replay = []
    for s in range(step, args.steps):
        _, _, m = step_fn(params, opt_state, lt.batch_on(dcfg, s, "cuda"))
        replay.append(float(m["loss"]))
    want = losses[step:]
    gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(replay, want))
    log(f"phase 12 replay steps {step}-{args.steps - 1}: max |loss - "
        f"main's| / max(1, |loss|) = {gap:.3g} (tolerance "
        f"{TRAIN_REPLAY_TOL}); {sum(a == b for a, b in zip(replay, want))} of "
        f"{len(want)} losses equal exactly; {replay[0]:.6f} .. {replay[-1]:.6f}")
    assert len(replay) == len(want) and gap <= TRAIN_REPLAY_TOL, (replay, want)


def _train_big():
    """(b): qwen3-4b at its full config, bf16 moments, remat: 5 steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as lt
    from repro_torch.models import ShapeConfig
    from repro_torch.train import AdamWConfig, TrainStepConfig, data
    arch, b, t, n = TRAIN_BIG
    cfg = get_config(arch)
    assert cfg.remat
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, step_fn, _ = lt.build(
        cfg, AdamWConfig(moment_dtype="bfloat16"), TrainStepConfig(),
        device="cuda")
    nparams = sum(p.numel() for p in params.parameters())
    dcfg = data.data_config_for(cfg, ShapeConfig("smoke", t, b, "train"))
    walls = []
    for s in range(n):
        batch = lt.batch_on(dcfg, s, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        log(f"phase 12 {arch} step {s}: loss {float(m['loss']):.6f} "
            f"grad_norm {float(m['grad_norm']):.6f} lr {float(m['lr']):.4g} "
            f"skipped {int(m['skipped'])}; wall {walls[-1]:.4f} s")
        assert _finite_step(m), (s, {k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(walls[1:])
    tokens = b * t
    flops = 6 * nparams * tokens
    batch = lt.batch_on(dcfg, n, "cuda")
    busy, rows = device_busy(lambda: step_fn(params, opt_state, batch))
    log(f"phase 12 {arch} (full: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {nparams:,} params; fp32 params, bf16 compute and "
        f"moments, remat; batch {b} x {t} = {tokens} tokens/step): warm step "
        f"p50 {p50:.4f} s over steps 1-{n - 1}, {tokens / p50:.1f} tokens/s; "
        f"model FLOPs share (6 x params x tokens = {flops:.4g} FLOP per step "
        f"against {BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s dense bf16) "
        f"{100 * flops / p50 / BF16_DENSE_FLOPS:.2f} %; max_memory_allocated "
        f"{peak:,} B ({peak / 2**30:.2f} GiB)")
    log(f"phase 12 {arch} profiled step {n}: device busy "
        + ("not measured (the profiler reported no device time)"
           if busy is None else
           f"{busy:.4f} s, {100 * busy / p50:.1f} % of the warm step p50"))
    for name, calls, ms in rows[:10]:
        log(f"  device time: {ms:9.3f} ms in {calls:5d} calls of {name[:70]}")


def _train_card_vs_cpu():
    """(c): qwen3-4b at full width cut to one layer, float32: one step on
    the card and one on CPU tensors, from the same weights and batch."""
    import copy
    import dataclasses
    import torch
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=1,
                              dtype="float32")
    cpu, _ = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = _train_batch(cfg, 1, 128)
    opt_cfg = AdamWConfig()
    out = {}
    for dev, module in (("cuda", card), ("cpu", cpu)):
        state = init_opt_state(module, opt_cfg)
        t0 = time.perf_counter()
        _, _, m = make_train_step(cfg, opt_cfg)(
            module, state, {k: v.to(dev) for k, v in batch.items()})
        float(m["loss"])
        out[dev] = (m, state, time.perf_counter() - t0)
    (mc, sc, tc), (mh, sh, th) = out["cuda"], out["cpu"]
    rel = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
           for k in ("loss", "grad_norm")}
    worst = 0.0
    for key in ("m", "v"):
        for name, want in sh[key].items():
            err = float((sc[key][name].cpu() - want).abs().max())
            bar = 1e-4 * max(1.0, float(want.abs().max()))
            assert err <= bar, (key, name, err, bar)
            worst = max(worst, err / bar)
    log(f"phase 12 qwen3-4b at full width cut to 1 layer, float32 ("
        f"{sum(p.numel() for p in cpu.parameters()):,} params; batch 1 x 128): "
        f"card vs CPU loss {float(mc['loss']):.7f} / {float(mh['loss']):.7f} "
        f"(rel {rel['loss']:.3g}, bar 1e-4), grad_norm "
        f"{float(mc['grad_norm']):.6f} / {float(mh['grad_norm']):.6f} (rel "
        f"{rel['grad_norm']:.3g}, bar 1e-3); m and v at worst {worst:.3g} of "
        f"their bar 1e-4*max(1, max|cpu|); one step {tc:.2f} s on the card "
        f"(first call), {th:.2f} s on the CPU")
    assert rel["loss"] <= 1e-4 and rel["grad_norm"] <= 1e-3, rel


def phase_train():
    """Phase 12 (see the docstring at the top). Returns the kernel launches
    of the phase (the lane has no kernel of its own)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as lt
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

    _free_card()
    reset_launch_counts()
    t0 = time.perf_counter()
    # ---- (a) the driver's default run, then restore + replay ------------
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    argv = TRAIN_MAIN + ["--ckpt-dir", root]
    t = time.perf_counter()
    losses = lt.main(argv)
    log(f"phase 12 launch.train main {' '.join(TRAIN_MAIN)}: {len(losses)} "
        f"steps in {time.perf_counter() - t:.1f} s (init and checkpoints "
        f"included); loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    assert losses[-1] < losses[0], losses
    _train_restore_replay(argv, losses)
    _free_card()
    # ---- (b) qwen3-4b at its full config ----------------------------------
    _train_big()
    _free_card()
    # ---- (c) the card against the CPU -------------------------------------
    _train_card_vs_cpu()
    _free_card()
    # ---- (d) every other arch: one step at phase 11's cuts ----------------
    for arch in LM_FULL + tuple(LM_CUT):
        if arch in TRAIN_SKIP:
            log(f"phase 12 {arch}: not run ({TRAIN_SKIP[arch]})")
            continue
        t = time.perf_counter()
        cfg = get_config(arch)
        if arch in LM_CUT:
            cfg = dataclasses.replace(cfg, num_layers=LM_CUT[arch])
        torch.cuda.reset_peak_memory_stats()
        params, _ = models.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
        opt_cfg = AdamWConfig()
        state = init_opt_state(params, opt_cfg)
        batch = {k: v.cuda() for k, v in _train_batch(cfg, 2, 128).items()}
        _, _, m = make_train_step(cfg, opt_cfg)(params, state, batch)
        cut = (f"depth cut to {cfg.num_layers} of {get_config(arch).num_layers}"
               if arch in LM_CUT else "full size")
        log(f"phase 12 {arch} ({cut}, {cfg.param_count():,} params, "
            f"{cfg.dtype} compute, fp32 moments; batch 2 x 128): loss "
            f"{float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f} "
            f"skipped {int(m['skipped'])}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated():,} B; "
            f"{time.perf_counter() - t:.1f} s")
        assert _finite_step(m), (arch, {k: float(v) for k, v in m.items()})
        del params, state
        _free_card()
    counts = launch_counts()
    log(f"phase 12 launches: {counts} (the training lane has no kernel of "
        f"its own)")
    log(f"phase 12 train: ok ({time.perf_counter() - t0:.1f} s)")
    return counts


# ---------------------------------------------------------------- phase 13
def _sharded_cfg(layers: int = SHARDED_LAYERS):
    """qwen3-4b at full width, depth cut, float32 compute (the bars of
    ``tests/test_torch_train.py`` are float32 bars)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SHARDED_ARCH), num_layers=layers,
                               dtype="float32")


class _StepBars:
    """``tests/test_torch_train.py``'s one-step bars between a state (got)
    and the state it must equal (want), both one step from the same state,
    fed leaf by leaf: loss and grad_norm within 1e-5·max(1, |want|); m and v
    within 1e-4·max(1, max|want|); the gradient read off m (g = m / (1 -
    b1)) within 1e-5·max(1, max|g_want|); params within 1e-6 where |g_want|
    clears that bar by 10, within 2·lr + 1e-6 elsewhere. ``gmax`` is
    max|g_want| over the whole state."""

    def __init__(self, got: dict, want: dict, gmax: float, b1: float = 0.9):
        for k in ("loss", "grad_norm"):
            err = abs(got[k] - want[k])
            assert err <= 1e-5 * max(1.0, abs(want[k])), (k, got[k], want[k])
        self.metrics = {k: abs(got[k] - want[k]) for k in ("loss", "grad_norm")}
        self.lr, self.b1 = want["lr"], b1
        self.gbar = 1e-5 * max(1.0, gmax)
        self.perr = self.mv = 0.0
        self.loose = self.total = self.leaves = 0

    def leaf(self, name, p, p_want, m, m_want, v, v_want):
        for a, b, what in ((m, m_want, "m"), (v, v_want, "v")):
            bar = 1e-4 * max(1.0, float(b.abs().max()))
            err = float((a - b).abs().max())
            assert err <= bar, (name, what, err, bar)
            self.mv = max(self.mv, err / bar)
        g, g_want = m / (1 - self.b1), m_want / (1 - self.b1)
        assert float((g - g_want).abs().max()) <= self.gbar, (name, "g")
        d = (p - p_want).abs()
        sure = g_want.abs() >= 10 * self.gbar
        if bool(sure.any()):
            self.perr = max(self.perr, float(d[sure].max()))
        assert self.perr <= 1e-6, (name, self.perr)
        assert float(d.max()) <= 2 * self.lr + 1e-6, (name, float(d.max()))
        self.loose += int((~sure).sum())
        self.total += d.numel()
        self.leaves += 1

    def text(self) -> str:
        return (f"loss diff {self.metrics['loss']:.3g}, grad_norm diff "
                f"{self.metrics['grad_norm']:.3g} (bar 1e-5 rel); m, v at "
                f"worst {self.mv:.3g} of their bar; params {self.perr:.3g} "
                f"where |g| clears the grad bar (bar 1e-6), "
                f"{self.loose:,} of {self.total:,} entries under 2*lr + 1e-6; "
                f"{self.leaves} leaves")


def _gmax(state, b1: float = 0.9) -> float:
    from repro_torch.parallel.sharding import whole
    return max(float(whole(m).abs().max()) for m in state["m"].values()) \
        / (1 - b1)


def _held_bytes(params, state) -> tuple:
    """(local bytes, whole bytes) of params plus moments on this rank."""
    from repro_torch.parallel.sharding import local
    loc = tot = 0
    for name, p in params.named_parameters():
        for t in (p, state["m"][name], state["v"][name]):
            loc += local(t).numel() * t.element_size()
            tot += t.numel() * t.element_size()
    return loc, tot


def _collectives(fn) -> dict:
    """What ``fn`` runs on this rank, counted by the dry run's counter
    (``launch.hlo_analysis.count_ops``: local ops, under DTensor):
    ``{"comm": {kind: [count, result bytes, bytes sent]}, "flops": local
    matmul FLOPs}``. Result bytes are the reference's convention (an
    all-gather counts the gathered tensor); bytes sent are each call's
    input, what earlier runs of this phase printed."""
    from repro_torch.launch.hlo_analysis import count_ops
    with count_ops() as st:
        fn()
    comm = {k: [n, int(st.collective_bytes_by_kind[k]),
                int(st.collective_sent_bytes_by_kind[k])]
            for k, n in sorted(st.collective_counts.items()) if n}
    return dict(comm=comm, flops=st.dot_flops)


def _peak_split(fn, inputs) -> dict:
    """Where the card's peak over one run of ``fn`` (a warm step) comes
    from, three runs of it: the allocator's peak, allocated (each block
    rounded up) and requested (the bytes asked for); the peak of the dry
    run's memory tracker on these real tensors (``inputs`` held from the
    start); and, op by op, the op during which the allocated peak falls and
    what it allocates inside itself beyond its result (a workspace, a
    temporary that no dispatched op returns), with the three largest such
    in-op transients of the run."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import dryrun as D
    cuda = torch.cuda
    cuda.synchronize()
    cuda.reset_peak_memory_stats()
    fn()
    cuda.synchronize()
    allocated = cuda.max_memory_allocated()
    requested = cuda.memory_stats().get("requested_bytes.all.peak")
    tracker = D._rank_mem_tracker()
    tracker.track_external(*[t for tree in inputs for t in D._leaves(tree)])
    with tracker:
        fn()
    tracked = sum(s.get("Total", 0) for s in
                  tracker.get_tracker_snapshot("peak").values())

    class InOp(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.top, self.inside = (0, "", 0, 0), []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            before = cuda.memory_allocated()
            cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            high, after = cuda.max_memory_allocated(), cuda.memory_allocated()
            inside = high - max(before, after)
            if high > self.top[0]:
                self.top = (high, str(func), before, inside)
            self.inside = sorted(self.inside + [(inside, str(func))],
                                 reverse=True)[:3]
            return out

    with InOp() as ops:
        fn()
    high, op, before, inside = ops.top
    return dict(allocated=allocated, requested=requested, tracked=tracked,
                op_peak=high, peak_op=op, before_op=before, inside_op=inside,
                largest_inside=ops.inside)


def sharded_card_rank(pmesh) -> dict:
    """Phase 13 (b) on the card: one rank, a 1 x 1 NCCL mesh. The sharded
    step (``build(mesh=)``) against the one-device ``build`` from the same
    seed on the same batch, then its warm steps and collectives."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShapeConfig
    from repro_torch.parallel.sharding import whole
    from repro_torch.train import AdamWConfig, TrainStepConfig, data
    reset_launch_counts()
    cfg = _sharded_cfg()
    b, t, n = SHARDED_CARD
    opt_cfg, ts_cfg = AdamWConfig(), TrainStepConfig()
    mesh = make_mesh((1, 1), ("data", "model"), pmesh.device)
    dcfg = data.data_config_for(cfg, ShapeConfig("smoke", t, b, "train"))
    params, state, step, _ = lt.build(cfg, opt_cfg, ts_cfg, device="cuda",
                                      mesh=mesh)
    nparams = sum(p.numel() for p in params.parameters())
    m0 = step(params, state, lt.batch_on(dcfg, 0, "cuda"))[2]
    got = {k: float(v) for k, v in m0.items()}
    snap = {name: (whole(p).detach().clone(), whole(state["m"][name]).clone(),
                   whole(state["v"][name]).clone())
            for name, p in params.named_parameters()}
    p1, s1, f1, _ = lt.build(cfg, opt_cfg, ts_cfg, device="cuda")
    # the metrics only: a name left bound to the one-device state would
    # keep its moments (two fp32 copies of the params) into the warm steps
    m1 = f1(p1, s1, lt.batch_on(dcfg, 0, "cuda"))[2]
    want = {k: float(v) for k, v in m1.items()}
    bars = _StepBars(got, want, _gmax(s1))
    for name, q in p1.named_parameters():
        bars.leaf(name, snap[name][0], q.detach(), snap[name][1], s1["m"][name],
                  snap[name][2], s1["v"][name])
    del snap, p1, s1, f1
    torch.cuda.empty_cache()
    walls, losses, steps_mem = [], [got["loss"]], []
    for s in range(1, n):
        batch = lt.batch_on(dcfg, s, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        # (allocated before the step, the step's peak)
        steps_mem.append((before, torch.cuda.max_memory_allocated()))
    peak = max(high for _, high in steps_mem)
    counted = _collectives(lambda: step(params, state,
                                        lt.batch_on(dcfg, n, "cuda")))
    loc, tot = _held_bytes(params, state)
    split = _peak_split(lambda: step(params, state,
                                     lt.batch_on(dcfg, n + 1, "cuda")),
                        (params, state))
    return dict(rank=pmesh.rank, backend=pmesh.backend, nparams=nparams,
                bars=bars.text(), losses=losses, walls=walls,
                p50=statistics.median(walls), peak=peak, local=loc,
                whole=tot, comm=counted["comm"], flops=counted["flops"],
                split=split, steps_mem=steps_mem, tokens=b * t,
                mesh=str(tuple(mesh.shape)), launches=launch_counts())


def _hold(got, want, names, rank: int) -> str:
    """The step bars between two states, checked on rank 0. ``got`` and
    ``want`` are ``(metrics, params module, opt state)``: of a mesh run
    (every rank passes its own, and each leaf is gathered) or of a run on
    rank 0 alone (the other ranks pass ``None``). ``names`` fixes the leaf
    order every rank follows."""
    from repro_torch.parallel.sharding import whole

    def host(x):
        return whole(x.detach()).cpu()
    gmax = _gmax(want[2]) if want is not None else None
    bars = _StepBars(got[0], want[0], gmax) if rank == 0 else None
    for name in names:
        sides = []
        for side in (got, want):
            if side is None:
                sides.append((None,) * 3)
                continue
            p = side[1].get_parameter(name)
            sides.append((host(p), host(side[2]["m"][name]),
                          host(side[2]["v"][name])))
        if bars is not None:
            (p, m, v), (pw, mw, vw) = sides
            bars.leaf(name, p, pw, m, mw, v, vw)
    return bars.text() if bars is not None else ""


def _say(rank: int, text: str):
    """A rank's progress line (in its log under ``build/``)."""
    print(f"[rank {rank} {time.strftime('%H:%M:%S')}] {text}", flush=True)


def _shard_of(t, whole_t):
    """The block of ``whole_t`` (the one-device tensor) that DTensor ``t``'s
    local shard holds: each tensor dim split by at most one mesh dim, in
    equal parts (``spec_for_array`` keeps only splits that divide)."""
    idx = [slice(None)] * t.ndim
    coord = t.device_mesh.get_coordinate()
    for mdim, p in enumerate(t.placements):
        if p.is_shard():
            n = t.shape[p.dim] // t.device_mesh.size(mdim)
            idx[p.dim] = slice(coord[mdim] * n, (coord[mdim] + 1) * n)
    return whole_t[tuple(idx)]


def _hold_shards(got, want, names) -> dict:
    """The step bars between a mesh run (``got``: metrics, params, state,
    DTensor leaves) and a one-device run on the card (``want``), each
    rank checking its own shards against the same block of the card's
    tensors: nothing is gathered."""
    bars = _StepBars(got[0], want[0], _gmax(want[2]))
    for name in names:
        pw = want[1].get_parameter(name).detach()
        sides = [(side[1].get_parameter(name).detach(), side[2]["m"][name],
                  side[2]["v"][name]) for side in (got, want)]
        (p, m, v), (pw, mw, vw) = sides
        bars.leaf(name, p.to_local().to(pw.device), _shard_of(p, pw),
                  m.to_local().to(pw.device), _shard_of(m, mw),
                  v.to_local().to(pw.device), _shard_of(v, vw))
    return dict(text=bars.text(), perr=bars.perr, mv=bars.mv,
                loose=bars.loose, total=bars.total)


def _mesh_step_hold(mesh, arch: str, batch: tuple,
                    microbatches: int = 1) -> dict:
    """``arch`` (smoke config) takes one float32 step on ``mesh`` (2 x 2,
    CPU ranks) with ``microbatches``. This rank's shards are held, under
    the step bars, against the same blocks of the one-device step computed
    in float64 from the same seed-0 weights on the same batch (the step's
    exact value: the mesh's float32 step and the one-device float32 step
    each differ from it by reduction order, and from each other by up to
    the sum). The one-device float32 step's grad_norm is reported beside
    it. (e) ROADMAP C11: mamba2-130m's gated norm's backward raised on the
    2 x 2 mesh under torch 2.11 before it was given whole rows. (f) ROADMAP
    C13: a microbatch of fewer rows than its data ranks was refused before
    it was replicated on them."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as lt
    from repro_torch.models import ShapeConfig
    from repro_torch.train import AdamWConfig, TrainStepConfig, data
    b, t = batch
    opt_cfg = AdamWConfig()
    ts_cfg = TrainStepConfig(microbatches=microbatches)
    steps = {}
    for dt in ("float32", "float64"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
        dcfg = data.data_config_for(cfg, ShapeConfig("smoke", t, b, "train"))
        params, state, step, _ = lt.build(cfg, opt_cfg, ts_cfg, device="cpu",
                                          mesh=mesh if dt == "float32"
                                          else None)
        metrics = {k: float(v) for k, v in
                   step(params, state, lt.batch_on(dcfg, 0, "cpu"))[2].items()}
        steps[dt] = (metrics, params, state)
        if dt == "float32":
            one, s1, f1, _ = lt.build(cfg, opt_cfg, ts_cfg, device="cpu")
            gn32 = float(f1(one, s1, lt.batch_on(dcfg, 0, "cpu"))[2]
                         ["grad_norm"])
    names = [n for n, _ in steps["float32"][1].named_parameters()]
    held = _hold_shards(steps["float32"], steps["float64"], names)
    return dict(held, grad_norm=(steps["float32"][0]["grad_norm"], gn32,
                                 steps["float64"][0]["grad_norm"]))


def sharded_cpu_rank(pmesh, root: str) -> dict:
    """Phase 13 on four CPU ranks (the route: see ``SHARDED_ROUTE``).
    (b) the 2 x 2 step at full width, its collectives counted, against the
    one-device step on the card from the same weights (each rank draws
    them on the card, keeps that twin there and checks its own shards
    against it); (c) a 2 x 2 run at the smoke config checkpointed after
    its first step and restored onto (4, 1) and onto the card, each next
    step against the 2 x 2 run's."""
    import copy
    import torch
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShapeConfig
    from repro_torch.train import (AdamWConfig, TrainStepConfig, checkpoint,
                                   data, init_opt_state, make_train_step)
    reset_launch_counts()
    rank = pmesh.rank
    opt_cfg, ts_cfg = AdamWConfig(), TrainStepConfig()
    m22 = make_mesh((2, 2), ("data", "model"), "cpu")
    m41 = make_mesh((4, 1), ("data", "model"), "cpu")
    out = dict(rank=rank, backend=pmesh.backend)
    b, t = SHARDED_CPU

    def metrics(m):
        return {k: float(v) for k, v in m.items()}

    # ---- (b) full width --------------------------------------------------
    cfg = _sharded_cfg()
    dcfg = data.data_config_for(cfg, ShapeConfig("smoke", t, b, "train"))
    t0 = time.perf_counter()
    twin, axes = models.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                    device="cuda")
    params, state, step = lt.shard_for_mesh(
        cfg, copy.deepcopy(twin).to("cpu"), axes, opt_cfg, ts_cfg, m22)
    out["build_s"] = time.perf_counter() - t0
    _say(rank, f"(b) built in {out['build_s']:.1f} s")
    names = [n for n, _ in params.named_parameters()]
    t0 = time.perf_counter()
    out["comm"] = _collectives(lambda: out.__setitem__("m0", metrics(step(
        params, state, lt.batch_on(dcfg, 0, "cpu"))[2])))["comm"]
    out["step0_s"] = time.perf_counter() - t0
    _say(rank, f"(b) step 0 in {out['step0_s']:.1f} s")
    # the ranks take the card's one-device step in turn: four at once do
    # not fit its memory
    t0 = time.perf_counter()
    for turn in range(pmesh.num_devices):
        if turn == rank:
            twin_state = init_opt_state(twin, opt_cfg)
            want = metrics(make_train_step(cfg, opt_cfg, ts_cfg)(
                twin, twin_state, lt.batch_on(dcfg, 0, "cuda"))[2])
            out["bars_card"] = _hold_shards((out["m0"], params, state),
                                            (want, twin, twin_state), names)
            del twin, twin_state
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    _say(rank, f"(b) held against the card in {time.perf_counter() - t0:.1f} s")
    out["local"], out["whole"] = _held_bytes(params, state)
    del params, state, step
    # ---- (c) elastic restart, at the smoke config ------------------------
    cfg = dataclasses.replace(get_smoke_config(SHARDED_ARCH), dtype="float32")
    dcfg = data.data_config_for(cfg, ShapeConfig("smoke", t, b, "train"))
    params, state, step, _ = lt.build(cfg, opt_cfg, ts_cfg, device="cpu",
                                      mesh=m22)
    names = [n for n, _ in params.named_parameters()]
    step(params, state, lt.batch_on(dcfg, 0, "cpu"))
    ck = os.path.join(root, "ck")
    checkpoint.save(ck, 1, lt.state_tree(params, state))
    torch.distributed.barrier()
    mine = (metrics(step(params, state, lt.batch_on(dcfg, 1, "cpu"))[2]),
            params, state)
    shell, axes = models.init_params(cfg, device="meta")
    p41, s41, f41 = lt.shard_for_mesh(cfg, shell.to_empty(device="cpu"),
                                      axes, opt_cfg, ts_cfg, m41)
    s41, out["restored_at"] = lt.restore_into(ck, p41, s41, mesh=m41)
    got = (metrics(f41(p41, s41, lt.batch_on(dcfg, 1, "cpu"))[2]), p41, s41)
    out["bars_4x1"] = _hold(got, mine, names, rank)
    card = None
    if rank == 0:
        one = models.init_params(cfg, device="meta")[0].to_empty(device="cuda")
        card = [None, one, init_opt_state(one, opt_cfg)]
        card[2], _ = lt.restore_into(ck, card[1], card[2])
        card[0] = metrics(make_train_step(cfg, opt_cfg, ts_cfg)(
            card[1], card[2], lt.batch_on(dcfg, 1, "cuda"))[2])
    out["bars_card_restart"] = _hold(card, mine, names, rank)
    _say(rank, "(c) held")
    out["restart_params"] = sum(p.numel() for p in params.parameters())
    # ---- (e) ROADMAP C11: mamba2's 2 x 2 step under this torch -----------
    out["c11"] = _mesh_step_hold(m22, "mamba2-130m", C11_BATCH)
    _say(rank, "(e) held")
    # ---- (f) ROADMAP C13: one row per microbatch over 2 data ranks -------
    out["c13"] = _mesh_step_hold(m22, SHARDED_ARCH, C13_BATCH,
                                 microbatches=C13_BATCH[0])
    _say(rank, "(f) held")
    out["launches"] = launch_counts()
    return out


def phase_sharded(card: str):
    """Phase 13 (see the docstring at the top). Returns the kernel
    launches of the phase, summed over its five ranks, each of which
    counts its own from 0 (the lane has no kernel of its own)."""
    import shutil
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import run_ranks
    _free_card()
    t0 = time.perf_counter()
    tag = f"phase 13 [{card}]"
    log(f"phase 13 route: {SHARDED_ROUTE}")
    cfg = _sharded_cfg()
    # ---- (b) the 1 x 1 NCCL mesh on the card ------------------------------
    one = run_ranks("chip_smoke:sharded_card_rank", 1, backend="nccl",
                    device="cuda", timeout=SHARDED_TIMEOUT_S)[0]
    b, t, n = SHARDED_CARD
    log(f"{tag} {SHARDED_ARCH} at full width cut to {cfg.num_layers} layers "
        f"({one['nparams']:,} params, float32), batch {b} x {t}, on a 1 x 1 "
        f"NCCL mesh on the card: step 0 against the one-device build: "
        f"{one['bars']}")
    log(f"{tag} 1 x 1 rank 0: params + moments {one['local']:,} B held of "
        f"{one['whole']:,} B; losses "
        f"{', '.join(f'{x:.6f}' for x in one['losses'])}"
        f"; warm step p50 {one['p50']:.4f} s over steps 1-{n - 1} "
        f"({one['tokens'] / one['p50']:.1f} tokens/s); max_memory_allocated "
        f"{one['peak']:,} B over the warm steps (allocated before each, its "
        f"peak: {one['steps_mem']}); collectives of one step "
        f"{one['comm'] or 'none'}; local matmul FLOPs of one step "
        f"{one['flops']:.6e}")
    # ---- (b, c) the 2 x 2 mesh on four CPU ranks --------------------------
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "sharded")
    shutil.rmtree(root, ignore_errors=True)
    ranks = run_ranks("chip_smoke:sharded_cpu_rank", 4, dict(root=root),
                      backend="gloo", device="cpu", workdir=root,
                      timeout=SHARDED_TIMEOUT_S)
    b, t = SHARDED_CPU
    r0 = ranks[0]
    worst = max(ranks, key=lambda r: r["bars_card"]["perr"])
    log(f"{tag} {SHARDED_ARCH} (same cut) on a 2 x 2 (data, model) mesh of "
        f"four CPU ranks, batch {b} x {t}: step 0 against the one-device "
        f"step on the card from the same weights, each rank's shards "
        f"against the same blocks on the card; rank {worst['rank']}, the "
        f"largest param error: {worst['bars_card']['text']}; m and v over "
        f"all four ranks at worst "
        f"{max(r['bars_card']['mv'] for r in ranks):.3g} of their bar")
    for r in ranks:
        log(f"{tag} 2 x 2 CPU rank {r['rank']}: params + moments "
            f"{r['local']:,} B held of {r['whole']:,} B "
            f"({100 * r['local'] / r['whole']:.1f} %); build {r['build_s']:.1f}"
            f" s; step 0 {r['step0_s']:.1f} s (cold, collectives counted); "
            f"max_memory_allocated not measured (a CPU rank; its host peak "
            f"is not measured either); collectives of step 0 (kind: count, "
            f"result bytes (the reference's convention), bytes sent) "
            f"{r['comm']}")
    log(f"{tag} (c) a 2 x 2 run of {SHARDED_ARCH} at the smoke config "
        f"({r0['restart_params']:,} params; at full width its 11.76 GB "
        f"checkpoint costs the CPU ranks more than the phase's time) "
        f"checkpointed after step 0, restored onto (4, 1) with "
        f"restore(shardings=) (step {r0['restored_at']}), its next step "
        f"against the 2 x 2 run's: {r0['bars_4x1']}")
    log(f"{tag} (c) the same checkpoint restored onto the card (one device), "
        f"its next step against the 2 x 2 run's: {r0['bars_card_restart']}")
    assert all(r["m0"] == r0["m0"] for r in ranks)
    for r in ranks:
        assert r["local"] * 3 < r["whole"], r    # held sharded at rest
    worst = max(ranks, key=lambda r: r["c11"]["perr"])
    gn = r0["c11"]["grad_norm"]
    log(f"{tag} (e) C11: mamba2-130m (smoke config, batch {C11_BATCH[0]} x "
        f"{C11_BATCH[1]}) takes its float32 step on the 2 x 2 mesh under "
        f"torch {torch_version()}; each rank's shards against the one-device "
        f"step in float64 from the same weights, rank {worst['rank']}: "
        f"{worst['c11']['text']}; m and v over all four ranks at worst "
        f"{max(r['c11']['mv'] for r in ranks):.3g} of their bar; grad_norm "
        f"2 x 2 {gn[0]!r}, one device float32 {gn[1]!r}, float64 {gn[2]!r}")
    worst = max(ranks, key=lambda r: r["c13"]["perr"])
    gn = r0["c13"]["grad_norm"]
    log(f"{tag} (f) C13: {SHARDED_ARCH} (smoke config, batch {C13_BATCH[0]} "
        f"x {C13_BATCH[1]}, {C13_BATCH[0]} microbatches: one row each over "
        f"the 2 data ranks, replicated on them) takes its float32 step on "
        f"the 2 x 2 mesh; each rank's shards against the one-device "
        f"microbatched step in float64 from the same weights, rank "
        f"{worst['rank']}: {worst['c13']['text']}; m and v over all four "
        f"ranks at worst {max(r['c13']['mv'] for r in ranks):.3g} of their "
        f"bar; grad_norm 2 x 2 {gn[0]!r}, one device float32 {gn[1]!r}, "
        f"float64 {gn[2]!r}")
    log(f"phase 13 {SHARDED_MOE_SKIP}")
    counts = {k.name: sum(x["launches"][k.name] for x in [one, *ranks])
              for k in KERNELS}
    log(f"phase 13 launches, summed over the 1 x 1 rank and the four CPU "
        f"ranks: {counts} (the sharded trainer has no kernel of its own)")
    log(f"phase 13 train-sharded: ok ({time.perf_counter() - t0:.1f} s)")
    measured = dict(cpu_comm=r0["comm"], cpu_held=r0["local"],
                    card_held=one["local"], card_flops=one["flops"],
                    card_peak=one["peak"], card_split=one["split"])
    return counts, measured


# ---------------------------------------------------------------- phase 14
def dryrun_worker(job: str) -> None:
    """One phase-14 worker (``python3 -c``, one process): the dry run's
    cells named in ``job`` (a JSON file), or a calibration cell of phase
    13's; writes its records and its kernel launches beside ``job``."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShapeConfig
    with open(job) as f:
        spec = json.load(f)
    reset_launch_counts()
    out = {"records": []}
    if spec["kind"] == "cells":
        for arch, shape, multi_pod in spec["cells"]:
            t0 = time.perf_counter()
            rec = D.run_cell(arch, shape, multi_pod, spec["out"],
                             microbatches=D.MICROBATCH_DEFAULTS.get(arch, 1),
                             device="cuda")
            rec["wall_seconds"] = time.perf_counter() - t0
            out["records"].append(rec)
    else:
        # phase 13's cells: the 2 x 2 mesh of CPU ranks (batch 2 x 32) and
        # the 1 x 1 NCCL mesh on the card (batch 4 x 512)
        on_card = spec["kind"] == "card"
        b, t = SHARDED_CARD[:2] if on_card else SHARDED_CPU
        shape = (1, 1) if on_card else (2, 2)
        dev = "cuda" if on_card else "cpu"
        with D.fake_world(math.prod(shape)):
            mesh = make_mesh(shape, ("data", "model"), dev)
            trace = D.trace_cell(SHARDED_ARCH, "train", mesh, device=dev,
                                 cfg=_sharded_cfg(),
                                 shape=ShapeConfig("train", t, b, "train"))
            out["records"].append(D.analyse(trace, mesh, SHARDED_ARCH,
                                            f"phase13_{spec['kind']}"))
    out["launches"] = launch_counts()
    with open(job + ".out", "w") as f:
        json.dump(out, f)


def dryrun_workers() -> list:
    """Phase 14's workers, side by side (``DRYRUN_WORKERS``, then phase
    13's two cells); returns their results in that order. A worker that
    fails or outlives ``DRYRUN_TIMEOUT_S`` fails the phase with its log's
    tail."""
    import shutil
    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "dryrun")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    jobs = [dict(kind="cells", cells=c, out=os.path.join(root, "records"))
            for c in DRYRUN_WORKERS]
    jobs += [dict(kind="cpu"), dict(kind="card")]
    procs = []
    here = os.path.dirname(os.path.abspath(__file__))
    for i, job in enumerate(jobs):
        path = os.path.join(root, f"job{i}.json")
        with open(path, "w") as f:
            json.dump(job, f)
        log_f = open(path + ".log", "w")
        procs.append((path, log_f, subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke, sys; "
             "chip_smoke.dryrun_worker(sys.argv[1])", path],
            cwd=here, stdout=log_f, stderr=subprocess.STDOUT)))
    results, failed = [], []
    try:
        for job, (path, log_f, proc) in zip(jobs, procs):
            try:
                rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                           - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = f"timeout after {DRYRUN_TIMEOUT_S} s"
            log_f.close()
            if rc != 0:
                with open(path + ".log") as f:
                    failed.append(f"{path} ({job}) ended {rc}:\n"
                                  f"{f.read()[-3000:]}")
                continue
            with open(path + ".out") as f:
                results.append(json.load(f))
    finally:
        for _, log_f, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
    assert not failed, "phase 14 workers failed:\n" + "\n".join(failed)
    return results


def _comm_of(rec) -> dict:
    """A record's collectives as phase 13 prints them: ``{kind: [count,
    result bytes, bytes sent]}``, the kinds it issued."""
    pd = rec["per_device"]
    sent = pd.get("collective_sent_by_kind")   # none for the coloring cell
    return {k: [n, int(pd["collective_by_kind"][k]),
                int(sent[k]) if sent else None]
            for k, n in sorted(pd["collective_counts"].items()) if n}


def phase_dryrun(card: str, sharded: dict):
    """Phase 14 (see the docstring at the top). Returns the kernel launches
    of the phase, summed over its workers (none: the dry run runs no
    kernel)."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    tag = f"phase 14 [{card}]"
    results = dryrun_workers()
    gb = 1e9
    for res in results[:len(DRYRUN_WORKERS)]:
        for rec in res["records"]:
            ma, pd, rf = rec["memory_analysis"], rec["per_device"], \
                rec["roofline"]
            log(f"{tag} (a) {rec['arch']} x {rec['shape']} on "
                f"{tuple(rec['mesh'])} ({rec['devices']} fake ranks, "
                f"{rec['device_type']}): trace {rec['trace_seconds']:.1f} s "
                f"(cell {rec['wall_seconds']:.1f} s); per rank: arguments "
                f"{ma['argument_size_in_bytes'] / gb:.3f} GB, peak "
                f"{ma['peak_memory_in_bytes'] / gb:.3f} GB of 80 GB, "
                f"calibrated {ma['calibrated_peak_in_bytes'] / gb:.3f} GB "
                f"({rec['fit']}); FLOPs "
                f"{pd['flops']:.4e}; collectives {_comm_of(rec) or 'none'}; "
                f"dominant {rf['dominant']} ({rf['bound_s']:.4g} s), "
                f"roofline fraction {rec.get('roofline_fraction', 0):.4f}")
    cpu = results[len(DRYRUN_WORKERS)]["records"][0]
    card_rec = results[len(DRYRUN_WORKERS) + 1]["records"][0]
    # ---- (b) calibration against phase 13's measurements in this run ------
    got_comm = _comm_of(cpu)
    log(f"{tag} (b) phase 13's 2 x 2 cell ({SHARDED_ARCH}, "
        f"{SHARDED_LAYERS} layers, float32, batch {SHARDED_CPU[0]} x "
        f"{SHARDED_CPU[1]}, CPU mesh) dry-run: rank 0 collectives "
        f"(kind: count, result bytes, bytes sent) {got_comm}, held "
        f"{cpu['memory_analysis']['held_bytes']:,} B; phase 13 measured "
        f"{sharded['cpu_comm']}, held {sharded['cpu_held']:,} B")
    assert got_comm == sharded["cpu_comm"], (got_comm, sharded["cpu_comm"])
    assert cpu["memory_analysis"]["held_bytes"] == sharded["cpu_held"]
    ma = card_rec["memory_analysis"]
    peak, measured = ma["peak_memory_in_bytes"], sharded["card_peak"]
    log(f"{tag} (b) phase 13's 1 x 1 card cell (batch {SHARDED_CARD[0]} x "
        f"{SHARDED_CARD[1]}) dry-run: held {ma['held_bytes']:,} B "
        f"(phase 13: {sharded['card_held']:,} B), local matmul FLOPs "
        f"{card_rec['per_device']['flops']:.6e} (count_ops around the real "
        f"step on the card: {sharded['card_flops']:.6e}); predicted peak "
        f"{peak:,} B beside the measured max_memory_allocated "
        f"{measured:,} B (gap {peak - measured:+,} B, "
        f"{100 * (peak - measured) / measured:+.1f} %)")
    assert ma["held_bytes"] == sharded["card_held"]
    assert card_rec["per_device"]["flops"] == sharded["card_flops"]
    sp = sharded["card_split"]
    log(f"{tag} (b) the card's peak over the traced one, one more warm step "
        f"(_peak_split): allocated {sp['allocated']:,} B, requested "
        f"{sp['requested']:,} B (allocator rounding "
        f"{sp['allocated'] - sp['requested']:+,} B); the dry run's tracker on "
        f"the real tensors {sp['tracked']:,} B (traced on fake tensors "
        f"{peak:,} B: {sp['tracked'] - peak:+,} B), so "
        f"{sp['requested'] - sp['tracked']:+,} B are asked for inside ops "
        f"the tracker cannot see; the peak falls in {sp['peak_op']} "
        f"({sp['before_op']:,} B allocated before it, {sp['inside_op']:,} B "
        f"inside it); the largest in-op allocations of the step "
        f"{sp['largest_inside']}; calibrated peak (x {D.PEAK_CALIBRATION:.6f}) "
        f"{ma['calibrated_peak_in_bytes']:,} B ({card_rec['fit']})")
    assert abs(sp["tracked"] - peak) <= 0.01 * peak, (sp["tracked"], peak)
    counts = {k.name: sum(r["launches"][k.name] for r in results)
              for k in KERNELS}
    log(f"phase 14 launches, summed over its {len(results)} workers: "
        f"{counts} (the dry run runs no kernel)")
    log(f"phase 14 dryrun: ok ({time.perf_counter() - t0:.1f} s)")
    return counts


# --------------------------------------------------------------------------
# phase 15: batched plan.map
# --------------------------------------------------------------------------
def union_graph(gs):
    """The block-diagonal union of same-size host graphs as one host Graph:
    its ELL slab is the [B*V, D] slab the batched sweep hands the kernels."""
    import numpy as np
    from repro_torch.core import Graph
    V = gs[0].num_vertices
    ptrs = [gs[0].row_ptr]
    for g in gs[1:]:
        ptrs.append(g.row_ptr[1:] + ptrs[-1][-1])
    cols = [g.col_idx + np.int32(b * V) for b, g in enumerate(gs)]
    return Graph(V * len(gs), np.concatenate(ptrs), np.concatenate(cols))


def phase_batched(errors):
    """Phase 15: ``plan.map``'s batched program against the per-graph loop
    on the service's max_batch of graphs. Returns the map runs' launches."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from repro_torch.core import (ColoringSpec, PlanShape, compile_plan,
                                  greedy_color, pad_bucket, rmat,
                                  validate_coloring)
    from repro_torch.core.engine import num_color_words
    from repro_torch.kernels import (conflict_mask, conflict_mask_plain,
                                     launch_counts, reset_launch_counts)

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, launch_counts()

    def generate(family, scale):
        # R-MAT in threads: each call seeds its own generator, and numpy
        # releases the GIL in the bulk draws and the sort
        with ThreadPoolExecutor(BATCH_GRAPHS) as ex:
            return list(ex.map(lambda s: rmat.paper_graph(family, scale,
                                                          seed=s),
                               range(BATCH_GRAPHS)))

    t = time.perf_counter()
    gs = generate("RMAT-ER", SCALE_BATCH)
    shape = PlanShape(
        num_vertices=gs[0].num_vertices,
        padded_edges=pad_bucket(max(g.num_directed_edges for g in gs)),
        max_degree=max(g.max_degree() for g in gs))
    words = num_color_words(shape.max_degree + 1)
    log(f"phase 15 host: {BATCH_GRAPHS} RMAT-ER scale-{SCALE_BATCH} graphs "
        f"in {time.perf_counter() - t:.1f} s; plan shape {shape}, W={words}; "
        f"union {BATCH_GRAPHS * shape.num_vertices} vertices, "
        f"{BATCH_GRAPHS * shape.padded_edges} edge slots")
    map_total = {}
    mapped = None
    for engine in ("fused_pallas", "ell_pallas"):
        plan = compile_plan(ColoringSpec(strategy="iterative", engine=engine,
                                         concurrency=CONCURRENCY),
                            shape, device="cuda")
        loop, loop_wall, loop_counts = counted(lambda: [plan(g) for g in gs])
        reps, map_wall, map_counts = counted(lambda: plan.map(gs))
        assert plan.traces == 2, f"plan.traces={plan.traces}"
        for b, (g, one, many) in enumerate(zip(gs, loop, reps)):
            assert validate_coloring(g, many.colors), f"{engine} graph {b}"
            assert same_report(many, one), \
                f"{engine}: map differs from plan(g) on graph {b}"
        if mapped is not None:
            for b, (a, c) in enumerate(zip(mapped, reps)):
                assert same_report(a, c), f"ell_pallas map differs, {b}"
        mapped = reps
        log(f"phase 15 {engine}: map == loop on all {BATCH_GRAPHS} graphs "
            f"(colors, rounds, conflicts, sweeps, frontier); rounds "
            f"{[r.rounds for r in reps]}, sweeps {[r.sweeps for r in reps]}")
        for name in loop_counts:
            log(f"  {name}: map {map_counts[name]} launches, loop "
                f"{loop_counts[name]}")
            assert map_counts[name] <= loop_counts[name], \
                f"{engine}: map launched {name} more often than the loop"
            map_total[name] = map_total.get(name, 0) + map_counts[name]
        used = ("round_fused" if engine == "fused_pallas" else "firstfit",
                "conflict_mask")
        for name in used:
            assert map_counts[name] > 0, f"{engine}: map never ran {name}"
        if engine == "fused_pallas":
            busy_loop, _ = device_busy(lambda: [plan(g) for g in gs])
            busy_map, rows = device_busy(lambda: plan.map(gs))
            log(f"phase 15 {engine} wall: loop {loop_wall:.3f} s, map "
                f"{map_wall:.3f} s; device busy: loop "
                f"{busy_text(busy_loop, loop_wall)}, map "
                f"{busy_text(busy_map, map_wall)}")
            for name, calls, ms in rows[:8]:
                log(f"  map device time: {ms:9.3f} ms in {calls:5d} calls of "
                    f"{name[:70]}")
        else:
            log(f"phase 15 {engine} wall: loop {loop_wall:.3f} s, map "
                f"{map_wall:.3f} s")

    # phase 2 at the batched shapes: the union slab from the map's colors
    t = time.perf_counter()
    union = union_graph(gs)
    colors = np.concatenate([r.colors for r in mapped])
    check_real_slab("batched union", union, colors, words, errors)
    dg = union.to_device(device="cuda")
    cpad = torch.cat([torch.from_numpy(colors % 4).to("cuda"),
                      torch.zeros(1, dtype=torch.int32, device="cuda")])
    cs, cd = cpad[torch.clamp(dg.src, max=union.num_vertices)], \
        cpad[torch.clamp(dg.dst, max=union.num_vertices)]
    got = conflict_mask(cs, cd, dg.src, dg.dst)
    want = conflict_mask_plain(cs, cd, dg.src, dg.dst)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    errors["conflict_mask"] = max(errors["conflict_mask"], err)
    log(f"phase 2 conflict_mask [batched union, colors mod 4] "
        f"shape={tuple(got.shape)} max_abs_err={err}")
    assert err == 0, "conflict_mask disagrees on the batched union"
    log(f"phase 15 kernels vs plain on the batched union: ok (exact; "
        f"{time.perf_counter() - t:.1f} s)")

    # DATAFLOW on the batch: each graph sweeps to its own depth
    gg = generate("RMAT-G", SCALE_BATCH_DATAFLOW)
    plan = compile_plan(ColoringSpec(strategy="dataflow",
                                     engine="fused_pallas"),
                        PlanShape(gg[0].num_vertices,
                                  pad_bucket(max(g.num_directed_edges
                                                 for g in gg)),
                                  max(g.max_degree() for g in gg)),
                        device="cuda")
    loop, loop_wall, loop_counts = counted(lambda: [plan(g) for g in gg])
    reps, map_wall, map_counts = counted(lambda: plan.map(gg))
    for b, (g, one, many) in enumerate(zip(gg, loop, reps)):
        assert validate_coloring(g, many.colors), f"dataflow graph {b}"
        assert same_report(many, one), f"dataflow: map differs on graph {b}"
    assert np.array_equal(reps[0].colors, greedy_color(gg[0])), \
        "batched DATAFLOW differs from serial greedy"
    assert 0 < map_counts["round_fused"] <= loop_counts["round_fused"]
    map_total["round_fused"] += map_counts["round_fused"]
    log(f"phase 15 dataflow RMAT-G scale {SCALE_BATCH_DATAFLOW} x "
        f"{BATCH_GRAPHS}: map == loop, graph 0 == serial greedy; sweeps "
        f"{[r.sweeps for r in reps]}; round_fused map "
        f"{map_counts['round_fused']} launches, loop "
        f"{loop_counts['round_fused']}; wall loop {loop_wall:.3f} s, map "
        f"{map_wall:.3f} s")
    for name, n in map_total.items():
        assert n > 0, f"kernel {name} was never launched by a batched map"
    log(f"phase 15 batched: ok; map launches {map_total}")
    return map_total


def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main(argv)`` is the entry
    point)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", name + ".py")
    spec = importlib.util.spec_from_file_location("example_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> dict:
    """Phase 16: the port's examples (``examples/*_torch.py``) on the card,
    each through its ``main(argv)`` in this process: the quickstart under
    ``fused_pallas``, ``ell_pallas`` and DATAFLOW, the comm scheduler
    (ITERATIVE on the card), the LM serving wrapper at the smoke config
    and the training wrapper at the reference example's defaults. Returns
    the kernel launches of the phase; the quickstart's must reach every
    kernel."""
    import contextlib
    import io
    import shutil
    from repro_torch.kernels import KERNELS, launch_counts, \
        reset_launch_counts
    t0 = time.perf_counter()
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "examples_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = [("quickstart_torch", ["--scale", "12", "--engine", e] + extra)
            for e, extra in (("fused_pallas", []), ("ell_pallas", []),
                             ("fused_pallas", ["--strategy", "dataflow"]))]
    runs += [("color_comm_schedule_torch", ["--devices", "64"]),
             ("serve_lm_torch", []),
             ("train_lm_torch", ["--ckpt-dir", ckpt])]
    reset_launch_counts()
    total = {k.name: 0 for k in KERNELS}
    for name, argv in runs:
        before = launch_counts()
        t = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _example(name).main(argv)
        for line in buf.getvalue().splitlines():
            log(f"phase 16 | {line}")
        after = launch_counts()
        log(f"phase 16 {name} {' '.join(argv)}: "
            f"{time.perf_counter() - t:.1f} s; launches before {before}, "
            f"after {after}")
        if name == "quickstart_torch":
            for k in total:
                total[k] += after[k] - before[k]
    for k, n in total.items():
        assert n > 0, f"the quickstart never launched {k}"
    counts = launch_counts()
    log(f"phase 16 launches by the quickstart runs {total}; whole phase "
        f"{counts}")
    log(f"phase 16 examples: ok ({time.perf_counter() - t0:.1f} s)")
    return counts


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("main", "batched"),
                    help="run the build and this phase alone, no result")
    only = ap.parse_args(argv).only
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

    if only == "batched":
        phase_batched({k.name: 0 for k in KERNELS})
        return 0

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
    for kernel, case, got, want in ([] if only else kernel_cases(
            dev, shape.num_vertices, shape.max_degree, words,
            shape.padded_edges, gb.num_vertices, gb.max_degree(),
            skew_words)):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errors[kernel] = max(errors[kernel], err)
        log(f"phase 2 {kernel} [{case}] shape={tuple(got.shape)} "
            f"max_abs_err={err}")
        assert err == 0, f"{kernel} [{case}] disagrees with its plain version"
    if not only:
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
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        plan(graphs[0])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    log(f"phase 3 seed 0 repeats: host walls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s")
    log(f"phase 3 seed 0 repeat: host wall {wall:.3f} s (median); device busy "
        f"{busy_text(busy, wall)}; of the wall, Graph.to_device "
        f"{layout_s:.3f} s; "
        f"host graph generation {gen_s / 2:.1f} s per graph; "
        f"peak device memory {peak / 2**30:.2f} GiB; traces {plan.traces}")
    for name, calls, ms in rows[:12]:
        log(f"  device time: {ms:9.3f} ms in {calls:5d} calls of {name[:70]}")
    log("phase 3 main path: ok")
    if only == "main":
        return 0

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
    counts_lm = phase_lm()
    counts_train = phase_train()
    counts_sharded, sharded = phase_sharded(card)
    counts_dryrun = phase_dryrun(card, sharded)
    counts_batched = phase_batched(errors)
    counts_examples = phase_examples()
    by_path = {"main": main_counts, "models": counts_models,
               "stream": counts_stream, "serve": counts_serve,
               "distributed": counts_dist, "analysis": counts_analysis,
               "lm": counts_lm, "train": counts_train,
               "sharded": counts_sharded, "dryrun": counts_dryrun,
               "batched": counts_batched, "examples": counts_examples}

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
