#!/usr/bin/env python3
"""One traced run of a cell, with the program's span log laid out per graph.

    python3 portbench/span_table.py --workload er22.oneshot --seed 7 --seconds 50
    python3 portbench/span_table.py --cost

From the root of a checkout, on the card. Runs the cell as
``run.py --trace 1`` does and prints its result line, then, from
``repro_torch.kernels.ops.summary()``, each span's count, total and self
time per graph served, beside the trace's idle time by sampled host frame;
last, the checks that tie the span metrics to what is measured from
outside (layout and sync within the window where requests do not queue,
layout against the idle time under the layout frames of ``core/graph.py``,
queue wait against the tail where they do).
A program that records no spans prints the result line alone. Everything
printed is also written to ``results/spans/<cell>-<seed>.json`` under the
checkout.

``--cost`` times one span (a ``with`` of two nested spans, halved) with
nothing recording, with the log on, and under ``torch.profiler`` with the
card's activity, in the profiled thread and in one the profiler does not
trace (the service's worker), and prints nanoseconds per span.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
LAYOUT_FRAMES = ("core/graph.py:to_device", "core/graph.py:directed_edges",
                 "core/graph.py:degrees", "core/graph.py:put",
                 "core/graph.py:max_degree")


def per_graph(out: dict, summary: dict) -> dict:
    """Each span's count, total ms and self ms per graph served, and the
    checks against what the run measured from outside."""
    requests = out["attempted"] - out["failed"]
    rows = {name: {"count": s["count"] / requests,
                   "total_ms": 1e3 * s["total_s"] / requests,
                   "self_ms": 1e3 * s["self_s"] / requests}
            for name, s in sorted(summary.items(),
                                  key=lambda kv: -kv[1]["self_s"])}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    idle = dict(out.get("breakdown", {}).get("idle_gaps", []))
    stem = next((k.split(".")[1] for k in m if k.startswith("layout_ms")),
                None)
    checks = {}
    if stem:
        layout = m[f"layout_ms_per_graph.{stem}"]
        frames = 1e3 * sum(idle.get(f, 0.0) for f in LAYOUT_FRAMES) / requests
        checks["layout_vs_layout_frames_idle"] = {
            "layout_ms_per_graph": layout, "frames_idle_ms_per_graph": frames,
            "ratio": layout / frames if frames else None}
        sync = m.get(f"sync_wait_ms_per_graph.{stem}")
        # without a queue, requests run back to back from one caller: their
        # layout and sync waits fit in the window's time per graph
        if "queue_wait_ms" not in m and sync is not None:
            checks["layout_plus_sync_within_window"] = {
                "sum_ms": layout + sync,
                "window_ms_per_graph":
                    1e3 * out["device"]["window_s"] / requests}
    if "queue_wait_ms" in m:
        checks["queue_wait_within_p95"] = {
            "queue_wait_ms": m["queue_wait_ms"],
            "served_p95_ms": m.get("served_p95_ms")}
    return {"requests": requests, "spans_per_graph":
            sum(r["count"] for r in rows.values()), "spans": rows,
            "checks": checks}


def cost() -> dict:
    import torch
    from repro_torch.kernels import ops

    def ns_per_span(k=20_000):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with ops.span("cost.outer", n=1):
                with ops.span("cost.inner"):
                    pass
        return (time.perf_counter_ns() - t0) / (2 * k)

    out = {"off": ns_per_span()}
    ops.enable()
    out["log"] = ns_per_span()
    ops.disable()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        out["profiler"] = ns_per_span(5_000)
        # a thread the profiler does not trace, as the service's worker
        th = threading.Thread(
            target=lambda: out.update(profiler_worker=ns_per_span(5_000)))
        th.start()
        th.join()
    ops.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("portbench: span_table needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.cost:
        print(json.dumps({"span_cost_ns": cost()}), flush=True)
        return 0
    if not args.workload or args.seed is None:
        ap.error("--workload and --seed are needed without --cost")

    from portbench import harness
    from repro_torch.kernels import ops
    out = harness.run_cell(args.workload, args.seed, args.seconds, True,
                           torch.device("cuda"), started=STARTED)
    print(json.dumps(out), flush=True)
    table = {"workload": args.workload, "seed": args.seed}
    summary = getattr(ops, "summary", None)
    if summary is not None:
        table.update(per_graph(out, summary()), dropped=ops.dropped())
        for name, r in table["spans"].items():
            print(f"span {name:24s} {r['count']:10.2f} /graph "
                  f"self {r['self_ms']:10.3f} ms  total {r['total_ms']:10.3f}"
                  " ms", flush=True)
        print(json.dumps({"checks": table["checks"],
                          "spans_per_graph": table["spans_per_graph"],
                          "dropped": table["dropped"]}), flush=True)
    table["result"] = out
    out_dir = os.path.join(ROOT, "results", "spans")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{args.workload}-{args.seed}.json")
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
