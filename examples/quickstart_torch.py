"""Quickstart on the PyTorch/CUDA port: the paper in ~50 lines, driven
through the spec front door of ``repro_torch.core``.

Generates the paper's three R-MAT graph families and colors each through
``repro_torch.core.color`` with one declarative ``ColoringSpec``: strategy
(``--strategy iterative|dataflow|distributed``), first-fit mex backend
(``--engine sort|bitmap|ell_pallas|fused_pallas``; on the card the last
two launch the hand-written CUDA kernels ``firstfit`` and ``round_fused``,
and every ITERATIVE round launches ``conflict_mask``), coloring model
(``--model d1|d2``) and vertex ordering (``--ordering natural|random|
largest_first|smallest_last``). Every result is validated against the
model's rules and serial oracle. The per-family lines are those of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--scale 12] \\
        [--engine fused_pallas]
    PYTHONPATH=src python examples/quickstart_torch.py --strategy dataflow \\
        --ordering largest_first
    PYTHONPATH=src python examples/quickstart_torch.py --scale 8 --model d2 \\
        --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --scale 10 --stream 4

``--device`` defaults to the card (``cuda``); ``--device cpu`` runs the
plain PyTorch path on the host.
``--stream N`` additionally pushes N ~1%-edge delta batches through
``repro_torch.core.DynamicColoring``: inserts and deletes are repaired in
place by the ``"recolor"`` strategy, seeded with only the newly
conflicting endpoints, with no program rebuilt across batches.
"""
import argparse

import numpy as np

from repro_torch.core import (rmat, color, ColoringSpec,
                              DynamicColoring, available_backends,
                              available_strategies, greedy_color,
                              greedy_color_d2, validate_coloring,
                              validate_d2_coloring, num_colors)
from repro_torch.core.ordering import ORDERINGS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--concurrency", type=int, default=128)
    ap.add_argument("--strategy", default="iterative",
                    choices=available_strategies(),
                    help="registered coloring strategy (repro_torch.core.api)")
    ap.add_argument("--engine", default="sort", choices=available_backends(),
                    help="first-fit mex backend (repro_torch.core.engine)")
    ap.add_argument("--ordering", default="natural", choices=sorted(ORDERINGS),
                    help="vertex-visit ordering (paper §5.1); colors are "
                         "reported in original vertex ids regardless")
    ap.add_argument("--model", default="d1", choices=["d1", "d2"],
                    help="coloring model: distance-1 or distance-2 "
                         "(d2 is denser — prefer --scale <= 9)")
    ap.add_argument("--frontier", default="auto",
                    choices=["auto", "on", "off"],
                    help="active-set execution (repro_torch.core.frontier): "
                         "compact rounds >= 1 into a fixed slab so they "
                         "cost O(frontier) instead of O(E); bit-identical "
                         "results either way")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="after coloring, stream N ~1%%-edge delta batches "
                         "through repro_torch.core.DynamicColoring: "
                         "incremental 'recolor' repairs seeded by the newly "
                         "conflicting endpoints (d1 only)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    serial_fn = greedy_color if args.model == "d1" else greedy_color_d2
    valid_fn = validate_coloring if args.model == "d1" else validate_d2_coloring
    # D2 constraint graphs are ~avg-degree x denser: conflict rounds rise
    p = args.concurrency if args.model == "d1" else min(args.concurrency, 16)
    # frontier="on" needs the square (row-deduped) lowering under d2;
    # "auto"/"off" keep the memory-lean default
    lowering = "square" if args.frontier == "on" else "auto"
    spec = ColoringSpec(strategy=args.strategy, model=args.model,
                        engine=args.engine, ordering=args.ordering,
                        concurrency=p, max_rounds=256,
                        frontier=args.frontier, lowering=lowering)
    for name in ["RMAT-ER", "RMAT-G", "RMAT-B"]:
        g = rmat.paper_graph(name, scale=args.scale, seed=0)

        serial = serial_fn(g)
        rep = color(g, spec, device=args.device)

        assert valid_fn(g, serial)
        assert valid_fn(g, rep.colors)

        s = g.stats()
        print(f"{name}: |V|={s['num_vertices']} |E|={s['num_edges']} "
              f"maxdeg={s['max_degree']} strategy={args.strategy} "
              f"engine={args.engine} model={args.model} "
              f"ordering={args.ordering}")
        frontier_rounds = int((rep.frontier_sizes_per_round > 0).sum())
        print(f"  serial greedy : {num_colors(serial):3d} colors")
        print(f"  {args.strategy:14s}: {rep.num_colors:3d} colors, "
              f"{rep.rounds} rounds, {rep.sweeps} sweeps, "
              f"{rep.total_conflicts} conflicts, "
              f"{frontier_rounds} frontier rounds, {rep.wall_time_s:.3f}s")
        if args.strategy == "dataflow" and args.ordering == "natural":
            # the dataflow fixpoint IS the serial greedy coloring
            assert np.array_equal(rep.colors, serial)
            print("                  (bit-identical to the serial oracle)")

        if args.stream > 0 and args.model != "d1":
            print("  (--stream skipped: streaming repair is d1 only — an "
                  "edge delta perturbs d2 constraints beyond its endpoints)")
        elif args.stream > 0:
            # streaming lane: ~1% edge-delta batches repaired in place by
            # the "recolor" strategy (repro_torch.core.dynamic)
            dyn = DynamicColoring(
                g, ColoringSpec(strategy="recolor", engine=args.engine,
                                concurrency=p, max_rounds=256,
                                frontier=args.frontier), device=args.device)
            rng = np.random.default_rng(0)
            m = max(1, g.num_edges // 100)
            for _ in range(args.stream):
                ins = np.stack([rng.integers(0, g.num_vertices, m),
                                rng.integers(0, g.num_vertices, m)], 1)
                cur = dyn.graph.undirected_edges()
                dr = dyn.apply_batch(
                    inserts=ins,
                    deletes=cur[rng.integers(0, cur.shape[0], m)])
                assert valid_fn(dyn.graph, dyn.colors)
            print(f"  streamed {args.stream} delta batches (~{m} ins/del "
                  f"each): {dyn.num_colors} colors "
                  f"(bound {dyn.color_bound}), last seed "
                  f"{dr.seed_size}, retraces={dyn.plan.traces}, "
                  f"recompiles={dyn.recompiles}")


if __name__ == "__main__":
    main()
