#!/usr/bin/env python3
"""The control of each cell's comparison, at the cell's own size on the card.

    python3 portbench/control.py --workload er22.oneshot --seeds 1 2 3

For each seed: the cell's graphs as a run makes them, each colored by the
configuration's control (the plain reference with one stated guarantee
broken, in the program's place) and judged as a run judges the program's
answers. Prints one JSON line per seed with the numbers compared and their
limits. Not part of the benchmark's runs; it sets the upper readings that
PERF.md gives beside each limit.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, plain
    if not torch.cuda.is_available():
        print("portbench control: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = harness.load_bench()
    w = harness.workload(bench, args.workload)
    ref = harness.load_module(harness.HERE / "configs" / f"{w['config']}.py")
    for seed in args.seeds:
        cell = harness.make_cell(bench, args.workload, seed, dev)
        answers = []
        for i, c in enumerate(cell.csrs):
            got = ref.control(plain.to_device(c, dev), cell.config)
            answers.append(harness.Answered(i, got.colors,
                                            got.conflicts_per_round, None))
        checks = harness.judge(ref, cell.config, cell.csrs, answers, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": harness.passed(checks),
                          "checks": checks}), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
