#!/usr/bin/env python3
"""The control of each cell's comparison, at the cell's own size on the card.

    python3 portbench/control.py --workload er22.oneshot --seeds 1 2 3

For each seed: the cell's graphs as a run makes them, each colored by the
configuration's control (the plain reference with one stated guarantee
broken, in the program's place) and judged as a run judges the program's
answers. A stream's traffic (one with a ``batch`` of ``inserts``,
``deletes`` and ``chain``) is followed along its chains instead: on each
pool graph the control's cold answer, then ``chain`` batches drawn as a run
draws them, each answered by ``control_after`` from the control's own
previous state. Prints one JSON line per seed with the numbers compared and
their limits. Not part of the benchmark's runs; it sets the upper readings
that PERF.md gives beside each limit.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def judged_control(bench: dict, workload: str, seed: int, device, *,
                   config=None, traffic=None) -> dict:
    """The numbers compared for the control of ``workload`` on ``seed``:
    cold answers on every pool graph and, for a stream, the traffic's
    ``chain`` continued answers on each."""
    from portbench import gen, harness, plain
    w = harness.workload(bench, workload)
    ref = harness.load_module(harness.HERE / "configs" / f"{w['config']}.py")
    cell = harness.make_cell(bench, workload, seed, device, config, traffic)
    stream = cell.traffic.get("batch")
    answers = []
    for i, csr in enumerate(cell.csrs):
        got = ref.control(plain.to_device(csr, device), cell.config)
        answers.append(harness.Answered(i, got.colors,
                                        got.conflicts_per_round, None))
        for step in range(int(stream["chain"]) if stream else 0):
            ins, dels = gen.edge_batch(csr, int(stream["inserts"]),
                                       int(stream["deletes"]), seed, i, step,
                                       device)
            after = plain.apply_delta(csr, ins, dels, device)
            got = ref.control_after(plain.to_device(after, device),
                                    cell.config,
                                    plain.to_device(csr, device), got)
            answers.append(harness.Answered(
                i, got.colors, got.conflicts_per_round, None,
                after=len(answers) - 1, inserts=ins, deletes=dels))
            csr = after
    return harness.judge(ref, cell.config, cell.csrs, answers, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench control: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = harness.load_bench()
    for seed in args.seeds:
        checks = judged_control(bench, args.workload, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": harness.passed(checks),
                          "checks": checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
