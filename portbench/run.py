#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 portbench/run.py --workload er22.oneshot --seed 7 --seconds 30 --trace 0

From the root of a checkout. Makes the cell's graphs on the card from
``--seed``, sets the program (``src/repro_torch``) up and warms it, drives
the window for ``--seconds``, judges every answer against the plain
reference, and prints the numbers compared, each beside its limit, as the
last lines of standard error and the result as one JSON line, the last of
standard output: the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics and the device's timeline. Without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded at the
end, it exits with a code other than 0 and prints no result.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    bench = harness.load_bench()
    w = harness.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {args.workload} needs {w['chips']} NVIDIA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           bench=bench, started=STARTED)
    banned = harness.loaded_banned()
    if banned:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{banned}", file=sys.stderr)
        return 3
    for line in harness.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
