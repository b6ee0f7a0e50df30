"""``python -m repro_torch.launch``: color an R-MAT graph on a process mesh
of local ranks (the command of :mod:`repro_torch.launch`), and the entry of
each rank process that :func:`repro_torch.launch.run_ranks` starts."""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.launch import _rank_main, run_ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch",
        description="Color an R-MAT graph on a process mesh of local ranks.")
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--engine", default="sort")
    args = ap.parse_args(argv)
    if args.rank_of:
        _rank_main(args.rank_of)
        return 0
    results = run_ranks(
        "repro_torch.launch:color_rmat", args.ranks,
        dict(scale=args.scale, engine=args.engine),
        backend=args.backend, device=args.device)
    for r in results:
        print(json.dumps(r), flush=True)
    same = all(r["sha256"] == results[0]["sha256"] for r in results)
    ok = same and results[0]["valid"]
    print(f"RMAT-ER scale {args.scale} on {args.ranks} ranks "
          f"({results[0]['route']} route): rounds={results[0]['rounds']} "
          f"colors={results[0]['colors']} ranks agree={same} "
          f"valid={results[0]['valid']}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
