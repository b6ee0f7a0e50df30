"""Framework application of the paper on the PyTorch/CUDA port: schedule a
MoE expert all-to-all into conflict-free communication rounds by coloring
the transfer-conflict graph (DESIGN.md §3) with the ITERATIVE algorithm of
``repro_torch.core`` on ``--device`` (the card by default), as the
reference's ``schedule_transfers(use_device=True)`` does. Prints the lines
of ``examples/color_comm_schedule.py``.

    PYTHONPATH=src python examples/color_comm_schedule_torch.py --devices 64
    PYTHONPATH=src python examples/color_comm_schedule_torch.py \\
        --devices 64 --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import schedule_transfers
from repro_torch.core.comm_schedule import moe_all_to_all_transfers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.3,
                    help="fraction of (src,dst) pairs with traffic")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    counts = (rng.random((args.devices, args.devices)) < args.density).astype(int)
    transfers = moe_all_to_all_transfers(counts)
    sch = schedule_transfers(transfers, use_device=True, device=args.device)

    t = np.asarray(transfers)
    for r in sch.rounds:  # verify: no port reused within a round
        assert len(set(t[r, 0])) == len(r) and len(set(t[r, 1])) == len(r)

    print(f"{len(transfers)} transfers across {args.devices} devices")
    print(f"scheduled into {sch.num_rounds} conflict-free rounds "
          f"(port-degree lower bound {sch.lower_bound}, "
          f"gap {sch.optimality_gap:.2f}x)")
    for i, r in enumerate(sch.rounds[:5]):
        print(f"  round {i}: {len(r)} transfers")
    if len(sch.rounds) > 5:
        print(f"  ... {len(sch.rounds) - 5} more rounds")
    return sch


if __name__ == "__main__":
    main()
