import os
import sys

import pytest
import torch

# the harness runs the port from the checkout's src/, as run.py does
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


@pytest.fixture
def card():
    # decided at run time, never at import: every test worker collects the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "`python -m pytest -m cuda portbench`")
    return torch.device("cuda")


def small(bench, cell, *, scale_oneshot=9, scale_served=8):
    """The cell's configuration and traffic at a size a CPU test holds:
    smaller graphs, and for the service fewer clients and a smaller batch."""
    from portbench import harness
    w = harness.workload(bench, cell)
    config = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    config["scale"] = {"oneshot": scale_oneshot, "served": scale_served}
    if traffic["driver"] == "service_loop":
        traffic.update(pool=6, clients=6, clients_per_tenant=2)
        traffic["service"]["max_batch"] = 3
    else:
        traffic["pool"] = 2
    return config, traffic
