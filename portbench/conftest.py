import os
import sys

import pytest
import torch

# the per-cell checks are plain functions the tests call: rewrite their
# asserts as pytest does a test's
pytest.register_assert_rewrite("portbench.cell_checks")

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
    smaller graphs at every request scale the configuration names
    (``served`` at ``scale_served``, every other at ``scale_oneshot``); for
    the service fewer clients and a smaller batch; for a stream (a traffic
    with a ``batch``) batches cut in the graphs' proportion."""
    from portbench import harness
    w = harness.workload(bench, cell)
    config = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    full = config["scale"]
    config["scale"] = {k: scale_served if k == "served" else scale_oneshot
                       for k in full}
    if traffic["driver"] == "service_loop":
        traffic.update(pool=6, clients=6, clients_per_tenant=2)
        traffic["service"]["max_batch"] = 3
    else:
        traffic["pool"] = min(int(traffic["pool"]), 2)
    if "batch" in traffic:
        cut = 2.0 ** (config["scale"][traffic["request_scale"]]
                      - full[traffic["request_scale"]])
        batch = traffic["batch"] = dict(traffic["batch"])
        for k in ("inserts", "deletes"):
            batch[k] = max(1, round(int(batch[k]) * cut))
    return config, traffic
