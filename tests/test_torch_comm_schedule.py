"""repro_torch.core.comm_schedule against the reference: the same transfer
sets give the same rounds, both on the host oracle (``use_device=False``)
and through the ITERATIVE coloring (``use_device=True``, the port on
``device="cpu"``), on random transfer sets and on the transfers of random
MoE dispatch matrices."""
import numpy as np
import pytest

import repro.core.comm_schedule as RS
import repro_torch.core as T
from repro_torch.core import comm_schedule as TS


def _same(got, want):
    assert got.num_rounds == want.num_rounds
    assert got.lower_bound == want.lower_bound
    assert [[int(i) for i in r] for r in got.rounds] == \
        [[int(i) for i in r] for r in want.rounds]
    assert got.optimality_gap == want.optimality_gap


def _check(transfers):
    for use_device in (False, True):
        got = T.schedule_transfers(transfers, use_device=use_device,
                                   device="cpu")
        want = RS.schedule_transfers(transfers, use_device=use_device)
        _same(got, want)
        # a round never shares a port
        for r in got.rounds:
            src = [transfers[i][0] for i in r]
            dst = [transfers[i][1] for i in r]
            assert len(set(src)) == len(src) and len(set(dst)) == len(dst)
    return got


@pytest.mark.parametrize("seed", range(6))
def test_random_transfer_sets(seed):
    rng = np.random.default_rng(seed)
    chips = int(rng.integers(4, 33))
    n = int(rng.integers(1, 200))
    transfers = [tuple(int(v) for v in rng.integers(0, chips, 2))
                 for _ in range(n)]
    _check(transfers)


@pytest.mark.parametrize("seed", range(4))
def test_moe_all_to_all_schedules(seed):
    rng = np.random.default_rng(100 + seed)
    D = int(rng.integers(4, 17))
    send = rng.integers(0, 3, (D, D)) * (rng.random((D, D)) < 0.7)
    transfers = TS.moe_all_to_all_transfers(send)
    assert transfers == RS.moe_all_to_all_transfers(send)
    sched = _check(transfers)
    # a dense all-to-all packs into about max-port-degree rounds
    assert sched.num_rounds <= 2 * sched.lower_bound


def test_degenerate_transfer_sets():
    assert T.schedule_transfers([]).num_rounds == 0
    one = T.schedule_transfers([(0, 1)], use_device=True, device="cpu")
    assert one.rounds == [[0]] and one.lower_bound == 1
    assert TS._clique_edges(np.array([3, 1, 3, 3])).tolist() == \
        RS._clique_edges(np.array([3, 1, 3, 3])).tolist()
