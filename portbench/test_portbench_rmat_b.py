"""``rmat-b.iterative-sort`` on the CPU: its superstep-by-superstep
reference against a plan's call (on the ``sort`` engine and on
``fused_pallas``) and against ``plain.iterative``'s Jacobi sweeps, its
control judged not correct, a broken ``sort`` engine judged not correct in
a whole small run of ``b21.oneshot``, and the cell's two span readers
against counts worked out on the host from a plan's report.

The card test (``-m cuda``) runs ``b21.oneshot`` small and traced: every
answer correct, and the three metrics of the cell read."""
import types

import numpy as np
import pytest
import torch

from portbench import gen, harness, plain, trace
from portbench.conftest import small

CPU = torch.device("cpu")
NAME = "rmat-b.iterative-sort"
CELL = "b21.oneshot"
BENCH = harness.load_bench()
CONFIG = harness.load_json("configs", NAME)
REF = harness.load_module(harness.HERE / "configs" / f"{NAME}.py")
SEED = 2**31 + 23


def _pool(scale, count, seed):
    return gen.make_pool(CONFIG["graph"], scale, count, seed, CPU)


def _graph(c):
    from repro_torch.core import Graph
    return Graph(c.num_vertices, c.row_ptr, c.col_idx)


def _config(scale, **spec):
    spec = dict(CONFIG["spec"], **spec)
    if scale == 6:
        spec["concurrency"] = 8   # several lockstep offsets at this size
    return dict(CONFIG, spec=spec)


@pytest.mark.parametrize("engine", ["sort", "fused_pallas"])
@pytest.mark.parametrize("scale", [6, 10])
def test_reference_equals_a_plan_call(scale, engine):
    from repro_torch.core import ColoringSpec, compile_plan
    config = _config(scale, engine=engine)
    for c in _pool(scale, 2, 2000 + scale):
        g = _graph(c)
        rep = compile_plan(ColoringSpec(**config["spec"]), g,
                           device="cpu")(g)
        want = REF.reference(plain.to_device(c, CPU), config)
        assert np.array_equal(rep.colors, want.colors)
        assert np.array_equal(rep.conflicts_per_round,
                              want.conflicts_per_round)
        assert rep.rounds == len(want.conflicts_per_round)
        assert plain.bad_edges(plain.to_device(c, CPU), rep.colors) == 0


@pytest.mark.parametrize("concurrency", [1, 8, 64, 16384])
@pytest.mark.parametrize("scale", [6, 10])
def test_reference_equals_the_jacobi_sweeps(scale, concurrency):
    # the levels in ascending order reach the fixpoint plain.iterative's
    # sweeps reach: the same colors and conflict counts, round by round
    for c in _pool(scale, 2, 3000 + scale):
        g = plain.to_device(c, CPU)
        for repair in (True, False):
            got = REF.iterative_by_levels(g, concurrency, repair)
            want = plain.iterative(g, concurrency, repair)
            assert np.array_equal(got.colors, want.colors)
            assert np.array_equal(got.conflicts_per_round,
                                  want.conflicts_per_round)


def test_control_is_judged_not_correct():
    csrs = _pool(10, 3, 7)
    answers = []
    for i, c in enumerate(csrs):
        got = REF.control(plain.to_device(c, CPU), CONFIG)
        answers.append(harness.Answered(i, got.colors,
                                        got.conflicts_per_round, 0.0))
    checks = harness.judge(REF, CONFIG, csrs, answers, CPU)
    assert not harness.passed(checks)
    assert checks["wrong_colors"]["value"] > 0
    assert checks["bad_edges"]["value"] > 0
    assert checks["wrong_histories"]["value"] == len(csrs)


def test_a_broken_sort_engine_is_not_correct(monkeypatch):
    # the engine's mex hands back 1 for every row: no sweep moves past it
    from repro_torch.core import engine

    def ones(vertex, color, num_vertices):
        return torch.ones(num_vertices, dtype=torch.int32)

    monkeypatch.setattr(engine, "segment_mex", ones)
    config, traffic = small(BENCH, CELL)
    out = harness.run_cell(CELL, SEED, 0.4, False, CPU, bench=BENCH,
                           config=config, traffic=traffic)
    assert out["correct"] is False
    assert out["checks"]["wrong_colors"]["value"] > 0


def _read(metric, requests):
    window = harness.Window(seconds=1.0, graphs=requests, answers=[
        harness.Answered(0, [1], None, 0.1)] * requests, values={})
    ctx = trace.ReadContext(window=window, trace=None, launches=[],
                            window_peak_bytes=None)
    return harness.load_module(harness.reader_path(metric)).read(ctx)


@pytest.mark.parametrize("frontier", ["auto", "off"])
def test_span_readers_equal_counts_worked_out_on_the_host(frontier):
    """``sort_pairs_per_graph``: a full sweep sorts the padded edge list
    and one pair per vertex, a frontier sweep the edge slab and one pair
    per slab row; ``full_rounds_per_graph``: the rounds the report shows
    on the full path (frontier size 0)."""
    from repro_torch.core import ColoringSpec, compile_plan
    from repro_torch.core.api import _frontier_caps
    from repro_torch.kernels import ops
    spec = ColoringSpec(**dict(CONFIG["spec"], concurrency=64,
                               frontier=frontier))
    graphs = [_graph(c) for c in _pool(11, 2, 11)]
    plan = compile_plan(spec, graphs[0], device="cpu")
    V, E = plan.statics.num_vertices, plan.statics.padded_edges
    cap_v, cap_e = _frontier_caps(spec, types.SimpleNamespace(
        num_vertices=V, padded_edges=E, max_degree=plan.statics.max_degree,
        has_frontier=True))
    ops.reset()
    ops.enable()
    try:
        reps = [plan(g) for g in graphs]
    finally:
        ops.disable()
    pairs = full = 0
    for rep in reps:
        slab = rep.frontier_sizes_per_round > 0
        pairs += (int(rep.sweeps_per_round[~slab].sum()) * (E + V)
                  + int(rep.sweeps_per_round[slab].sum()) * (cap_e + cap_v))
        full += int((~slab).sum())
    try:
        assert full >= len(reps) and (frontier == "off") == (full == sum(
            r.rounds for r in reps))
        assert _read("sort_pairs_per_graph", len(reps)) == pytest.approx(
            pairs * 1e-6 / len(reps), rel=1e-12)
        assert _read("full_rounds_per_graph", len(reps)) == full / len(reps)
    finally:
        ops.reset()


def test_the_radix_sort_reader_takes_the_sort_kernels_only():
    ops = [trace.DeviceOp(name, cat, 0.0, dur) for name, cat, dur in [
        ("void cub::CUB_200200_900_NS::DeviceRadixSortOnesweepKernel<...>",
         "kernel", 300.0),
        ("void cub::DeviceRadixSortHistogramKernel<...>", "kernel", 100.0),
        ("void cub::DeviceRadixSortExclusiveSumKernel<...>", "kernel", 20.0),
        ("void at::native::index_elementwise_kernel<...>", "kernel", 500.0),
        ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 50.0)]]
    parsed = trace.Parsed(ops=ops, window_s=1.0, busy_s=0.97, idle=[])
    window = harness.Window(seconds=1.0, graphs=2, answers=[
        harness.Answered(0, [1], None, 0.1)] * 2, values={})
    reader = harness.load_module(
        harness.reader_path("radix_sort_ms_per_graph"))
    ctx = trace.ReadContext(window=window, trace=parsed, launches=[],
                            window_peak_bytes=None)
    assert reader.read(ctx) == pytest.approx(0.21)
    ctx.trace = trace.Parsed(ops=ops[3:], window_s=1.0, busy_s=0.5, idle=[])
    assert reader.read(ctx) is None


@pytest.mark.cuda
def test_small_cell_on_the_card(card):
    config, traffic = small(BENCH, CELL, scale_oneshot=14)
    out = harness.run_cell(CELL, SEED, 1.0, True, card, bench=BENCH,
                           config=config, traffic=traffic)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["sort_pairs_per_graph"] > 0
    assert m["full_rounds_per_graph"] >= 1
    assert m["radix_sort_ms_per_graph"] > 0
    assert m["radix_sort_ms_per_graph"] <= m["torch_ops_ms_per_graph.oneshot"]
