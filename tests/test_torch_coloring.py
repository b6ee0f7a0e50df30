"""repro_torch end to end against the reference: the same R-MAT graphs go
through ``repro.core.color`` and ``repro_torch.core.color(device="cpu")``
across families x strategies x concurrency x frontier x ordering x every
port engine, with zero tolerance on colors, ``rounds`` and the three
per-round histories. The reference runs its ``bitmap`` engine (the engines
are bit-identical by its own contract); one case runs its ``fused_pallas``
kernel in interpret mode. Plus the front door's contracts: one program
build per same-bucket family, raising without a card unless
``device="cpu"``, spec dicts that mean the same to both packages
(distributed fields included), and an import that pulls in neither JAX
nor the reference. The d2/pd2 models, the ``recolor`` strategy, serving
and the distributed strategy have their own files
(``test_torch_models.py``, ``test_torch_dynamic.py``,
``test_torch_serve.py``, ``test_torch_distributed.py``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.convert import device_graph_from_arrays

FAMILIES = ["RMAT-ER", "RMAT-G", "RMAT-B"]
ENGINES = ["sort", "bitmap", "ell_pallas", "fused_pallas"]
CONFIGS = [("iterative", 1), ("iterative", 64), ("iterative", "V"),
           ("dataflow", 64)]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the graphs here are tiny: intra-op threads only contend with the
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graphs():
    return {f: (R.rmat.paper_graph(f, 8, seed=4), T.rmat.paper_graph(f, 8, seed=4))
            for f in FAMILIES}


def assert_same_report(got, want, ctx=""):
    np.testing.assert_array_equal(got.colors, want.colors, err_msg=ctx)
    assert got.rounds == want.rounds, ctx
    for f in ("conflicts_per_round", "sweeps_per_round",
              "frontier_sizes_per_round"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{ctx} {f}")


@pytest.mark.parametrize("frontier", ["off", "auto", "on"])
@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("family", FAMILIES)
def test_color_matches_reference(family, config, frontier, graphs):
    gr, gt = graphs[family]
    strategy, conc = config
    conc = gr.num_vertices if conc == "V" else conc
    for ordering in ("natural", "largest_first"):
        kw = dict(strategy=strategy, concurrency=conc, frontier=frontier,
                  ordering=ordering)
        want = R.color(gr, R.ColoringSpec(engine="bitmap", **kw))
        for engine in ENGINES:
            got = T.color(gt, T.ColoringSpec(engine=engine, **kw), device="cpu")
            assert_same_report(got, want, f"{engine} {ordering}")
            assert T.validate_coloring(gt, got.colors)


def test_fused_pallas_matches_reference_kernel_in_interpret_mode():
    gr = R.rmat.paper_graph("RMAT-G", 7, seed=1)
    gt = T.rmat.paper_graph("RMAT-G", 7, seed=1)
    kw = dict(strategy="iterative", concurrency=32, frontier="on",
              engine="fused_pallas")
    assert_same_report(T.color(gt, T.ColoringSpec(**kw), device="cpu"),
                       R.color(gr, R.ColoringSpec(**kw)))


@pytest.mark.parametrize("family", FAMILIES)
def test_dataflow_equals_serial_greedy(family, graphs):
    _, gt = graphs[family]
    for engine in ENGINES:
        res = T.color_dataflow(gt, engine=engine, device="cpu")
        np.testing.assert_array_equal(res.colors, T.greedy_color(gt))


def test_legacy_shims_match_reference(graphs):
    gr, gt = graphs["RMAT-ER"]
    a = R.color_iterative(gr, concurrency=16, engine="bitmap")
    b = T.color_iterative(gt, concurrency=16, engine="ell_pallas", device="cpu")
    np.testing.assert_array_equal(b.colors, np.asarray(a.colors))
    assert b.rounds == a.rounds and b.sweeps == a.sweeps
    np.testing.assert_array_equal(b.conflicts_per_round,
                                  np.asarray(a.conflicts_per_round)[:a.rounds])
    c = R.color_dataflow(gr, engine="bitmap")
    d = T.color_dataflow(gt, engine="fused_pallas", device="cpu")
    np.testing.assert_array_equal(d.colors, np.asarray(c.colors))
    assert d.sweeps == c.sweeps


def test_same_device_layout_same_coloring(graphs):
    """Both packages color the identical device layout (carried across)."""
    gr, _ = graphs["RMAT-B"]
    dr = gr.to_device(layout=("edges", "ell"))
    fields = {f: np.asarray(getattr(dr, f)) for f in ("src", "dst", "ell_slot",
                                                      "inc_ptr")}
    fields.update(num_vertices=dr.num_vertices, max_degree=dr.max_degree,
                  num_directed_edges=dr.num_directed_edges,
                  ell_width=dr.ell_width)
    dt = device_graph_from_arrays(fields, device="cpu")
    spec = dict(strategy="iterative", concurrency=128, engine="ell_pallas")
    assert_same_report(T.color(dt, T.ColoringSpec(**spec)),
                       R.color(dr, R.ColoringSpec(**spec)))


def test_plan_builds_once_per_bucket_family():
    spec = T.ColoringSpec(strategy="iterative", engine="fused_pallas",
                          concurrency=16)
    gs = [T.rmat.paper_graph("RMAT-G", 8, seed=s) for s in range(4)]
    shape = T.PlanShape(
        num_vertices=gs[0].num_vertices,
        padded_edges=T.pad_bucket(max(g.num_directed_edges for g in gs)),
        max_degree=max(g.max_degree() for g in gs))
    plan = T.compile_plan(spec, shape, device="cpu")
    assert plan.traces == 0
    reports = [plan(g) for g in gs]
    assert plan.traces == 1
    mapped = plan.map(gs)
    assert plan.traces == 2   # the per-graph and the batched program
    for g, one, many in zip(gs, reports, mapped):
        assert T.validate_coloring(g, one.colors)
        assert_same_report(many, one)
        assert_same_report(one, T.color(g, spec, device="cpu"))
    # the reference plan serves the same family with the same results
    ref = R.compile_plan(R.ColoringSpec(**spec.to_dict()),
                         R.PlanShape(shape.num_vertices, shape.padded_edges,
                                     shape.max_degree))
    for g, one in zip(gs, reports):
        gr = R.Graph(g.num_vertices, g.row_ptr, g.col_idx)
        assert_same_report(one, ref(gr))


def test_plan_rejects_graphs_outside_its_envelope():
    g = T.rmat.paper_graph("RMAT-ER", 8, seed=0)
    plan = T.compile_plan(T.ColoringSpec(engine="bitmap"), g, device="cpu")
    with pytest.raises(ValueError, match="vertices"):
        plan(T.rmat.paper_graph("RMAT-ER", 7, seed=0))
    with pytest.raises(ValueError, match="max degree"):
        plan(T.rmat.paper_graph("RMAT-B", 8, seed=0))
    with pytest.raises(TypeError):
        T.compile_plan(T.ColoringSpec(), g.to_device(device="cpu"), device="cpu")


def test_degenerate_graphs_color_trivially():
    empty = T.Graph.from_edges(5, np.zeros((0, 2), np.int64))
    rep = T.color(empty, device="cpu")
    assert rep.colors.tolist() == [1] * 5 and rep.rounds == 0
    plan = T.compile_plan(T.ColoringSpec(), empty, device="cpu")
    assert plan(empty).colors.tolist() == [1] * 5 and plan.traces == 0


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = T.rmat.paper_graph("RMAT-ER", 6, seed=0)
    for call in (lambda: T.color(g), lambda: T.compile_plan(T.ColoringSpec(), g),
                 lambda: T.color_iterative(g), lambda: T.color_dataflow(g),
                 lambda: g.to_device(layout="ell")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert T.color(g, device="cpu").rounds >= 1


def test_distributed_spec_dict_round_trips():
    ref = R.ColoringSpec(strategy="distributed", engine="ell_pallas",
                         wire="full", partition="2d", local_concurrency=4,
                         frontier="off", max_sweeps=16384)
    spec = T.ColoringSpec.from_dict(ref.to_dict())
    assert (spec.wire, spec.partition, spec.local_concurrency) == \
        ("full", "2d", 4)
    assert spec.to_dict() == ref.to_dict()
    assert R.ColoringSpec.from_dict(spec.to_dict()) == ref


def test_distributed_strategy_is_registered():
    assert "distributed" in T.available_strategies()
    strategy = T.get_strategy("distributed")
    assert strategy.wants == "host" and not strategy.supports_map


def test_spec_dict_means_the_same_to_both_packages():
    ref = R.ColoringSpec(strategy="dataflow", engine="fused_pallas",
                         ordering="smallest_last", concurrency=7,
                         frontier="off", frontier_capacity=16)
    spec = T.ColoringSpec.from_dict(ref.to_dict())
    assert spec.to_dict() == ref.to_dict()
    assert T.available_strategies() == ("dataflow", "distributed",
                                         "iterative", "recolor")
    with pytest.raises(ValueError, match="unknown"):
        T.ColoringSpec(frontier="sometimes")


def test_import_pulls_in_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.convert, repro_torch.core.distance2, "
            "repro_torch.core.dynamic, repro_torch.serve, "
            "repro_torch.serve.coloring, repro_torch.train.checkpoint, "
            "repro_torch.core.distributed, repro_torch.parallel, "
            "repro_torch.core.comm_schedule, repro_torch.launch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
