"""The spans of the ``sort`` engine and of ITERATIVE's two round branches,
on the CPU: each ``mex.sort`` span counts the pairs the engine sorted, each
round takes one ``round.full`` or ``round.frontier`` span (``n`` the edge
slots it sweeps), one graph at a time and in a batch, and nothing is
logged while nothing records.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sort_spans.py
"""
import contextlib

import pytest

from repro_torch.core import (ColoringSpec, PlanShape, compile_plan, engine,
                              rmat)
from repro_torch.core.api import _frontier_caps
from repro_torch.core.graph import pad_bucket
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def clean_log():
    ops.disable()
    ops.reset()
    yield
    ops.disable()
    ops.reset()


@contextlib.contextmanager
def _recording():
    ops.enable()
    try:
        yield
    finally:
        ops.disable()


def _spec(frontier="auto", engine_name="sort"):
    return ColoringSpec(strategy="iterative", engine=engine_name,
                        concurrency=64, frontier=frontier, max_rounds=128)


def _graphs(count=1, scale=10):
    return [rmat.paper_graph("RMAT-B", scale=scale, seed=40 + i)
            for i in range(count)]


def _caps(plan):
    st = plan.statics
    return _frontier_caps(plan.spec, type("Envelope", (), dict(
        num_vertices=st.num_vertices, padded_edges=st.padded_edges,
        max_degree=st.max_degree, has_frontier=True)))


@pytest.mark.parametrize("frontier", ["auto", "off"])
def test_mex_sort_spans_count_the_pairs_the_engine_was_handed(
        frontier, monkeypatch):
    handed = []
    real = engine.segment_mex

    def counted(vertex, color, num_vertices):
        handed.append(int(vertex.numel()))
        return real(vertex, color, num_vertices)

    monkeypatch.setattr(engine, "segment_mex", counted)
    g = _graphs()[0]
    plan = compile_plan(_spec(frontier), g, device="cpu")
    plan(g)
    handed.clear()
    with _recording():
        rep = plan(g)
    recs = [r for r in ops.spans() if r.name == "mex.sort"]
    assert [r.n for r in recs] == handed
    assert len(recs) == rep.sweeps
    # each span sits in its round's branch, around one sweep
    names = [r.name for r in ops.spans()]
    assert {names[r.parent] for r in recs} <= {"round.full",
                                               "round.frontier"}


@pytest.mark.parametrize("frontier", ["auto", "off"])
def test_a_round_takes_one_branch_span(frontier):
    g = _graphs(scale=11)[0]
    plan = compile_plan(_spec(frontier), g, device="cpu")
    with _recording():
        rep = plan(g)
    recs = ops.spans()
    full = [r for r in recs if r.name == "round.full"]
    front = [r for r in recs if r.name == "round.frontier"]
    on_full = int((rep.frontier_sizes_per_round == 0).sum())
    assert len(full) == on_full >= 1
    assert len(full) + len(front) == rep.rounds
    assert sum(r.name == "round" for r in recs) == rep.rounds
    assert all(recs[r.parent].name == "round" for r in full + front)
    assert {r.n for r in full} == {plan.statics.padded_edges}
    if frontier == "off":
        assert not front
    else:
        assert front and {r.n for r in front} == {_caps(plan)[1]}


def test_a_batch_spans_its_whole_union():
    graphs = _graphs(count=3)
    plan = compile_plan(_spec(), PlanShape(
        num_vertices=graphs[0].num_vertices,
        padded_edges=pad_bucket(max(g.num_directed_edges for g in graphs)),
        max_degree=max(g.max_degree() for g in graphs)), device="cpu")
    with _recording():
        reps = plan.map(graphs)
    recs = ops.spans()
    B, V = len(graphs), plan.statics.num_vertices
    cap_v, cap_e = _caps(plan)
    full = [r for r in recs if r.name == "round.full"]
    front = [r for r in recs if r.name == "round.frontier"]
    assert {r.n for r in full} == {B * plan.statics.padded_edges}
    assert not front or {r.n for r in front} == {B * cap_e}
    # a round of the batch runs a branch when any of its graphs takes it
    assert len(full) >= max(int((r.frontier_sizes_per_round == 0).sum())
                            for r in reps)
    sizes = {r.n for r in recs if r.name == "mex.sort"}
    assert sizes <= {B * (plan.statics.padded_edges + V),
                     B * (cap_e + cap_v)}


def test_the_other_engines_log_no_mex_sort_span():
    g = _graphs()[0]
    plan = compile_plan(_spec(engine_name="fused_pallas"), g, device="cpu")
    with _recording():
        plan(g)
    names = {r.name for r in ops.spans()}
    assert "mex.sort" not in names and "round.full" in names


def test_nothing_recording_logs_no_branch_or_sort_span():
    g = _graphs()[0]
    plan = compile_plan(_spec(), g, device="cpu")
    rep = plan(g)
    assert rep.rounds > 1
    assert ops.spans() == [] and ops.dropped() == 0
    assert not ops.recording()
    assert ops.span("mex.sort", n=1) is ops.span("round.full", n=1)
