"""repro_torch's batched ``plan.map`` against the reference's vmapped one.

The reference's ``ColoringPlan.map`` stacks the canonical DeviceGraphs and
runs ONE ``jax.jit(jax.vmap(program))`` (``compile_batched``): its Pallas
kernels run as batched calls in interpret mode here, its round and sweep
loops run until every graph is done, and a finished graph keeps its state.
The port's ``map`` stacks the same graphs into one block-diagonal
``BatchedGraph`` and runs one batched round loop. The same R-MAT graphs
(same seeds, graphs of different edge counts in one bucket, B in
{1, 2, 3, 5}) go through both, with zero tolerance on colors, ``rounds``
and the three per-round histories: ITERATIVE under every engine with the
frontier on ``auto`` and ``off``, DATAFLOW under ``sort`` and
``fused_pallas``, ``model="d2"`` under an ELL engine, a non-natural
ordering, a batch whose graphs need different round counts (the freeze), a
round in which some graphs take the frontier branch and others the full
one, and a ``max_rounds`` cap that leaves one graph unconverged. Plus the
plan's contracts: one call of the batched program per ``map``, and the
reference's program-build counts."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.api import PlanShape as RPlanShape

RAW_FIELDS = ("conflicts_per_round", "sweeps_per_round", "frontier_per_round")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs(families, scale, seeds):
    """The same graphs in both packages (the generators are bit-identical)."""
    port = [T.rmat.paper_graph(f, scale, seed=s)
            for f, s in zip(families, seeds)]
    ref = [R.Graph(g.num_vertices, g.row_ptr, g.col_idx) for g in port]
    return port, ref


def _plans(spec_kw, port, ref, model="d1"):
    """One port plan and one reference plan over the batch's envelope (in
    constraint-graph space, so d2 plans size on the squared graphs)."""
    hosts = [T.distance2.constraint_host_graph(g, model) for g in port]
    shape = T.PlanShape(
        num_vertices=hosts[0].num_vertices,
        padded_edges=T.pad_bucket(max(h.num_directed_edges for h in hosts)),
        max_degree=max(h.max_degree() for h in hosts))
    spec = T.ColoringSpec(model=model, **spec_kw)
    rplan = R.compile_plan(R.ColoringSpec(**spec.to_dict()),
                           RPlanShape(shape.num_vertices, shape.padded_edges,
                                      shape.max_degree))
    return T.compile_plan(spec, shape, device="cpu"), rplan


def assert_same_reports(got, want, ctx=""):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        c = f"{ctx} graph {b}"
        np.testing.assert_array_equal(g.colors, np.asarray(w.colors),
                                      err_msg=c)
        assert g.rounds == w.rounds, c
        for f in ("conflicts_per_round", "sweeps_per_round",
                  "frontier_sizes_per_round"):
            np.testing.assert_array_equal(getattr(g, f),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f"{c} {f}")


def _map_both(spec_kw, port, ref, model="d1"):
    plan, rplan = _plans(spec_kw, port, ref, model)
    got, want = plan.map(port), rplan.map(ref)
    assert_same_reports(got, want, str(spec_kw))
    for g, rep in zip(port, got):
        validate = (T.validate_d2_coloring if model == "d2"
                    else T.validate_coloring)
        assert validate(g, rep.colors)
    return plan, got


# (engine, frontier) -> (family, B): every engine under both frontier
# modes, spread over the families and the batch sizes
ITERATIVE_CASES = [
    ("sort", "auto", "RMAT-ER", 3), ("sort", "off", "RMAT-G", 2),
    ("bitmap", "auto", "RMAT-B", 5), ("bitmap", "off", "RMAT-ER", 1),
    ("ell_pallas", "auto", "RMAT-G", 5), ("ell_pallas", "off", "RMAT-B", 3),
    ("fused_pallas", "auto", "RMAT-B", 2), ("fused_pallas", "off", "RMAT-G", 3),
]


@pytest.mark.parametrize("engine,frontier,family,batch", ITERATIVE_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in ITERATIVE_CASES])
def test_iterative_map_matches_reference(engine, frontier, family, batch):
    port, ref = _graphs([family] * batch, 8, range(batch))
    _map_both(dict(strategy="iterative", engine=engine, frontier=frontier,
                   concurrency=64), port, ref)


@pytest.mark.parametrize("engine", ["sort", "fused_pallas"])
def test_dataflow_map_matches_reference(engine):
    port, ref = _graphs(["RMAT-G"] * 3, 8, range(3))
    _, got = _map_both(dict(strategy="dataflow", engine=engine), port, ref)
    for g, rep in zip(port, got):
        np.testing.assert_array_equal(rep.colors, T.greedy_color(g))


def test_d2_map_under_an_ell_engine_matches_reference():
    port, ref = _graphs(["RMAT-ER"] * 2, 6, (1, 2))
    _map_both(dict(strategy="iterative", engine="ell_pallas",
                   concurrency=16), port, ref, model="d2")


def test_ordered_map_matches_reference():
    port, ref = _graphs(["RMAT-B"] * 3, 7, (3, 4, 5))
    _map_both(dict(strategy="iterative", engine="bitmap",
                   ordering="largest_first", concurrency=32), port, ref)
    _map_both(dict(strategy="dataflow", engine="ell_pallas",
                   ordering="smallest_last"), port, ref)


def test_freeze_of_graphs_that_finish_first():
    """Graphs of one envelope that need different round counts: the ones
    that finish stay frozen while the others run on (the reference's vmap
    select), and one round runs the frontier branch for some graphs and
    the full branch for others. DATAFLOW over the same batch: each graph
    sweeps to its own depth, taking the slab or the full sweep alone."""
    port, ref = _graphs(["RMAT-ER", "RMAT-B", "RMAT-G", "RMAT-B", "RMAT-ER"],
                        8, range(5))
    # a sparse member: a few edges in the same vertex count
    V = port[0].num_vertices
    edges = np.array([[0, 1], [1, 2], [2, 0], [V - 1, 0]])
    port.append(T.Graph.from_edges(V, edges))
    ref.append(R.Graph.from_edges(V, edges))
    plan, got = _map_both(dict(strategy="iterative", engine="fused_pallas",
                               concurrency=128, frontier_capacity=24),
                          port, ref)
    rounds = [r.rounds for r in got]
    assert len(set(rounds)) > 2, rounds
    fronts = np.zeros((len(got), max(rounds)), np.int64)
    for b, r in enumerate(got):
        fronts[b, :r.rounds] = r.frontier_sizes_per_round
    live = np.array([[rnd < r for rnd in range(max(rounds))]
                     for r in rounds])
    mixed = [rnd for rnd in range(1, max(rounds))
             if (fronts[live[:, rnd], rnd] > 0).any()
             and (fronts[live[:, rnd], rnd] == 0).any()]
    assert mixed, "no round took both branches"
    _, flows = _map_both(dict(strategy="dataflow", engine="sort",
                              frontier_capacity=24), port, ref)
    assert len({r.sweeps for r in flows}) > 2


def test_max_rounds_cap_leaves_one_graph_unconverged():
    """The batched programs themselves (``compile_batched``), as
    ``plan.map`` raises on an unconverged graph: the per-graph flags, round
    counts and histories under a cap that stops only some graphs."""
    # uncapped, these take 4, 10 and 7 rounds
    port, ref = _graphs(["RMAT-ER", "RMAT-B", "RMAT-G"], 8, (0, 1, 0))
    plan, rplan = _plans(dict(strategy="iterative", engine="bitmap",
                              concurrency=64, max_rounds=6), port, ref)
    prog = plan.strategy.compile_batched(plan.spec, plan.statics,
                                         lambda: None)
    got = prog([plan._canonicalize(g)[0] for g in port])
    rprog = rplan.strategy.compile_batched(rplan.spec, rplan.statics,
                                           lambda: None)
    import jax
    import jax.numpy as jnp
    want = rprog(jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[rplan._canonicalize(g)[0] for g in ref]))
    flags = [raw.unconverged for raw in got]
    assert flags == np.asarray(want.unconverged).tolist()
    assert any(flags) and not all(flags), flags
    for b, raw in enumerate(got):
        np.testing.assert_array_equal(raw.colors.numpy(),
                                      np.asarray(want.colors[b]))
        assert raw.rounds == int(want.rounds[b])
        for f in RAW_FIELDS:
            np.testing.assert_array_equal(getattr(raw, f),
                                          np.asarray(getattr(want, f)[b]))
    with pytest.raises(RuntimeError, match="did not converge"):
        plan.map(port)


def test_map_calls_the_batched_program_once(monkeypatch):
    """``map`` calls the batched program once per call, never the per-graph
    program; program builds follow the reference's
    ``test_plan_map_matches_python_loop``."""
    calls = []
    build = T.api.IterativeStrategy.compile_batched

    def spy(self, *args):
        prog = build(self, *args)

        def run(graphs):
            calls.append(len(graphs))
            return prog(graphs)

        return run

    monkeypatch.setattr(T.api.IterativeStrategy, "compile_batched", spy)
    port, ref = _graphs(["RMAT-ER"] * 3, 8, range(3))
    plan, rplan = _plans(dict(strategy="iterative", engine="sort",
                              concurrency=8), port, ref)
    mapped = plan.map(port)
    assert calls == [3] and plan.traces == 1 and plan._program is None
    looped = [plan(g) for g in port]
    assert plan.traces == 2
    assert_same_reports(mapped, looped)
    rlooped = [rplan(g) for g in ref]
    assert_same_reports(plan.map(list(reversed(port))),
                        list(reversed(rlooped)))
    assert_same_reports(plan.map(port[:1]), rlooped[:1])
    assert calls == [3, 3, 1] and plan.traces == 2
    assert plan.map([]) == [] and calls == [3, 3, 1]



def test_a_registered_device_strategy_maps_graph_by_graph(monkeypatch):
    """A user's device strategy with ``supports_map`` and no
    ``compile_batched`` of its own: the base hook serves the batch through
    its ``device_program``, one call per graph in batch order. The reports
    equal the strategy's per-graph calls, and a plan that is only mapped
    builds one program."""
    import dataclasses
    calls = []

    @dataclasses.dataclass(frozen=True)
    class CountedGreedy(T.api.ColoringStrategy):
        name = "counted-greedy"

        def device_program(self, spec, backend):
            inner = T.api.get_strategy("dataflow").device_program(spec,
                                                                  backend)

            def run(dg):
                calls.append(dg.num_vertices)
                return inner(dg)

            return run

    monkeypatch.setattr(T.api, "_REGISTRY", dict(T.api._REGISTRY))
    T.api.register_strategy(CountedGreedy())
    port, ref = _graphs(["RMAT-G", "RMAT-B", "RMAT-ER"], 7, (0, 1, 2))
    shape = T.PlanShape(
        num_vertices=port[0].num_vertices,
        padded_edges=T.pad_bucket(max(g.num_directed_edges for g in port)),
        max_degree=max(g.max_degree() for g in port))
    plan = T.compile_plan(T.ColoringSpec(strategy="counted-greedy",
                                         engine="bitmap"), shape,
                          device="cpu")
    mapped = plan.map(port)
    assert calls == [shape.num_vertices] * 3
    assert plan.traces == 1 and plan._program is None
    looped = [plan(g) for g in port]
    assert plan.traces == 2
    assert_same_reports(mapped, looped)
    for g, rep in zip(port, mapped):
        np.testing.assert_array_equal(rep.colors, T.greedy_color(g))
    assert_same_reports(plan.map(port[1:]), looped[1:])
    assert plan.traces == 2 and len(calls) == 8
