"""repro_torch's streaming slice against the reference: ``Graph`` edge
deltas (``apply_delta``/``delta_info``/``has_edges``), the ``"recolor"``
strategy (cold == ``"iterative"``; a warm start through ``plan(g,
colors=, seed=)``), and ``DynamicColoring`` (a sequence of
``apply_batch`` calls, ``state_dict``/``from_state`` across both
packages, envelope rebuilds and roll-back). The same deltas, made from a
numpy seed, go through ``repro.core`` and ``repro_torch.core``
(``device="cpu"``); colors, ``DeltaReport`` fields, ``rounds`` and every
history must be equal. The reference runs its ``bitmap`` engine, the port
all four."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T

ENGINES = ["sort", "bitmap", "ell_pallas", "fused_pallas"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(family="RMAT-G", scale=8, seed=0):
    return (R.rmat.paper_graph(family, scale, seed=seed),
            T.rmat.paper_graph(family, scale, seed=seed))


def _deltas(graph, k, n_ins, n_del, seed=1):
    """k delta batches from a numpy seed; deletes sample the original edge
    set (re-deletes are no-ops), inserts are random pairs (duplicates, self
    loops and present edges included)."""
    rng = np.random.default_rng(seed)
    V = graph.num_vertices
    base = graph.undirected_edges()
    return [(np.stack([rng.integers(0, V, n_ins),
                       rng.integers(0, V, n_ins)], 1),
             base[rng.integers(0, base.shape[0], n_del)])
            for _ in range(k)]


def assert_same_report(got, want, ctx=""):
    np.testing.assert_array_equal(got.colors, np.asarray(want.colors),
                                  err_msg=ctx)
    assert got.rounds == want.rounds, ctx
    for f in ("conflicts_per_round", "sweeps_per_round",
              "frontier_sizes_per_round"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{ctx} {f}")


def assert_same_delta(got, want, ctx=""):
    assert (got.inserted, got.deleted, got.seed_size, got.repaired) == \
        (want.inserted, want.deleted, want.seed_size, want.repaired), ctx
    if want.report is not None:
        assert_same_report(got.report, want.report, ctx)


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ----------------------------------------------------------- graph deltas
def test_delta_set_semantics_match_reference():
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    gt, gr = T.Graph.from_edges(6, edges), R.Graph.from_edges(6, edges)
    cases = [
        dict(inserts=[[3, 4], [4, 3], [5, 5], [0, 1]],
             deletes=[[1, 2], [2, 1], [0, 5]]),
        dict(inserts=[[0, 1]], deletes=[[0, 1]]),  # both lists: present
        dict(inserts=None, deletes=[[2, 3]]),
        dict(inserts=np.zeros((0, 2), np.int64), deletes=None),
    ]
    for kw in cases:
        (a, pa, na), (b, pb, nb) = gt.delta_info(**kw), gr.delta_info(**kw)
        np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
        np.testing.assert_array_equal(a.col_idx, b.col_idx)
        np.testing.assert_array_equal(pa, pb)
        assert na == nb
    g2 = gt.apply_delta(**cases[0])
    assert set(map(tuple, g2.undirected_edges())) == {(0, 1), (2, 3), (3, 4)}
    assert (0, 1) in set(map(tuple, gt.apply_delta(**cases[1])
                             .undirected_edges()))
    with pytest.raises(ValueError, match="out of range"):
        gt.apply_delta(inserts=[[0, 6]])
    probe = [[1, 0], [0, 2], [3, 2], [4, 4]]
    assert gt.has_edges(probe).tolist() == [True, False, True, False]
    assert gt.has_edges(np.zeros((0, 2), np.int64)).shape == (0,)


@pytest.mark.parametrize("family", ["RMAT-ER", "RMAT-B"])
def test_random_deltas_match_reference(family):
    gr, gt = _pair(family, 8, seed=2)
    np.testing.assert_array_equal(gt.undirected_edges(), gr.undirected_edges())
    for ins, dels in _deltas(gt, 3, 200, 120, seed=3):
        (a, pa, na), (b, pb, nb) = (gt.delta_info(ins, dels),
                                    gr.delta_info(ins, dels))
        np.testing.assert_array_equal(a.col_idx, b.col_idx)
        np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
        np.testing.assert_array_equal(pa, pb)
        assert na == nb
        np.testing.assert_array_equal(gt.has_edges(ins), gr.has_edges(ins))
        gt, gr = a, b


# ------------------------------------------------------ recolor strategy
@pytest.mark.parametrize("engine", ENGINES)
def test_cold_recolor_equals_iterative_and_reference(engine):
    gr, gt = _pair()
    kw = dict(engine=engine, concurrency=16)
    it = T.color(gt, T.ColoringSpec(strategy="iterative", **kw), device="cpu")
    rc = T.color(gt, T.ColoringSpec(strategy="recolor", **kw), device="cpu")
    np.testing.assert_array_equal(rc.colors, it.colors)
    assert rc.rounds == it.rounds
    np.testing.assert_array_equal(rc.conflicts_per_round,
                                  it.conflicts_per_round)
    assert_same_report(rc, _reference_cold(gr))


_REF_CACHE = {}


def _reference_cold(gr):
    if "cold" not in _REF_CACHE:
        _REF_CACHE["cold"] = R.color(gr, R.ColoringSpec(
            strategy="recolor", engine="bitmap", concurrency=16))
    return _REF_CACHE["cold"]


@pytest.mark.parametrize("frontier", ["auto", "off"])
def test_warm_start_matches_reference(frontier):
    """plan(g, colors=, seed=) under every port engine == the reference's:
    round 0 takes the frontier path when the seed fits (``frontier="auto"``)
    and the full path otherwise."""
    gr, gt = _pair("RMAT-ER", 8, seed=5)
    base = T.color(gt, T.ColoringSpec(strategy="iterative", concurrency=16),
                   device="cpu").colors
    rng = np.random.default_rng(7)
    seed = np.zeros(gt.num_vertices, bool)
    seed[rng.integers(0, gt.num_vertices, 12)] = True
    colors = base.copy()
    colors[seed] = 1   # plant conflicts inside the seed
    spec = dict(strategy="recolor", concurrency=16, frontier=frontier)
    want = R.compile_plan(R.ColoringSpec(engine="bitmap", **spec), gr)(
        gr, colors=colors, seed=seed)
    if frontier == "auto":
        assert want.frontier_sizes_per_round[0] == seed.sum()
    for engine in ENGINES:
        plan = T.compile_plan(T.ColoringSpec(engine=engine, **spec), gt,
                              device="cpu")
        got = plan(gt, colors=colors, seed=seed)
        assert_same_report(got, want, engine)
        np.testing.assert_array_equal(got.colors[~seed], colors[~seed])
        assert T.validate_coloring(gt, got.colors)
        # an empty seed passes the colors through in zero rounds
        none = plan(gt, colors=colors, seed=np.zeros_like(seed))
        assert none.rounds == 0
        np.testing.assert_array_equal(none.colors, colors)
        assert plan.traces == 1


def test_recolor_plan_state_validation():
    g = T.rmat.paper_graph("RMAT-G", 7, seed=0)
    plan = T.compile_plan(T.ColoringSpec(strategy="recolor"), g, device="cpu")
    with pytest.raises(ValueError, match="colors shape"):
        plan(g, colors=np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="seed shape"):
        plan(g, seed=np.zeros(3, bool))
    with pytest.raises(NotImplementedError, match="plan.map"):
        plan.map([g])
    it_plan = T.compile_plan(T.ColoringSpec(strategy="iterative"), g,
                             device="cpu")
    with pytest.raises(TypeError, match="no per-call state"):
        it_plan(g, colors=np.zeros(g.num_vertices, np.int32))
    ord_plan = T.compile_plan(
        T.ColoringSpec(strategy="recolor", ordering="largest_first"), g,
        device="cpu")
    with pytest.raises(ValueError, match="natural"):
        ord_plan(g, colors=np.ones(g.num_vertices, np.int32))
    assert T.validate_coloring(g, ord_plan(g).colors)


def test_degenerate_plan_preserves_warm_start_colors():
    ge = T.Graph.from_edges(5, np.zeros((0, 2), np.int64))
    plan = T.compile_plan(T.ColoringSpec(strategy="recolor"), ge,
                          device="cpu")
    prev = np.array([5, 7, 5, 2, 9], np.int32)
    np.testing.assert_array_equal(
        plan(ge, colors=prev, seed=np.zeros(5, bool)).colors, prev)
    np.testing.assert_array_equal(
        plan(ge, colors=np.array([3, 0, 0, 0, 4], np.int32)).colors,
        [3, 1, 1, 1, 4])


# ------------------------------------------------------- dynamic coloring
@pytest.fixture(scope="module")
def reference_stream():
    """The reference's DynamicColoring over 4 batches: its reports, its
    state after each batch, and the deltas."""
    gr, gt = _pair("RMAT-G", 8, seed=0)
    deltas = _deltas(gt, 4, 60, 40, seed=1)
    dyn = R.DynamicColoring(gr, R.ColoringSpec(
        strategy="recolor", engine="bitmap", concurrency=32))
    out = {"cold": dyn.colors.copy(), "reports": [], "states": []}
    for ins, dels in deltas:
        out["reports"].append(dyn.apply_batch(inserts=ins, deletes=dels))
        out["states"].append(dyn.state_dict())
    out["traces"], out["recompiles"] = dyn.plan.traces, dyn.recompiles
    return gt, deltas, out


@pytest.mark.parametrize("engine", ENGINES)
def test_apply_batch_sequence_matches_reference(engine, reference_stream):
    gt, deltas, ref = reference_stream
    dyn = T.DynamicColoring(gt, T.ColoringSpec(
        strategy="recolor", engine=engine, concurrency=32), device="cpu")
    np.testing.assert_array_equal(dyn.colors, ref["cold"])
    for i, (ins, dels) in enumerate(deltas):
        dr = dyn.apply_batch(inserts=ins, deletes=dels)
        assert_same_delta(dr, ref["reports"][i], f"{engine} batch {i}")
        assert 0 <= dr.host_s <= dr.wall_time_s
        assert T.validate_coloring(dyn.graph, dyn.colors)
        assert int(dyn.colors.max()) <= dyn.color_bound
        assert_same_state(dyn.state_dict(), ref["states"][i])
    assert any(r.repaired for r in ref["reports"])
    assert (dyn.plan.traces, dyn.recompiles) == (1, ref["recompiles"])


@pytest.mark.parametrize("direction", ["torch->torch", "reference->torch"])
def test_from_state_resumes_bit_identically(direction, reference_stream):
    """A stream rebuilt from a state dict (this package's or the
    reference's) after batch 1 gives batches 2-3 exactly as the unkilled
    reference stream did, without rerunning the cold start."""
    gt, deltas, ref = reference_stream
    spec = T.ColoringSpec(strategy="recolor", engine="fused_pallas",
                          concurrency=32)
    if direction == "reference->torch":
        state = ref["states"][1]
    else:
        dyn = T.DynamicColoring(gt, spec, device="cpu")
        for ins, dels in deltas[:2]:
            dyn.apply_batch(inserts=ins, deletes=dels)
        state = dyn.state_dict()
        assert_same_state(state, ref["states"][1])
    back = T.DynamicColoring.from_state(state, spec, device="cpu")
    assert back.plan.traces == 0   # no cold start ran
    for i in (2, 3):
        dr = back.apply_batch(*deltas[i])
        assert_same_delta(dr, ref["reports"][i], f"batch {i}")
        assert_same_state(back.state_dict(), ref["states"][i])


def test_torch_state_resumes_in_the_reference(reference_stream):
    gt, deltas, ref = reference_stream
    dyn = T.DynamicColoring(gt, T.ColoringSpec(
        strategy="recolor", engine="sort", concurrency=32), device="cpu")
    for ins, dels in deltas[:3]:
        dyn.apply_batch(inserts=ins, deletes=dels)
    back = R.DynamicColoring.from_state(dyn.state_dict(), R.ColoringSpec(
        strategy="recolor", engine="bitmap", concurrency=32))
    dr = back.apply_batch(*deltas[3])
    assert_same_delta(dyn.apply_batch(*deltas[3]), dr)
    np.testing.assert_array_equal(back.colors, ref["states"][3]["colors"])


def test_envelope_growth_and_pinned_overflow_match_reference():
    """A batch past the envelope rebuilds the plan (``recompiles``) in both
    packages alike; a pinned envelope raises and leaves graph, colors and
    max_degree_seen unchanged."""
    edges = np.array([[i, i + 1] for i in range(40)])
    hub = np.stack([np.zeros(40, np.int64), 8 + np.arange(40) % 56], 1)
    rng = np.random.default_rng(0)
    extra = np.stack([rng.integers(0, 64, 600), rng.integers(0, 64, 600)], 1)
    dyn_t = T.DynamicColoring(T.Graph.from_edges(64, edges),
                              edge_headroom=1.05, device="cpu")
    dyn_r = R.DynamicColoring(R.Graph.from_edges(64, edges),
                              edge_headroom=1.05)
    st0 = dyn_t.plan.statics
    for batch in (hub, extra):
        assert_same_delta(dyn_t.apply_batch(inserts=batch),
                          dyn_r.apply_batch(inserts=batch))
        assert dyn_t.recompiles == dyn_r.recompiles
        assert_same_state(dyn_t.state_dict(), dyn_r.state_dict())
    assert dyn_t.recompiles >= 1 and dyn_t.plan.statics != st0

    g = T.Graph.from_edges(64, edges)
    pinned = T.DynamicColoring(g, plan_shape=T.PlanShape(
        num_vertices=64, padded_edges=T.pad_bucket(g.num_directed_edges),
        max_degree=g.max_degree() + 2), device="cpu")
    before = (pinned.graph, pinned.colors.copy(), pinned.max_degree_seen)
    with pytest.raises(ValueError, match="outgrew the pinned"):
        pinned.apply_batch(inserts=extra)
    assert pinned.graph is before[0]
    np.testing.assert_array_equal(pinned.colors, before[1])
    assert pinned.max_degree_seen == before[2]


def test_failed_repair_rolls_back():
    dyn = T.DynamicColoring(T.rmat.paper_graph("RMAT-G", 7, seed=0),
                            device="cpu")
    graph_before, colors_before = dyn.graph, dyn.colors.copy()
    seen_before = dyn.max_degree_seen

    class BoomPlan:  # statics intact: the envelope check passes first
        statics = dyn.plan.statics

        def __call__(self, *a, **k):
            raise RuntimeError("did not converge")

    dyn._plan = BoomPlan()
    vals, counts = np.unique(colors_before, return_counts=True)
    u, v = np.where(colors_before == vals[np.argmax(counts)])[0][:2]
    with pytest.raises(RuntimeError, match="converge"):
        dyn.apply_batch(inserts=[[int(u), int(v)]])
    assert dyn.graph is graph_before
    assert dyn.max_degree_seen == seen_before
    np.testing.assert_array_equal(dyn.colors, colors_before)


def test_stream_edge_cases():
    g = T.rmat.paper_graph("RMAT-G", 7, seed=0)
    dyn = T.DynamicColoring(g, device="cpu")
    before = dyn.colors.copy()
    cur = dyn.graph.undirected_edges()
    dr = dyn.apply_batch(deletes=cur[:40])      # deletes only relax
    assert not dr.repaired and dr.deleted == 40
    e = dyn.graph.undirected_edges()[0]
    dr = dyn.apply_batch(inserts=[e, e, [e[1], e[0]], [0, 0]],
                         deletes=[[e[0], e[0]]])
    assert (dr.inserted, dr.deleted, dr.seed_size) == (0, 0, 0)
    np.testing.assert_array_equal(dyn.colors, before)
    full = dyn.recolor_full()
    assert T.validate_coloring(dyn.graph, full.colors)
    empty = T.DynamicColoring(T.Graph.from_edges(16, np.zeros((0, 2))),
                              device="cpu")
    assert np.all(empty.colors == 1)
    assert empty.apply_batch(inserts=[[0, 1], [1, 2], [0, 2]]).inserted == 3
    assert empty.num_colors == 3
    with pytest.raises(ValueError, match="recolor"):
        T.DynamicColoring(g, T.ColoringSpec(strategy="iterative"),
                          device="cpu")
    with pytest.raises(ValueError, match="distance-1"):
        T.DynamicColoring(g, T.ColoringSpec(strategy="recolor", model="d2"),
                          device="cpu")
    with pytest.raises(ValueError, match="natural"):
        T.DynamicColoring(g, T.ColoringSpec(strategy="recolor",
                                            ordering="random"), device="cpu")
