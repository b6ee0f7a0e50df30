"""repro_torch's coloring models (d2, pd2) against the reference: the same
graphs, made from a numpy seed, go through ``repro.core`` and
``repro_torch.core`` (``device="cpu"``) with zero tolerance on colors,
``rounds`` and the conflicts/sweeps/frontier histories. Covered: the
lowering arrays (``d2_pairs``, ``square``, ``pd2_pairs``,
``partial_square``) and ``BipartiteGraph``'s CSR, the serial oracles and
validators, d2/pd2 x ``iterative``/``dataflow`` x all four port engines x
``lowering`` wedge/square, plans under a model, and the lowering's error
cases. The reference runs its ``bitmap`` engine (its engines are
bit-identical by its own contract); one case runs its ``fused_pallas``
kernel in interpret mode."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.distance2 as RD
import repro_torch.core as T
import repro_torch.core.distance2 as TD
from repro_torch.convert import bipartite_from_arrays

ENGINES = ["sort", "bitmap", "ell_pallas", "fused_pallas"]
ELL = ("ell_pallas", "fused_pallas")
FAMILIES = ["RMAT-ER", "RMAT-G", "RMAT-B"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(family="RMAT-G", scale=7, seed=1):
    return (R.rmat.paper_graph(family, scale, seed=seed),
            T.rmat.paper_graph(family, scale, seed=seed))


def _bipartite_edges(L=96, Rn=64, m=500, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, L, m), rng.integers(0, Rn, m)], 1)


def _bipartite(L=96, Rn=64, m=500, seed=0):
    e = _bipartite_edges(L, Rn, m, seed)
    return (R.BipartiteGraph.from_edges(L, Rn, e),
            T.BipartiteGraph.from_edges(L, Rn, e))


def assert_same_report(got, want, ctx=""):
    np.testing.assert_array_equal(got.colors, np.asarray(want.colors),
                                  err_msg=ctx)
    assert got.rounds == want.rounds, ctx
    for f in ("conflicts_per_round", "sweeps_per_round",
              "frontier_sizes_per_round"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{ctx} {f}")


def assert_same_graph(got, want):
    assert got.num_vertices == want.num_vertices
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    assert got.row_ptr.dtype == want.row_ptr.dtype
    assert got.col_idx.dtype == want.col_idx.dtype


# ----------------------------------------------------------------- lowering
@pytest.mark.parametrize("family", FAMILIES)
def test_d2_lowering_arrays_match_reference(family):
    gr, gt = _pair(family)
    for a, b in zip(TD.d2_pairs(gt), RD.d2_pairs(gr)):
        np.testing.assert_array_equal(a, b)
    assert TD.wedge_count(gt) == RD.wedge_count(gr)
    assert_same_graph(T.square(gt), R.square(gr))


@pytest.mark.parametrize("side", ["left", "right"])
def test_bipartite_and_pd2_lowering_match_reference(side):
    br, bt = _bipartite()
    for f in ("l2r_ptr", "l2r_idx", "r2l_ptr", "r2l_idx"):
        np.testing.assert_array_equal(getattr(bt, f), getattr(br, f))
        assert getattr(bt, f).dtype == getattr(br, f).dtype
    assert bt.stats() == br.stats()
    for a, b in zip(TD.pd2_pairs(bt, side), RD.pd2_pairs(br, side)):
        np.testing.assert_array_equal(a, b)
    assert_same_graph(T.partial_square(bt, side), R.partial_square(br, side))
    # duplicates dropped, out-of-range endpoints refused, as the reference
    small = T.BipartiteGraph.from_edges(4, 3, np.array(
        [[0, 0], [0, 0], [1, 0], [3, 2], [1, 1]]))
    assert small.num_edges == 4
    assert small.left_degrees().tolist() == [1, 2, 0, 1]
    with pytest.raises(ValueError, match="out of range"):
        T.BipartiteGraph.from_edges(2, 2, np.array([[0, 5]]))


def test_oracles_and_validators_match_reference():
    gr, gt = _pair("RMAT-B")
    d2 = T.greedy_color_d2(gt)
    np.testing.assert_array_equal(d2, R.greedy_color_d2(gr))
    np.testing.assert_array_equal(d2, T.greedy_color(T.square(gt)))
    assert T.validate_d2_coloring(gt, d2) and T.count_d2_conflicts(gt, d2) == 0
    d1 = T.greedy_color(gt)   # distance-1 valid, distance-2 not
    assert T.validate_d2_coloring(gt, d1) == R.validate_d2_coloring(gr, d1)
    assert T.count_d2_conflicts(gt, d1) == R.count_d2_conflicts(gr, d1) > 0
    br, bt = _bipartite()
    for side in ("left", "right"):
        p = T.greedy_color_pd2(bt, side=side)
        np.testing.assert_array_equal(p, R.greedy_color_pd2(br, side=side))
        assert T.validate_pd2_coloring(bt, p, side=side)
        ones = np.ones_like(p)
        assert not T.validate_pd2_coloring(bt, ones, side=side)
        assert (T.count_pd2_conflicts(bt, ones, side=side)
                == R.count_pd2_conflicts(br, ones, side=side) > 0)
    with pytest.raises(ValueError, match="side"):
        T.greedy_color_pd2(bt, side="up")


# ------------------------------------------------------- end to end parity
def _model_inputs(model):
    if model == "d2":
        gr, gt = _pair("RMAT-G", 7, seed=1)
        return gr, gt, gt.num_vertices
    br, bt = _bipartite()
    return br, bt, bt.num_left


@pytest.mark.parametrize("strategy", ["iterative", "dataflow"])
@pytest.mark.parametrize("model", ["d2", "pd2"])
def test_model_matches_reference(model, strategy):
    """Every port engine under both lowerings == the reference under the
    same lowering. The ELL engines need the square lowering ("auto"
    resolves to it); "wedge" with them is an error in both packages."""
    gr, gt, n = _model_inputs(model)
    kw = dict(strategy=strategy, model=model, concurrency=16)
    want = {low: R.color(gr, R.ColoringSpec(engine="bitmap", lowering=low,
                                            **kw))
            for low in ("wedge", "square")}
    for engine in ENGINES:
        for low in ("auto", "wedge", "square"):
            ctx = f"{engine} lowering={low}"
            if low == "wedge" and engine in ELL:
                with pytest.raises(ValueError, match="wedge"):
                    T.color(gt, T.ColoringSpec(engine=engine, lowering=low,
                                               **kw), device="cpu")
                continue
            got = T.color(gt, T.ColoringSpec(engine=engine, lowering=low,
                                             **kw), device="cpu")
            ref = "square" if (low == "square" or engine in ELL) else "wedge"
            assert_same_report(got, want[ref], ctx)
            assert got.colors.shape == (n,)
            if model == "d2":
                assert T.validate_d2_coloring(gt, got.colors), ctx
            else:
                assert T.validate_pd2_coloring(gt, got.colors), ctx
    # the two lowerings carry one constraint set: same colors and rounds
    np.testing.assert_array_equal(np.asarray(want["wedge"].colors),
                                  np.asarray(want["square"].colors))


@pytest.mark.parametrize("model", ["d2", "pd2"])
def test_model_with_ordering_and_right_side_matches_reference(model):
    gr, gt, _ = _model_inputs(model)
    kw = dict(strategy="iterative", model=model, concurrency=8,
              ordering="largest_first")
    if model == "pd2":
        kw["side"] = "right"
    want = R.color(gr, R.ColoringSpec(engine="bitmap", **kw))
    for engine in ("sort", "fused_pallas"):
        got = T.color(gt, T.ColoringSpec(engine=engine, **kw), device="cpu")
        assert_same_report(got, want, engine)


def test_fused_pallas_d2_matches_reference_kernel_in_interpret_mode():
    gr, gt = _pair("RMAT-ER", 6, seed=2)
    kw = dict(strategy="iterative", model="d2", concurrency=16,
              engine="fused_pallas", frontier="on")
    assert_same_report(T.color(gt, T.ColoringSpec(**kw), device="cpu"),
                       R.color(gr, R.ColoringSpec(**kw)))


@pytest.mark.parametrize("family", FAMILIES)
def test_dataflow_d2_and_pd2_equal_serial_oracles(family):
    _, gt = _pair(family, 8, seed=3)
    _, bt = _bipartite(seed=3)
    for engine in ENGINES:
        res = T.color_dataflow(gt, engine=engine, model="d2", device="cpu")
        np.testing.assert_array_equal(res.colors, T.greedy_color_d2(gt))
        res = T.color_dataflow(bt, engine=engine, model="pd2", device="cpu")
        np.testing.assert_array_equal(res.colors, T.greedy_color_pd2(bt))
    it = T.color_iterative(gt, concurrency=32, engine="ell_pallas",
                           model="d2", max_rounds=256, device="cpu")
    assert T.validate_d2_coloring(gt, it.colors)
    assert T.validate_coloring(gt, it.colors)


def test_model_plan_serves_a_family_and_matches_reference():
    """A d2 plan lowers each served graph with square; its envelope is read
    off the constraint graph, and a PlanShape taken from square(g) builds
    the same plan. The reference plan gives the same reports."""
    gs = [T.rmat.paper_graph("RMAT-G", 6, seed=s) for s in range(3)]
    sq = [T.square(g) for g in gs]
    shape = T.PlanShape(num_vertices=gs[0].num_vertices,
                        padded_edges=T.pad_bucket(
                            max(g.num_directed_edges for g in sq)),
                        max_degree=max(g.max_degree() for g in sq))
    spec = T.ColoringSpec(strategy="iterative", model="d2",
                          engine="fused_pallas", concurrency=16)
    plan = T.compile_plan(spec, shape, device="cpu")
    from_graph = T.compile_plan(spec, gs[0], device="cpu")
    assert from_graph.statics == T.PlanShape(
        sq[0].num_vertices, T.pad_bucket(sq[0].num_directed_edges),
        sq[0].max_degree())
    reports = [plan(g) for g in gs]
    assert plan.traces == 1
    ref = R.compile_plan(R.ColoringSpec(**{**spec.to_dict(),
                                           "engine": "bitmap"}),
                         R.PlanShape(shape.num_vertices, shape.padded_edges,
                                     shape.max_degree))
    for g, s2, rep in zip(gs, sq, reports):
        assert T.validate_d2_coloring(g, rep.colors)
        # the constraint graph as d1 is what color() runs under d2
        d1 = T.color(s2, spec, device="cpu", model="d1")
        np.testing.assert_array_equal(d1.colors, rep.colors)
        assert_same_report(rep, ref(R.Graph(g.num_vertices, g.row_ptr,
                                            g.col_idx)))
    for one, many in zip(reports, plan.map(gs)):
        assert_same_report(many, one)
    # pd2 plans read their envelope off the partial square of the side
    br, bt = _bipartite()
    pplan = T.compile_plan(T.ColoringSpec(model="pd2", side="right",
                                          engine="bitmap"), bt, device="cpu")
    assert pplan.statics.num_vertices == bt.num_right
    assert_same_report(pplan(bt), R.compile_plan(
        R.ColoringSpec(model="pd2", side="right", engine="bitmap"), br)(br))


def test_carried_bipartite_graph_colors_the_same():
    br, _ = _bipartite(seed=5)
    bt = bipartite_from_arrays(br.num_left, br.num_right, br.l2r_ptr,
                               br.l2r_idx, br.r2l_ptr, br.r2l_idx)
    kw = dict(strategy="iterative", model="pd2", concurrency=4)
    assert_same_report(
        T.color(bt, T.ColoringSpec(engine="ell_pallas", **kw), device="cpu"),
        R.color(br, R.ColoringSpec(engine="bitmap", lowering="square", **kw)))


def test_degenerate_model_inputs_color_trivially():
    empty = np.zeros((0, 2), np.int64)
    bt = T.BipartiteGraph.from_edges(5, 3, empty)
    br = R.BipartiteGraph.from_edges(5, 3, empty)
    for side, n in (("left", 5), ("right", 3)):
        spec = dict(model="pd2", side=side)
        got = T.color(bt, T.ColoringSpec(**spec), device="cpu")
        assert got.colors.tolist() == [1] * n and got.rounds == 0
        np.testing.assert_array_equal(
            got.colors, R.color(br, R.ColoringSpec(**spec)).colors)
    g = T.Graph.from_edges(4, empty)
    assert T.color(g, model="d2", device="cpu").colors.tolist() == [1] * 4


# --------------------------------------------------------------- errors
def _raise_same(call_t, call_r):
    with pytest.raises(Exception) as et:
        call_t()
    with pytest.raises(Exception) as er:
        call_r()
    assert type(et.value) is type(er.value)
    assert str(et.value) == str(er.value)


@pytest.mark.parametrize("case", [
    "device_graph_d2", "device_graph_pd2", "graph_pd2", "bipartite_d1",
    "unknown_model", "wedge_ell", "wedge_pad", "unknown_strategy",
    "wrong_type", "host_graph_wrong_type", "host_bipartite_d2",
    "host_graph_pd2", "bad_side"])
def test_lowering_error_cases_match_reference(case):
    gr, gt = _pair("RMAT-ER", 6, seed=0)
    br, bt = _bipartite()
    calls = {
        "device_graph_d2": lambda m, g, b: m.as_constraint_graph(
            g.to_device(**({"device": "cpu"} if m is TD else {})), "d2"),
        "device_graph_pd2": lambda m, g, b: m.as_constraint_graph(
            g.to_device(**({"device": "cpu"} if m is TD else {})), "pd2"),
        "graph_pd2": lambda m, g, b: m.as_constraint_graph(g, "pd2"),
        "bipartite_d1": lambda m, g, b: m.as_constraint_graph(b, "d1"),
        "unknown_model": lambda m, g, b: m.as_constraint_graph(g, "d3"),
        "wedge_ell": lambda m, g, b: m.d2_device_graph(
            g, strategy="wedge", layout=("edges", "ell")),
        "wedge_pad": lambda m, g, b: m.pd2_device_graph(
            b, strategy="wedge", pad_edges_to=4096),
        "unknown_strategy": lambda m, g, b: m.d2_device_graph(
            g, strategy="cube"),
        "wrong_type": lambda m, g, b: m.as_constraint_graph(
            np.zeros((3, 2)), "d1"),
        "host_graph_wrong_type": lambda m, g, b: m.constraint_host_graph(
            [1, 2], "d2"),
        "host_bipartite_d2": lambda m, g, b: m.constraint_host_graph(b, "d2"),
        "host_graph_pd2": lambda m, g, b: m.constraint_host_graph(g, "pd2"),
        "bad_side": lambda m, g, b: m.pd2_pairs(b, "middle"),
    }
    fn = calls[case]
    _raise_same(lambda: fn(TD, gt, bt), lambda: fn(RD, gr, br))


def test_spec_lowering_and_side_round_trip_both_packages():
    ref = R.ColoringSpec(strategy="dataflow", model="pd2", lowering="wedge",
                         side="right", engine="bitmap")
    spec = T.ColoringSpec.from_dict(ref.to_dict())
    assert spec.to_dict() == ref.to_dict()
    with pytest.raises(ValueError, match="unknown lowering"):
        T.ColoringSpec(lowering="cube")
    with pytest.raises(ValueError, match="unknown coloring model"):
        T.ColoringSpec(model="d3")
