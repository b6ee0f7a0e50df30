"""repro_torch host layer, device layout and engine machinery against the
reference package, on the same numpy inputs: graphs and R-MAT (same seed,
same CSR), orderings, greedy, metrics, the device layout, segment_mex, each
engine's ``bind``/``bind_slab`` mex (inert ``key_v == V`` included),
``speculation_conflicts``/``frontier_conflicts`` through the conflict
kernel, the frontier compaction, and the sweep loop. Exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro.core.engine as RE
import repro.core.frontier as RF
from repro.core import mex as RM
import repro_torch.core as T
import repro_torch.core.engine as TE
import repro_torch.core.frontier as TF
from repro_torch.convert import device_graph_from_arrays, graph_from_arrays
from repro_torch.core import mex as TM

FAMILIES = ["RMAT-ER", "RMAT-G", "RMAT-B"]
ENGINES = ["sort", "bitmap", "ell_pallas", "fused_pallas"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the graphs here are tiny: intra-op threads only contend with the
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def graphs():
    return {f: (R.rmat.paper_graph(f, 8, seed=2), T.rmat.paper_graph(f, 8, seed=2))
            for f in FAMILIES}


# ------------------------------------------------------------- host layer
@pytest.mark.parametrize("family", FAMILIES)
def test_rmat_same_seed_same_graph(family, graphs):
    gr, gt = graphs[family]
    np.testing.assert_array_equal(gt.row_ptr, gr.row_ptr)
    np.testing.assert_array_equal(gt.col_idx, gr.col_idx)
    assert gt.stats() == gr.stats()
    np.testing.assert_array_equal(T.greedy_color(gt), R.greedy_color(gr))


def test_rmat_chunked_draws_equal_one_shot(monkeypatch):
    monkeypatch.setattr(T.rmat, "_CHUNK_ROWS", 1000)
    np.testing.assert_array_equal(
        T.rmat.rmat_edges(9, 8, T.rmat.RMAT_G, seed=5),
        R.rmat.rmat_edges(9, 8, R.rmat.RMAT_G, seed=5))


def test_from_edges_and_relabel_match_reference():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 50, size=(400, 2))  # dups, self loops, both ways
    gr, gt = R.Graph.from_edges(50, edges), T.Graph.from_edges(50, edges)
    np.testing.assert_array_equal(gt.row_ptr, gr.row_ptr)
    np.testing.assert_array_equal(gt.col_idx, gr.col_idx)
    perm = rng.permutation(50)
    np.testing.assert_array_equal(gt.relabel(perm).col_idx,
                                  gr.relabel(perm).col_idx)
    for a, b in zip(gt.to_ell(), gr.to_ell()):
        np.testing.assert_array_equal(a, b)
    empty = T.Graph.from_edges(5, np.zeros((0, 2)))
    assert empty.num_directed_edges == 0 and empty.row_ptr.shape == (6,)


@pytest.mark.parametrize("name", ["natural", "random", "largest_first",
                                  "smallest_last"])
def test_orderings_match_reference(name, graphs):
    gr, gt = graphs["RMAT-G"]
    np.testing.assert_array_equal(T.ordering.ORDERINGS[name](gt, 3),
                                  R.ordering.ORDERINGS[name](gr, 3))


def test_metrics_match_reference(graphs):
    gr, gt = graphs["RMAT-B"]
    rng = np.random.default_rng(1)
    for colors in (R.greedy_color(gr), rng.integers(0, 4, gr.num_vertices)):
        assert T.validate_coloring(gt, colors) == R.validate_coloring(gr, colors)
        assert T.count_conflicts(gt, _t(colors)) == R.count_conflicts(gr, colors)
        assert T.num_colors(colors) == R.num_colors(colors)


def test_pad_bucket_matches_reference():
    for n in [-1, 0, 1, 255, 256, 257, 1000, 4097, 10 ** 6 + 3]:
        assert T.pad_bucket(n) == R.graph.pad_bucket(n)
        assert T.pad_bucket(n, min_bucket=8) == R.graph.pad_bucket(n, min_bucket=8)


# the layout's edge cases beside the R-MAT graphs: isolated vertices, runs
# of empty rows and an empty last row; no vertex; no edge
LAYOUT_GRAPHS = {
    "isolated": (12, [(1, 3), (3, 4), (1, 4), (6, 7), (2, 9)]),
    "V0": (0, np.zeros((0, 2), np.int64)),
    "E0": (5, np.zeros((0, 2), np.int64)),
}
LAYOUT_FIELDS = ("src", "dst", "row_ptr", "col_idx", "ell_slot", "inc_ptr")
LAYOUT_CASES = [
    (graph, pad, layout, narrow)
    for graph in ("RMAT-ER", "RMAT-G", *LAYOUT_GRAPHS)
    for pad in (False, True)
    for layout in ("edges", ("edges", "ell"), ("edges", "csr", "ell"))
    for narrow in ((False, True) if "ell" in layout else (False,))
    if not narrow or graph in ("RMAT-G", "isolated")]


def _layout_id(case):
    graph, pad, layout, narrow = case
    layout = "+".join((layout,) if isinstance(layout, str) else layout)
    return (f"{graph}-{'pad' if pad else 'nopad'}-{layout}"
            + ("-narrow" if narrow else ""))


def _layout_graphs(graph, graphs):
    if graph in graphs:
        return graphs[graph]
    v, edges = LAYOUT_GRAPHS[graph]
    return R.Graph.from_edges(v, edges), T.Graph.from_edges(v, edges)


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=_layout_id)
def test_device_layout_matches_reference(case, graphs):
    """The port's ``to_device`` (the CSR expanded by ``csr_layout`` on the
    CPU) equals the reference's numpy layout, field by
    field: padded or not, each layout, and an ELL width below the max
    degree (rows cut into the sink column)."""
    graph, pad, layout, narrow = case
    gr, gt = _layout_graphs(graph, graphs)
    assert not narrow or gr.max_degree() >= 2
    kw = dict(layout=layout,
              pad_edges_to=(T.pad_bucket(max(1, gr.num_directed_edges))
                            if pad else None),
              ell_width=gr.max_degree() // 2 if narrow else None)
    dr, dt = gr.to_device(**kw), gt.to_device(**kw, device="cpu")
    for f in LAYOUT_FIELDS:
        got, want = getattr(dt, f), getattr(dr, f)
        if want is None:
            assert got is None, f
            continue
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), f)
    for f in ("num_vertices", "num_directed_edges", "max_degree", "ell_width",
              "padded_edges", "has_ell", "has_frontier", "has_csr"):
        assert getattr(dt, f) == getattr(dr, f), f
    if layout != ("edges", "csr", "ell"):
        return
    # the carry-across function rebuilds the identical layout
    fields = {f: np.asarray(getattr(dr, f)) for f in LAYOUT_FIELDS}
    fields.update({f: getattr(dr, f) for f in ("num_vertices", "max_degree",
                                               "num_directed_edges", "ell_width")})
    dc = device_graph_from_arrays(fields, device="cpu")
    for f in LAYOUT_FIELDS:
        assert torch.equal(getattr(dc, f), getattr(dt, f)), f
    hc = graph_from_arrays(gr.num_vertices, gr.row_ptr, gr.col_idx)
    np.testing.assert_array_equal(hc.col_idx, gt.col_idx)


def test_to_device_without_a_card_raises(monkeypatch, graphs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = graphs["RMAT-ER"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.to_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_graph_from_arrays({"src": [0], "dst": [0], "num_vertices": 1,
                                  "num_directed_edges": 0, "max_degree": 0,
                                  "ell_width": 0})


# ------------------------------------------------------------ mex engines
def test_segment_mex_matches_reference():
    rng = np.random.default_rng(3)
    V = 40
    v = rng.integers(0, V + 1, 500).astype(np.int32)   # V = inert padding
    c = rng.integers(0, 9, 500).astype(np.int32)
    v = np.concatenate([v, np.arange(V, dtype=np.int32)])
    c = np.concatenate([c, np.zeros(V, np.int32)])
    np.testing.assert_array_equal(
        TM.segment_mex(_t(v), _t(c), V).numpy(),
        np.asarray(RM.segment_mex(jnp.asarray(v), jnp.asarray(c), V)))


def _sweep_inputs(gr, seed):
    """(key_v, key_c) over a graph's padded edge list: a random subset of
    edges forbids (the rest are inert, key_v == V), colors up to Delta+3."""
    dr = gr.to_device(layout=("edges", "ell"),
                      pad_edges_to=T.pad_bucket(gr.num_directed_edges))
    rng = np.random.default_rng(seed)
    src = np.asarray(dr.src)
    live = rng.random(src.shape[0]) < 0.7
    key_v = np.where(live, src, gr.num_vertices).astype(np.int32)
    key_c = rng.integers(0, gr.max_degree() + 4, src.shape[0]).astype(np.int32)
    return dr, key_v, key_c


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("family", ["RMAT-ER", "RMAT-B"])
def test_engine_bind_matches_reference(engine, family, graphs):
    gr, gt = graphs[family]
    dr, key_v, key_c = _sweep_inputs(gr, 7)
    dt = gt.to_device(layout=("edges", "ell"),
                      pad_edges_to=T.pad_bucket(gt.num_directed_edges),
                      device="cpu")
    kw = dict(num_vertices=gr.num_vertices, max_colors=gr.max_degree() + 1,
              ell_width=dr.ell_width, max_degree=gr.max_degree())
    want = RE.get_backend(engine).bind(ell_slot=dr.ell_slot, **kw)(
        jnp.asarray(key_v), jnp.asarray(key_c))
    got = TE.get_backend(engine).bind(ell_slot=dt.ell_slot, **kw)(
        _t(key_v), _t(key_c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _slab_inputs(cap, width, seed):
    """A compacted slab: row r owns slots 0..deg_r-1; pad entries point at
    the sink row ``cap`` with slot 0."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, width + 1, cap)
    rows = np.repeat(np.arange(cap), deg)
    slot = np.concatenate([np.arange(d) for d in deg]) if deg.sum() else \
        np.zeros(0, np.int64)
    pad = 17
    key_v = np.concatenate([rows, np.full(pad, cap)]).astype(np.int32)
    slot = np.concatenate([slot, np.zeros(pad)]).astype(np.int32)
    live = rng.random(key_v.shape[0]) < 0.8
    key_v = np.where(live, key_v, cap).astype(np.int32)
    key_c = rng.integers(0, width + 3, key_v.shape[0]).astype(np.int32)
    return key_v, key_c, slot


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_bind_slab_matches_reference(engine):
    cap, width = 24, 30
    key_v, key_c, slot = _slab_inputs(cap, width, 11)
    kw = dict(capacity=cap, max_colors=width + 1, ell_width=width,
              max_degree=width)
    want = RE.get_backend(engine).bind_slab(**kw)(
        jnp.asarray(key_v), jnp.asarray(key_c), jnp.asarray(slot))
    got = TE.get_backend(engine).bind_slab(**kw)(_t(key_v), _t(key_c), _t(slot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_registry_and_bind_guards_match_reference():
    assert T.available_backends() == R.available_backends()
    for m in [1, 30, 31, 62, 1999]:
        assert TE.num_color_words(m) == RE.num_color_words(m)
    with pytest.raises(ValueError, match="packed-entry color field"):
        TE.get_backend("bitmap").bind(num_vertices=4, max_colors=1 << 28)
    with pytest.raises(ValueError, match="words=1"):
        TE.BitmapMexBackend(words=1).bind(num_vertices=4, max_colors=40)
    with pytest.raises(ValueError, match="static color bound"):
        TE.get_backend("fused_pallas").bind(
            num_vertices=4, max_colors=0, ell_slot=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="below the graph's max degree"):
        TE.get_backend("ell_pallas").bind(
            num_vertices=4, max_colors=10, ell_slot=torch.zeros(1, dtype=torch.int32),
            ell_width=3, max_degree=9)
    with pytest.raises(ValueError, match="ELL layout"):
        TE.get_backend("ell_pallas").bind(num_vertices=4, max_colors=10)


# ------------------------------------------------- speculation machinery
def test_speculation_conflicts_matches_reference(graphs):
    gr, gt = graphs["RMAT-ER"]
    dr = gr.to_device(pad_edges_to=T.pad_bucket(gr.num_directed_edges))
    rng = np.random.default_rng(5)
    V = gr.num_vertices
    for trial in range(3):
        colors = rng.integers(1, 4, V).astype(np.int32)  # phase 1: >= 1
        pending = rng.random(V) < (0.3, 0.8, 1.0)[trial]
        want = RE.speculation_conflicts(dr.src, dr.dst, jnp.asarray(colors),
                                        jnp.asarray(pending), V)
        got = TE.speculation_conflicts(_t(dr.src), _t(dr.dst), _t(colors),
                                       _t(pending), V)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("caps", [(64, 1024), (8, 40)])  # fits / overflows
def test_compact_frontier_and_conflicts_match_reference(caps, graphs):
    gr, gt = graphs["RMAT-G"]
    dr = gr.to_device()
    dt = gt.to_device(device="cpu")
    rng = np.random.default_rng(caps[0])
    V = gr.num_vertices
    active = rng.random(V) < 0.1
    cap_v, cap_e = caps
    want = RF.compact_frontier(jnp.asarray(active), dr.inc_ptr, dr.dst,
                               cap_v, cap_e)
    got = TF.compact_frontier(_t(active), dt.inc_ptr, dt.dst, cap_v, cap_e)
    for f in want._fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    for a, b in zip(TF.frontier_counts(_t(active), dt.inc_ptr),
                    RF.frontier_counts(jnp.asarray(active), dr.inc_ptr)):
        assert int(a) == int(b)
    cpad = np.concatenate([rng.integers(1, 4, V), [0]]).astype(np.int32)
    ppad = np.concatenate([active, [False]])
    np.testing.assert_array_equal(
        TF.frontier_conflicts(got, _t(cpad), _t(ppad), V).numpy(),
        np.asarray(RF.frontier_conflicts(want, jnp.asarray(cpad),
                                         jnp.asarray(ppad), V)))


def test_compact_frontier_without_edges():
    """E = 0: an empty slab, ``nv`` the active count and ``ne = 0``."""
    active = torch.tensor([True, False, True])
    slab = TF.compact_frontier(active, torch.zeros(4, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32), 8, 8)
    assert int(slab.nv) == 2 and int(slab.ne) == 0
    assert slab.vert.tolist()[:3] == [0, 2, 3]
    assert (slab.owner == 8).all() and (slab.src == 3).all()
    assert (slab.dst == 3).all() and (slab.slot == 0).all()


def test_offsets_slots_capacities_match_reference(graphs):
    gr, gt = graphs["RMAT-B"]
    rng = np.random.default_rng(9)
    pending = rng.random(gr.num_vertices) < 0.4
    for conc in [1, 7, 64, gr.num_vertices]:
        np.testing.assert_array_equal(
            TE.lockstep_offsets(_t(pending), conc).numpy(),
            np.asarray(RE.lockstep_offsets(jnp.asarray(pending), conc)))
    dr = gr.to_device(pad_edges_to=T.pad_bucket(gr.num_directed_edges))
    np.testing.assert_array_equal(
        TE.edge_slots(_t(dr.src), gr.num_vertices).numpy(),
        np.asarray(RE.edge_slots(dr.src, gr.num_vertices)))
    for args in [(256, 4000, 30), (10 ** 5, 1600000, 800), (0, 5, 1), (9, 0, 1)]:
        assert TF.frontier_capacities(*args) == RF.frontier_capacities(*args)
        assert TF.frontier_capacities(*args, capacity=16) == \
            RF.frontier_capacities(*args, capacity=16)
    for mode in ["auto", "on", "off"]:
        kw = dict(num_vertices=256, padded_edges=4000, max_degree=30,
                  has_inc=True)
        assert TF.resolve_frontier(mode, 0, **kw) == \
            RF.resolve_frontier(mode, 0, **kw)
    with pytest.raises(ValueError, match="incident-edge"):
        TF.resolve_frontier("on", 0, num_vertices=4, padded_edges=4,
                            max_degree=1, has_inc=False)


@pytest.mark.parametrize("engine", ENGINES)
def test_fixpoint_sweep_matches_reference(engine, graphs):
    """The DATAFLOW equations through each engine: same fixpoint, same
    sweep count (the final no-change sweep included)."""
    gr, gt = graphs["RMAT-G"]
    dr = gr.to_device(layout=("edges", "ell"))
    dt = gt.to_device(layout=("edges", "ell"), device="cpu")
    V = gr.num_vertices
    kw = dict(num_vertices=V, max_colors=gr.max_degree() + 1,
              ell_width=dr.ell_width, max_degree=gr.max_degree())

    def run(E, dg, lib, put):
        dep = dg.dst < dg.src
        spec = E.SweepSpec(key_v=lib.where(dep, dg.src, V), dyn_idx=dg.dst,
                           dyn=dep, static_c=dg.dst * 0)
        mex = E.get_backend(engine).bind(ell_slot=dg.ell_slot, **kw)
        return E.fixpoint_sweep(mex, spec, put(np.zeros(V, np.int32)),
                                put(np.ones(V, bool)), max_sweeps=4096)

    cr, nr, _ = run(RE, dr, jnp, jnp.asarray)
    ct, nt, changed = run(TE, dt, torch, _t)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    assert nt == int(nr) and not changed
    np.testing.assert_array_equal(ct.numpy(), T.greedy_color(gt))
