"""repro_torch's distributed strategy against the reference, exactly.

The reference runs in one subprocess on an 8-device CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) with the
``bitmap`` engine and ``frontier="off"`` — the configuration it runs
cleanly under the installed jax (its ELL engines and ``frontier="auto"``
raise under ``shard_map``; every reference engine and frontier mode gives
the same colors by its own contract). The port runs as D gloo ranks with
CPU tensors, started by ``repro_torch.launch.run_ranks`` (one subprocess
per rank, a file store per launch), and in-process for D = 1.

Compared with zero tolerance: colors, ``rounds``, ``conflicts_per_round``
and ``sweeps_per_round``, for D in {1, 2, 4, 8 (reference mesh (4, 2))} x
models d1 (RMAT-ER, RMAT-B), d2, pd2 x partition 1d/2d, each case under
one of the four port engines (every D runs all four) and with the port's
wire both ``"boundary"`` and ``"full"`` and its frontier both ``"off"``
and ``"auto"``, plus ``local_concurrency=4`` and ``color_bound`` cases.
The reference runs each case once (it compiles a program per call, so
its time sets this file's), alternating its own wire. Under ``"auto"`` the
port's ``frontier_sizes_per_round`` must follow the reference's rule,
recomputed here from the per-rank pending counts the ranks record. Also:
``partition_graph``/``ShardLayout`` arrays, the plan path (reuse, the
``wire="auto"`` spill program, ``wire="boundary"`` refusing, ``plan.map``
refusing) and the legacy ``color_distributed``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import distributed as TD
from repro_torch.launch import run_ranks

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
ENGINES = ["sort", "bitmap", "ell_pallas", "fused_pallas"]
# graph key -> (model, constructor args)
GRAPHS = {
    "er": ("d1", ("rmat", "RMAT-ER", 10, 3)),
    "b": ("d1", ("rmat", "RMAT-B", 9, 3)),
    "g8": ("d2", ("rmat", "RMAT-G", 8, 2)),
    "bip": ("pd2", ("bip", 256, 128, 1024, 0)),
}
MESHES = {1: None, 2: [2], 4: [4], 8: [4, 2]}


WIRES = ("boundary", "full")
FRONTIERS = ("off", "auto")


def _cases():
    """Every case: model x partition per D > 1 with the engines rotated
    so each D runs all four, plus local_concurrency and color_bound
    cases; the four models at D = 1. ``ref_wire`` is the reference's."""
    out = []
    for D in (2, 4, 8):
        i = D
        for g in GRAPHS:
            for part in ("1d", "2d"):
                out.append(dict(D=D, g=g, partition=part,
                                engine=ENGINES[i % 4], lc=1, cb=0))
                i += 1
        out.append(dict(D=D, g="er", partition="1d", engine="ell_pallas",
                        lc=4, cb=0))
        out.append(dict(D=D, g="b", partition="2d", engine="bitmap",
                        lc=1, cb=24))
    for i, g in enumerate(GRAPHS):
        out.append(dict(D=1, g=g, partition="1d", engine=ENGINES[i],
                        lc=1, cb=0))
    for i, c in enumerate(out):
        c["ref_wire"] = WIRES[i % 2]
        c["id"] = (f"D{c['D']}-{c['g']}-{c['partition']}-{c['engine']}-"
                   f"lc{c['lc']}-cb{c['cb']}")
    return out


CASES = _cases()


def build_graph(pkg, key):
    """The same host graph from either package's constructors."""
    args = GRAPHS[key][1]
    if args[0] == "rmat":
        return pkg.rmat.paper_graph(args[1], args[2], seed=args[3])
    _, L, R, m, seed = args
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, L, m), rng.integers(0, R, m)], 1)
    return pkg.BipartiteGraph.from_edges(L, R, edges)


def _spec_kw(case):
    return dict(strategy="distributed", model=GRAPHS[case["g"]][0],
                engine=case["engine"], partition=case["partition"],
                local_concurrency=case["lc"], color_bound=case["cb"])


def _summary(rep):
    return dict(colors=rep.colors.tolist(), rounds=rep.rounds,
                conf=rep.conflicts_per_round.tolist(),
                sweeps=rep.sweeps_per_round.tolist(),
                front=rep.frontier_sizes_per_round.tolist())


# --------------------------------------------------------------------------
# what each port rank runs (imported by name in the rank processes)
# --------------------------------------------------------------------------
def _plan_graphs(pkg):
    """Three graphs on 512 vertices for the plan path on 4 shards (1d
    blocks of 128): two with edges inside the blocks plus a few across
    (small halos), and one random graph whose halo spills the cap."""
    def block(seed):
        rng = np.random.default_rng(seed)
        blk = rng.integers(0, 4, 1200) * 128
        e = np.stack([blk + rng.integers(0, 128, 1200),
                      blk + rng.integers(0, 128, 1200)], 1)
        cross = rng.integers(0, 512, (8, 2))
        return pkg.Graph.from_edges(512, np.concatenate([e, cross]))
    rng = np.random.default_rng(9)
    dense = pkg.Graph.from_edges(512, rng.integers(0, 512, (1200, 2)))
    return [block(1), block(2), dense]


def _plan_shape(pkg, partition_graph, graphs):
    """The envelope of all three graphs, with the halo capacity of the two
    small-halo ones."""
    boundary_cap = max(partition_graph(g, 4).boundary_local
                       for g in graphs[:2])
    return pkg.PlanShape(
        num_vertices=512,
        padded_edges=pkg.graph.pad_bucket(max(g.num_directed_edges
                                        for g in graphs)),
        max_degree=max(g.max_degree() for g in graphs),
        boundary_cap=boundary_cap)


def rank_cases(mesh, cases, plan=False):
    """One rank: every case under frontier off and auto (recording this
    rank's pending count per frontier round), then the plan path."""
    from repro_torch.core.frontier import frontier_capacities
    counts = []
    inner = TD.frontier_counts

    def recording(active, ptr):
        nv, ne = inner(active, ptr)
        counts.append(int(nv))
        return nv, ne

    TD.frontier_counts = recording
    try:
        out = _run_cases(mesh, cases, counts, frontier_capacities)
    finally:
        TD.frontier_counts = inner
    if plan:
        out["plan"] = _rank_plan(mesh)
    return out


def _run_cases(mesh, cases, counts, frontier_capacities):
    out = {}
    for case in cases:
        g = build_graph(T, case["g"])
        kw = _spec_kw(case)
        res = {}
        for wire in WIRES:
            for fr in FRONTIERS:
                del counts[:]
                rep = T.color(g, T.ColoringSpec(mesh=mesh, frontier=fr,
                                                wire=wire, **kw))
                res[f"{wire}/{fr}"] = _summary(rep)
                res[f"{wire}/{fr}/nv"] = list(counts)
        host = T.distance2.constraint_host_graph(g, kw["model"])
        layout = T.partition_graph(host, mesh.num_devices,
                                   scheme=case["partition"])
        res["cap_v"] = frontier_capacities(layout.verts_local,
                                           layout.edges_local,
                                           host.max_degree())[0]
        out[case["id"]] = res
    return out


def _rank_plan(mesh):
    res = {}
    seeds = [T.rmat.paper_graph("RMAT-ER", 9, seed=s) for s in (0, 1)]
    plan = T.compile_plan(T.ColoringSpec(strategy="distributed", mesh=mesh),
                          seeds[0])
    res["reuse"] = [_summary(plan(g)) for g in seeds]
    res["reuse_traces"] = plan.traces
    res["boundary_cap"] = plan.statics.boundary_cap
    try:
        plan.map(seeds)
    except NotImplementedError as e:
        res["map_raises"] = str(e)
    graphs = _plan_graphs(T)
    shape = _plan_shape(T, T.partition_graph, graphs)
    auto = T.compile_plan(T.ColoringSpec(strategy="distributed", mesh=mesh,
                                         wire="auto"), shape)
    res["spill"], res["spill_traces"] = [], []
    for g in graphs + graphs[2:]:
        res["spill"].append(_summary(auto(g)))
        res["spill_traces"].append(auto.traces)
    strict = T.compile_plan(T.ColoringSpec(strategy="distributed", mesh=mesh,
                                           wire="boundary"), shape)
    res["strict_fits"] = _summary(strict(graphs[1]))
    try:
        strict(graphs[2])
    except ValueError as e:
        res["strict_raises"] = str(e)
    colors, rounds, conf = T.color_distributed(seeds[1], mesh,
                                               engine="fused_pallas")
    res["legacy"] = dict(colors=colors.tolist(), rounds=rounds,
                         conf=conf[:rounds].tolist())
    return res


# --------------------------------------------------------------------------
# the reference, in one subprocess on an 8-device CPU mesh
# --------------------------------------------------------------------------
_REF_CODE = """
import json, sys
import numpy as np, jax
from jax.sharding import Mesh
import repro.core as R
sys.path.insert(0, {tests!r})
import test_torch_distributed as M
cases = json.loads(sys.argv[1])
def mesh_of(D):
    shape = M.MESHES[D] or [1]
    names = ("data", "model")[:len(shape)]
    return Mesh(np.array(jax.devices()[:D]).reshape(shape), names)
out = {{}}
for c in cases:
    kw = dict(M._spec_kw(c), engine="bitmap", wire=c["ref_wire"])
    rep = R.color(M.build_graph(R, c["g"]), R.ColoringSpec(
        mesh=mesh_of(c["D"]), frontier="off", **kw))
    out[c["id"]] = M._summary(rep)
if sys.argv[2] == "1":
    print(json.dumps(out))
    sys.exit(0)
mesh = mesh_of(4)
seeds = [R.rmat.paper_graph("RMAT-ER", 9, seed=s) for s in (0, 1)]
plan = R.compile_plan(R.ColoringSpec(strategy="distributed", mesh=mesh,
                                     frontier="off"), seeds[0])
res = dict(reuse=[M._summary(plan(g)) for g in seeds],
           boundary_cap=plan.statics.boundary_cap)
graphs = M._plan_graphs(R)
from repro.core.distributed import partition_graph
auto = R.compile_plan(R.ColoringSpec(strategy="distributed", mesh=mesh,
                                     wire="auto", frontier="off"),
                      M._plan_shape(R, partition_graph, graphs))
res["spill"] = [M._summary(auto(g)) for g in graphs + graphs[2:]]
res["spill_traces"] = auto.traces
# the legacy shim's default frontier="auto" raises under this jax; the
# frontier modes give the same result by the reference's contract
leg = R.color(seeds[1], R.ColoringSpec(strategy="distributed", mesh=mesh,
                                       frontier="off", max_sweeps=16384))
res["legacy"] = dict(colors=leg.colors.tolist(), rounds=leg.rounds,
                     conf=leg.conflicts_per_round.tolist())
out["plan"] = res
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference results, port results by D): the reference subprocesses
    run while the port's ranks do."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = _REF_CODE.format(tests=os.path.dirname(os.path.abspath(__file__)))
    # two reference processes (it compiles a program per case), the plan
    # path in the second
    ref_procs = [subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(CASES[i::2]), str(1 - i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (0, 1)]
    try:
        port = {}
        for D in (2, 4, 8):
            cases = [c for c in CASES if c["D"] == D]
            per_rank = run_ranks(
                "test_torch_distributed:rank_cases", D,
                dict(cases=cases, plan=D == 4), device="cpu", timeout=240,
                workdir=str(tmp_path_factory.mktemp(f"ranks{D}")))
            port[D] = per_rank
        port[1] = [rank_cases(T.ProcessMesh(None, "cpu"),
                              [c for c in CASES if c["D"] == 1])]
        ref = {}
        for proc in ref_procs:
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-4000:]
            ref.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in ref_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref, port


def _assert_same(got, want, ctx):
    assert got["colors"] == want["colors"], ctx
    for key in ("rounds", "conf", "sweeps"):
        assert got[key] == want[key], f"{ctx}: {key}"


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_distributed_matches_reference(case, results):
    ref, port = results
    want = ref[case["id"]]
    ranks = port[case["D"]]
    for r, rank in enumerate(ranks):
        for wire in WIRES:
            for fr in FRONTIERS:
                _assert_same(rank[case["id"]][f"{wire}/{fr}"], want,
                             f"rank {r} wire={wire} frontier={fr}")
    g = build_graph(T, case["g"])
    validate = {"d1": T.validate_coloring, "d2": T.validate_d2_coloring,
                "pd2": T.validate_pd2_coloring}[GRAPHS[case["g"]][0]]
    assert validate(g, np.asarray(want["colors"], np.int32))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_frontier_sizes_follow_the_reference_rule(D, results):
    """frontier_sizes_per_round[r] is the sum of the ranks' pending counts
    when r > 0 and every rank's pending set fits its vertex slab, else 0;
    a slab-wire round's size is the previous round's conflict count."""
    _, port = results
    ranks = port[D]
    slab_rounds = 0
    for case, wire in ((c, w) for c in CASES if c["D"] == D for w in WIRES):
        runs = [rank[case["id"]] for rank in ranks]
        auto = runs[0][f"{wire}/auto"]
        nv = np.array([run[f"{wire}/auto/nv"] for run in runs])
        assert nv.shape == (len(ranks), auto["rounds"]), case["id"]
        for r in range(auto["rounds"]):
            fits = r > 0 and bool((nv[:, r] <= runs[0]["cap_v"]).all())
            want = int(nv[:, r].sum()) if fits else 0
            assert auto["front"][r] == want, (case["id"], wire, r)
            if want:
                assert want == auto["conf"][r - 1], (case["id"], wire, r)
                slab_rounds += 1
        assert all(run[f"{wire}/off"]["front"] == [0] * auto["rounds"]
                   for run in runs)
    # one shard colors sequentially: round 0 is conflict-free, no slab round
    assert (slab_rounds > 0) == (D > 1), slab_rounds


def test_plan_path_matches_reference(results):
    ref, port = results
    want = ref["plan"]
    for r, rank in enumerate(port[4]):
        got = rank["plan"]
        for a, b in zip(got["reuse"], want["reuse"]):
            _assert_same(a, b, f"rank {r} reuse")
        assert got["reuse_traces"] == 1
        assert got["boundary_cap"] == want["boundary_cap"] > 0
        assert "plan.map" in got["map_raises"]
        for i, (a, b) in enumerate(zip(got["spill"], want["spill"])):
            _assert_same(a, b, f"rank {r} spill graph {i}")
        # boundary program for the two small-halo graphs, then the spill
        # program built once for the dense one, reused for its repeat
        assert got["spill_traces"] == [1, 1, 2, 2]
        assert want["spill_traces"] == 2
        _assert_same(got["strict_fits"], want["spill"][1], "strict")
        assert "halo capacity" in got["strict_raises"]
        assert got["legacy"] == want["legacy"]


def _ref_layout(graph, D, **kw):
    from repro.core.distributed import partition_graph
    return partition_graph(graph, D, **kw)


@pytest.mark.parametrize("scheme", ["1d", "2d"])
@pytest.mark.parametrize("D", [1, 3, 4, 8])
def test_partition_graph_is_the_reference_layout(D, scheme):
    import repro.core as R
    for fam, scale in (("RMAT-B", 9), ("RMAT-ER", 8)):
        gr = R.rmat.paper_graph(fam, scale, seed=1)
        gt = T.rmat.paper_graph(fam, scale, seed=1)
        for kw in ({}, dict(pad_edges_to=8192, pad_boundary_to=512)):
            want = _ref_layout(gr, D, scheme=scheme, **kw)
            got = T.partition_graph(gt, D, scheme=scheme, **kw)
            for f in ("lsrc", "ldst", "bnd", "boundary_counts"):
                a, b = getattr(got, f), np.asarray(getattr(want, f))
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            assert (got.perm is None) == (want.perm is None)
            if got.perm is not None:
                assert np.array_equal(got.perm, want.perm)
            assert (got.verts_local, got.padded_vertices,
                    got.edges_local, got.boundary_local) == \
                (want.verts_local, want.padded_vertices, want.edges_local,
                 want.boundary_local)
            assert np.array_equal(got.interior_counts, want.interior_counts)
            cap = got.boundary_local + 5
            assert np.array_equal(got.padded_boundary(cap),
                                  want.padded_boundary(cap))
            colors = np.arange(got.padded_vertices, dtype=np.int32)
            assert np.array_equal(got.unpermute(colors),
                                  want.unpermute(colors))
            lsrc, ldst, vl = got
            assert lsrc is got.lsrc and ldst is got.ldst \
                and vl == got.verts_local


def test_shard_layout_refuses_what_it_cannot_hold():
    g = T.rmat.paper_graph("RMAT-ER", 8, seed=0)
    layout = T.partition_graph(g, 4)
    with pytest.raises(ValueError, match="halo capacity"):
        layout.padded_boundary(layout.boundary_local - 1)
    with pytest.raises(ValueError, match="slab capacity"):
        T.partition_graph(g, 4, pad_edges_to=layout.edges_local - 1)
    with pytest.raises(ValueError, match="halo capacity"):
        T.partition_graph(g, 4, pad_boundary_to=layout.boundary_local - 1)
    with pytest.raises(ValueError, match="partition scheme"):
        T.partition_graph(g, 4, scheme="3d")


def test_spec_validation_and_device_rules(monkeypatch):
    with pytest.raises(ValueError, match="wire"):
        T.ColoringSpec(strategy="distributed", wire="sometimes")
    with pytest.raises(ValueError, match="partition"):
        T.ColoringSpec(strategy="distributed", partition="3d")
    mesh = T.ProcessMesh(None, "cpu")
    spec = T.ColoringSpec(strategy="distributed", mesh=mesh)
    with pytest.raises(ValueError, match="process-local"):
        spec.to_dict()
    g = T.rmat.paper_graph("RMAT-ER", 6, seed=0)
    # a CPU mesh runs on the CPU with device=None; the card is refused
    assert T.validate_coloring(g, T.color(g, spec).colors)
    with pytest.raises(ValueError, match="mesh runs on"):
        T.color(g, spec, device="cuda")
    with pytest.raises(TypeError, match="host"):
        T.color(g.to_device(device="cpu"), spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: T.color_distributed(g),
                 lambda: T.color(g, T.ColoringSpec(strategy="distributed")),
                 lambda: T.ProcessMesh()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_run_ranks_runs_on_the_card_by_default(monkeypatch, tmp_path):
    # no device means the card: without one the launch raises before any
    # rank starts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks("repro_torch.launch:color_rmat", 2,
                  workdir=str(tmp_path / "ranks"))
    assert not (tmp_path / "ranks").exists()


def test_wire_cost_waits_for_the_analyzer():
    # the analyzer is ported: a distributed plan prices its wire with the
    # closed forms of repro_torch.analysis.wirecost, the others have none
    g = T.rmat.paper_graph("RMAT-ER", 6, seed=0)
    plan = T.compile_plan(T.ColoringSpec(strategy="distributed"), g,
                          device="cpu")
    from repro_torch.analysis.wirecost import wire_cost_table
    assert plan.wire_cost() == wire_cost_table(plan.spec, plan.statics)
    assert set(plan.wire_cost()["tiers"]) == {"halo", "setup", "slab"}
    assert T.compile_plan(T.ColoringSpec(), g,
                          device="cpu").wire_cost() is None
