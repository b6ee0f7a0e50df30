"""The port's SPMD verifier on the CPU, mirroring tests/test_analysis_spmd.py:
every COLL/WIRE/HALO code seeded as a small rank program (one rank in this
process, or gloo ranks under ``repro_torch.launch.run_ranks``) or a
mutation of the shipping program, asserted to produce its exact code;
clean-run pins on every shipping wire tier; the closed forms, geometry and
``plan.wire_cost()`` equal the reference's; and real 2- and 4-rank gloo runs
gather exactly the bytes of ``plan.wire_cost()``, tier by tier.
"""
import dataclasses

import pytest
import torch

from repro_torch.analysis import (AnalysisError, SpmdGeometry, analyze_spec,
                                  check_collectives, check_halo_exactness,
                                  check_wire_cost, closed_form_table,
                                  distributed_geometry, verify_plan,
                                  wire_cost_table)
from repro_torch.analysis.record import Recording, record
from repro_torch.core import distributed as TD
from repro_torch.core.api import ColoringSpec, PlanShape, compile_plan
from repro_torch.core.distributed import ProcessMesh
from repro_torch.kernels.ops import report_loop_exit, report_round
from repro_torch.launch import run_ranks

SHAPE = PlanShape(num_vertices=48, padded_edges=512, max_degree=8)


def codes(findings):
    return [f.code for f in findings]


def rank_program(fn, vp=8):
    """Record ``fn(mesh, x)`` as one rank (no process group: every
    collective is still recorded) with ``x`` the rank's [8] int32 state."""
    mesh = ProcessMesh(None, "cpu")
    x = torch.arange(1, 9, dtype=torch.int32)
    rec, _ = record(lambda: fn(mesh, x), data_inputs=[x], spmd=True, vp=vp)
    return rec


def toy_geometry(**kw):
    base = dict(num_devices=1, verts_local=8, edges_local=64,
                boundary_cap=2, wire="boundary", wire_colors=9,
                max_colors=9, frontier_cap_v=0, frontier_cap_e=0,
                axis_names=("x",))
    base.update(kw)
    return SpmdGeometry(**base)


def rounds(n, body):
    """A round loop of ``n`` rounds with the loop markers the shipping
    loop reports."""
    def fn(mesh, x):
        state = x.clone()
        for r in range(n):
            report_round(r)
            state = body(mesh, state, r)
        report_loop_exit()
        return state
    return fn


# --------------------------------------------------------------------------
# collective safety: one rank program per COLL code
# --------------------------------------------------------------------------
def _vote_then_branch(mesh, x):
    total = int(mesh.all_reduce_sum(x.sum().reshape(1)).item())
    if total > 0:                              # an all-reduce vote decides
        x = mesh.all_reduce_sum(x)
    return x


def _local_branch(mesh, x):
    if int(x[0]) > 0:                          # rank-local data decides
        x = mesh.all_reduce_sum(x)
    return x


def _unconditional(mesh, x):
    return mesh.all_gather_tiled(x[:2])


class TestCollectives:
    def test_mismatched_rank_sequences_are_coll201(self):
        a = rank_program(_vote_then_branch)
        b = rank_program(_unconditional)
        got = codes(check_collectives([a, b]))
        assert "COLL201" in got

    def test_local_predicate_with_equal_sequences_is_coll103(self):
        got = codes(check_collectives([rank_program(_local_branch)] * 2))
        assert "COLL103" in got and "COLL201" not in got

    def test_vote_derived_predicate_is_coll102(self):
        got = codes(check_collectives([rank_program(_vote_then_branch)]))
        assert "COLL102" in got
        assert not {"COLL103", "COLL201"} & set(got)

    def test_unconditional_collective_is_coll101(self):
        assert codes(check_collectives(
            [rank_program(_unconditional)])) == ["COLL101"]

    def test_varying_loop_exit_with_collectives_is_coll202(self):
        def fn(mesh, x):
            v, r = x.clone(), 0
            while int(v[0]) < 3:                 # rank-local continuation
                report_round(r)
                v = mesh.all_reduce_sum(v) * 0 + v + 1
                r += 1
            report_loop_exit()
            return v
        assert "COLL202" in codes(check_collectives([rank_program(fn)]))

    def test_uniform_loop_exit_is_not_coll202(self):
        def fn(mesh, x):
            v, r, total = x.clone(), 0, 1
            while total > 0 and r < 3:           # an all-reduce vote
                report_round(r)
                v = v + 1
                total = int(mesh.all_reduce_sum(v[:1]).item())
                r += 1
            report_loop_exit()
            return v
        assert "COLL202" not in codes(check_collectives([rank_program(fn)]))

    def test_ragged_exit_across_ranks_is_coll202(self):
        def body(mesh, s, r):
            return mesh.all_reduce_sum(s)
        a = rank_program(rounds(2, body))
        b = rank_program(rounds(3, body))
        assert "COLL202" in codes(check_collectives([a, b]))

    def test_unread_exchange_patched_carrier_is_coll203(self):
        def body(mesh, s, r):
            g = mesh.all_gather_tiled(s[:2])
            return torch.cat([g, s[2:]])         # carried, never read
        got = codes(check_collectives([rank_program(rounds(3, body))]))
        assert "COLL203" in got

    def test_in_round_read_clears_coll203(self):
        def body(mesh, s, r):
            g = mesh.all_gather_tiled(s[:2])
            s2 = torch.cat([g, s[2:]])
            (s2 > 0).sum()                      # read in-round
            return s2
        got = codes(check_collectives([rank_program(rounds(3, body))]))
        assert "COLL203" not in got


# --------------------------------------------------------------------------
# wire cost: one exchange program per WIRE code (D=1, Vl=8, Bl=2, C=9 ->
# halo = 1 packed word = 4 B/round, setup = 8 B)
# --------------------------------------------------------------------------
def _wire_prog(round_width=1, setup_width=2, extra_gather=False,
               wide_reduce=False):
    def fn(mesh, x):
        setup = mesh.all_gather_tiled(x[:setup_width])
        v = x.clone()
        for r in range(2):
            report_round(r)
            w = mesh.all_gather_tiled(v[:round_width])
            v = v + w.sum() + setup.sum() * 0
            if extra_gather:
                v = v + mesh.all_gather_tiled(v[:1]).sum()
            if wide_reduce:
                v = v + mesh.all_reduce_sum(v[:4]).sum()
            mesh.all_reduce_sum(v[:1])          # scalar control plane
        report_loop_exit()
        return v
    return fn


class TestWireCost:
    def test_exact_tiers_are_wire101_only(self):
        got = codes(check_wire_cost([rank_program(_wire_prog())],
                                    toy_geometry()))
        assert got == ["WIRE101"]

    def test_widened_round_payload_is_wire201(self):
        got = codes(check_wire_cost(
            [rank_program(_wire_prog(round_width=2))], toy_geometry()))
        assert "WIRE201" in got

    def test_extra_round_gather_is_wire202(self):
        got = codes(check_wire_cost(
            [rank_program(_wire_prog(extra_gather=True))], toy_geometry()))
        assert "WIRE202" in got and "WIRE201" not in got

    def test_nonscalar_reduce_is_wire202(self):
        got = codes(check_wire_cost(
            [rank_program(_wire_prog(wide_reduce=True))], toy_geometry()))
        assert "WIRE202" in got

    def test_oversized_setup_exchange_is_wire203(self):
        got = codes(check_wire_cost(
            [rank_program(_wire_prog(setup_width=4))], toy_geometry()))
        assert "WIRE203" in got


# --------------------------------------------------------------------------
# halo exactness: payload width and read-side sinks (Vl = Vp = 8, D = 1)
# --------------------------------------------------------------------------
class TestHaloExactness:
    def test_full_local_state_on_wire_is_halo201(self):
        def body(mesh, s, r):
            g = mesh.all_gather_tiled(s)         # 8 entries >= Vl
            snap = s.clone()
            snap[torch.arange(8)] = g            # through the [Vp] patch
            return snap + snap[0] * 0
        got = codes(check_halo_exactness([rank_program(rounds(2, body))],
                                         toy_geometry()))
        assert got == ["HALO201"]

    def test_raw_payload_into_conflict_compare_is_halo202(self):
        def body(mesh, s, r):
            g = mesh.all_gather_tiled(s[:2])
            conflict = (g == s[:2]).sum()        # raw payload compared
            return s + conflict
        got = codes(check_halo_exactness([rank_program(rounds(2, body))],
                                         toy_geometry()))
        assert got == ["HALO202"]

    def test_raw_payload_into_foreign_table_is_halo202(self):
        def body(mesh, s, r):
            g = mesh.all_gather_tiled(s[:2])
            tbl = torch.zeros((4,), dtype=torch.int32)   # not the [Vp] view
            tbl[g % 4] = 1
            return s + tbl.sum()
        got = codes(check_halo_exactness([rank_program(rounds(2, body))],
                                         toy_geometry()))
        assert "HALO202" in got

    def test_raw_payload_into_a_kernel_is_halo202(self):
        from repro_torch.kernels import conflict_mask

        def body(mesh, s, r):
            g = mesh.all_gather_tiled(s[:2])
            return s + conflict_mask(g, s[:2], g, s[:2]).sum()
        got = codes(check_halo_exactness([rank_program(rounds(2, body))],
                                         toy_geometry()))
        assert "HALO202" in got

    def test_patch_through_vp_snapshot_proves_halo101(self):
        def body(mesh, s, r):
            g = mesh.all_gather_tiled(s[:2])
            snap = s.clone()
            snap[torch.arange(2)] = g            # the [Vp] patch
            conflict = (snap[:2] == s[:2]).sum()  # patched view only
            return snap + conflict * 0
        got = codes(check_halo_exactness([rank_program(rounds(2, body))],
                                         toy_geometry()))
        assert got == ["HALO101"]

    def test_full_wire_is_exempt(self):
        def body(mesh, s, r):
            return s + mesh.all_gather_tiled(s) * 0
        assert check_halo_exactness(
            [rank_program(rounds(2, body))],
            toy_geometry(wire="full", boundary_cap=0)) == []


# --------------------------------------------------------------------------
# mutation fixtures on the SHIPPING program
# --------------------------------------------------------------------------
class TestShippingMutations:
    def test_branch_local_collective_is_rejected(self, monkeypatch):
        # an all-reduce inside the slab solve only: that branch is decided
        # by the rank-local fits_solve test, so verify refuses the plan
        real = TD.frontier_sweep

        def mutant(*args, **kw):
            out = real(*args, **kw)
            ProcessMesh(None, "cpu").all_reduce_sum(
                torch.zeros(1, dtype=torch.int32))
            return out
        monkeypatch.setattr(TD, "frontier_sweep", mutant)
        with pytest.raises(AnalysisError, match="COLL103"):
            compile_plan(ColoringSpec(strategy="distributed",
                                      local_concurrency=2), SHAPE,
                         device="cpu", verify="error")

    def test_widened_wire_codec_rejected_as_wire201(self, monkeypatch):
        import repro_torch.parallel.compression as comp
        monkeypatch.setattr(comp, "halo_bits", lambda bound: 32)
        spec = ColoringSpec(strategy="distributed", wire="boundary")
        assert "WIRE201" in codes(analyze_spec(spec, SHAPE, device="cpu"))
        with pytest.raises(AnalysisError, match="WIRE201"):
            verify_plan(spec, SHAPE, mode="error", device="cpu")


# --------------------------------------------------------------------------
# clean-run pins: every shipping wire tier verifies clean
# --------------------------------------------------------------------------
class TestShippingClean:
    @pytest.mark.parametrize("wire", ["boundary", "full", "auto"])
    def test_wire_tiers_verify_clean(self, wire):
        verify_plan(ColoringSpec(strategy="distributed", wire=wire), SHAPE,
                    mode="error", device="cpu")

    def test_partition_2d_verifies_clean(self):
        verify_plan(ColoringSpec(strategy="distributed", partition="2d"),
                    SHAPE, mode="error", device="cpu")

    def test_frontier_off_verifies_clean(self):
        verify_plan(ColoringSpec(strategy="distributed", frontier="off"),
                    SHAPE, mode="error", device="cpu")

    def test_boundary_plan_carries_all_three_proofs(self):
        got = codes(analyze_spec(
            ColoringSpec(strategy="distributed", wire="boundary"), SHAPE,
            device="cpu"))
        assert {"COLL101", "COLL102", "WIRE101", "HALO101"} <= set(got)
        assert not any(c.startswith(("COLL2", "WIRE2", "HALO2"))
                       for c in got)

    def test_full_plan_skips_halo_and_prices_spill(self):
        got = codes(analyze_spec(
            ColoringSpec(strategy="distributed", wire="full"), SHAPE,
            device="cpu"))
        assert "WIRE101" in got
        assert not any(c.startswith("HALO") for c in got)


# --------------------------------------------------------------------------
# parity with the reference's closed forms, geometry and wire_cost
# --------------------------------------------------------------------------
class _Ranks:
    """A stand-in for a D-rank ProcessMesh: the geometry reads only its
    size."""

    def __init__(self, n):
        self.num_devices = n


BIG = PlanShape(num_vertices=4096, padded_edges=65536, max_degree=16,
                boundary_cap=700)


@pytest.mark.parametrize("frontier", ["auto", "off"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("scheme", ["1d", "2d"])
@pytest.mark.parametrize("wire", ["boundary", "full"])
def test_closed_form_table_equals_the_reference(wire, scheme, D, frontier):
    from repro.analysis import wirecost as rwire
    spec = ColoringSpec(strategy="distributed", wire=wire, partition=scheme,
                        frontier=frontier, mesh=_Ranks(D))
    g = distributed_geometry(spec, BIG)
    kw = dict(num_devices=g.num_devices, verts_local=g.verts_local,
              boundary_local=g.boundary_cap, wire_colors=g.wire_colors,
              frontier_cap_v=g.frontier_cap_v, wire=g.wire, scheme=scheme)
    assert closed_form_table(**kw) == rwire.closed_form_table(**kw)
    assert wire_cost_table(spec, BIG) == closed_form_table(**kw)


@pytest.mark.parametrize("frontier", ["auto", "off"])
@pytest.mark.parametrize("wire", ["boundary", "full", "auto"])
def test_geometry_and_wire_cost_equal_the_reference_at_one_rank(wire,
                                                                  frontier):
    from repro.analysis import spmd as rspmd
    from repro.analysis import wirecost as rwire
    from repro.core import api as rapi
    for shape in (SHAPE, BIG):
        kw = dict(strategy="distributed", wire=wire, frontier=frontier)
        mine = distributed_geometry(ColoringSpec(**kw), shape)
        theirs = rspmd.distributed_geometry(rapi.ColoringSpec(**kw),
                                            rapi.PlanShape(**vars(shape)))
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        plan = compile_plan(ColoringSpec(**kw), shape, device="cpu")
        assert plan.wire_cost() == rwire.wire_cost_table(
            rapi.ColoringSpec(**kw), rapi.PlanShape(**vars(shape)))


# --------------------------------------------------------------------------
# real ranks: gathered bytes against plan.wire_cost(), tier by tier
# --------------------------------------------------------------------------
# a vertex slab as large as a shard: every round after the first fits it,
# so the frontier-slab wire runs
WIRE_CASES = [dict(), dict(frontier_capacity=1024), dict(wire="full"),
              dict(partition="2d")]


def rank_wire(mesh, cases):
    """One rank: for each case, a plan on RMAT-ER scale 10 compiled with
    verify="error", then one recorded plan request: its gathered bytes and
    its recording (the SPMD passes read every rank's)."""
    from repro_torch.core import rmat
    g = rmat.paper_graph("RMAT-ER", 10, seed=0)
    out = []
    for kw in cases:
        spec = ColoringSpec(strategy="distributed", mesh=mesh, engine="sort",
                            **kw)
        plan = compile_plan(spec, g, device="cpu", verify="error")
        mesh.bytes_gathered = 0
        rec, rep = record(lambda: plan(g), spmd=True,
                          vp=plan.wire_cost()["verts_global"],
                          rank=mesh.rank, num_devices=mesh.num_devices)
        out.append(dict(cost=plan.wire_cost(), gathered=mesh.bytes_gathered,
                        rounds=rep.rounds,
                        frontier=rep.frontier_sizes_per_round.tolist(),
                        statics=dataclasses.asdict(plan.statics),
                        recording=rec.to_json()))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {D: run_ranks("test_torch_analysis_spmd:rank_wire", D,
                         dict(cases=WIRE_CASES), device="cpu", timeout=300,
                         workdir=str(tmp_path_factory.mktemp(f"wire{D}")))
            for D in (2, 4)}


@pytest.mark.parametrize("case", range(len(WIRE_CASES)))
@pytest.mark.parametrize("D", [2, 4])
def test_gloo_ranks_gather_the_wire_cost_tier_by_tier(ranks, D, case):
    per_rank = [r[case] for r in ranks[D]]
    cost = per_rank[0]["cost"]
    tiers = cost["tiers"]
    round_tier = tiers["halo" if "halo" in tiers else "spill"]
    slab_rounds = 0
    for r in per_rank:
        assert r["cost"] == cost
        rec = Recording.from_json(r["recording"])
        seen = {"setup": 0, "round": [], "slab": [], "result": 0}
        for e in rec.collectives():
            if e["kind"] != "all_gather":
                assert e["out_elems"] <= 2 or e["phase"] == "result", e
                continue
            if e["phase"] == "round":
                key = "slab" if e["site"].endswith(":slab_wire") else "round"
                seen[key].append(e["out_bytes"])
            else:
                seen[e["phase"]] += e["out_bytes"]
        assert seen["setup"] == tiers.get("setup", {}).get("bytes_once", 0)
        assert all(b == round_tier["bytes_per_round"] for b in seen["round"])
        assert all(b == tiers["slab"]["bytes_per_round"]
                   for b in seen["slab"])
        assert len(seen["round"]) + len(seen["slab"]) == r["rounds"]
        assert seen["result"] == cost["verts_global"] * 4
        # the mesh's own count of what the gathers received agrees
        assert r["gathered"] == (seen["setup"] + sum(seen["round"])
                                 + sum(seen["slab"]) + seen["result"])
        slab_rounds = max(slab_rounds, len(seen["slab"]))
    if WIRE_CASES[case].get("frontier_capacity"):
        assert slab_rounds > 0, "no round took the frontier-slab wire"
    # the SPMD passes over every rank's recording of the request
    recs = [Recording.from_json(r["recording"]) for r in per_rank]
    g = distributed_geometry(dataclasses.replace(
        ColoringSpec(strategy="distributed", **WIRE_CASES[case]),
        mesh=_Ranks(D)), PlanShape(**per_rank[0]["statics"]))
    found = (check_collectives(recs) + check_wire_cost(recs, g)
             + check_halo_exactness(recs, g))
    assert not [f.format() for f in found if f.severity != "info"]
