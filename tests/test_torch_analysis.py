"""repro_torch.analysis on the CPU, mirroring tests/test_analysis.py class by
class: each violation class the analyzer exists to catch is seeded as a
small torch program (or source fixture) and asserted to produce its exact
finding code; the shipping registry plus the committed baseline must
verify clean (``compile_plan(..., verify="error")`` passes for every
strategy x engine x model); and where both packages compute the same thing
from the same inputs — spec budgets, dedupe/gating/compare, the dead-code
scan — the port's answer equals the reference's.
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.analysis as TA
from repro_torch.analysis import (AnalysisConfig, AnalysisError, Finding,
                                  analyze_spec, compare, dedupe, gating,
                                  lint_tree, load_baseline, save_baseline,
                                  split_by_severity, sweep_distributed,
                                  sweep_registry, verify_findings,
                                  verify_plan)
from repro_torch.analysis import budgets, deadcode, races, retrace
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.record import record
from repro_torch.core import api as tapi
from repro_torch.core.api import ColoringSpec, PlanShape, compile_plan
from repro_torch.core.engine import get_backend
from repro_torch.kernels.firstfit import (SMEM_LIMIT_BYTES, check_slab,
                                          smem_estimate)

SHAPE = PlanShape(num_vertices=48, padded_edges=512, max_degree=8)
PKG = os.path.dirname(TA.__file__)


def codes(findings):
    return [f.code for f in findings]


# --------------------------------------------------------------------------
# race classifier: one small torch program per class, exact code asserted
# --------------------------------------------------------------------------
def _scatter_codes(fn, *inputs):
    """Record ``fn(*inputs)`` with every input registered as program data
    (colors, pending sets) and classify its stores."""
    rec, _ = record(lambda: fn(*inputs), data_inputs=inputs)
    return codes(races.classify_scatters([rec]))


def _i32(*xs):
    return torch.tensor(xs, dtype=torch.int32)


IDX = torch.tensor([1, 3, 3, 7])


class TestRaceClassifier:
    def test_float_accumulate_is_race201(self):
        got = _scatter_codes(lambda x, i, u: x.index_add_(0, i, u),
                             torch.zeros(16), IDX.clone(), torch.ones(4))
        assert got == ["RACE201"]

    def test_int_accumulate_is_race202(self):
        got = _scatter_codes(
            lambda x, i, u: x.index_put_((i,), u, accumulate=True),
            torch.zeros(16, dtype=torch.int32), IDX.clone(), _i32(1, 2, 3, 4))
        assert got == ["RACE202"]

    def test_bincount_is_an_int_accumulate(self):
        got = _scatter_codes(lambda i: torch.bincount(i, minlength=16),
                             IDX.clone())
        assert got == ["RACE202"]

    def test_commutative_reduction_is_race101(self):
        got = _scatter_codes(
            lambda x, i, u: x.scatter_reduce_(0, i, u, "amin"),
            torch.zeros(16, dtype=torch.int32), IDX.clone(), _i32(1, 2, 3, 4))
        assert got == ["RACE101"]

    def test_static_indices_are_race102(self):
        def fn(x, u):
            x[torch.arange(4)] = u
            return x
        got = _scatter_codes(fn, torch.zeros(16, dtype=torch.int32),
                             _i32(1, 2, 3, 4))
        assert got == ["RACE102"]

    def test_structure_indices_are_race102(self):
        # a registered structure array (the graph's ELL slots) is static
        src = torch.tensor([0, 2, 5, 9])
        x = torch.zeros(16, dtype=torch.int32)
        u = _i32(1, 2, 3, 4)
        rec, _ = record(lambda: x.index_put_((src,), u),
                        static_inputs=[src], data_inputs=[x, u])
        assert codes(races.classify_scatters([rec])) == ["RACE102"]

    def test_single_update_row_is_race104(self):
        got = _scatter_codes(lambda x, i, u: x.index_put_((i,), u),
                             torch.zeros(16, dtype=torch.int32),
                             torch.tensor([5]), _i32(7))
        assert got == ["RACE104"]

    def test_idempotent_constant_store_is_race103(self):
        def fn(x, i):
            x[i] = 1
            return x
        got = _scatter_codes(fn, torch.zeros(16, dtype=torch.int32),
                             IDX.clone())
        assert got == ["RACE103"]

    def test_speculative_lww_store_is_race300(self):
        got = _scatter_codes(lambda x, i, u: x.index_put_((i,), u),
                             torch.zeros(16, dtype=torch.int32), IDX.clone(),
                             _i32(1, 2, 3, 4))
        assert got == ["RACE300"]

    def test_race301_stays_registered_but_unreachable(self):
        # no aten store takes a uniqueness claim; the code keeps its meaning
        assert TA.CODES["RACE301"][0] == "warning"
        assert "RACE301" not in races._classify.__code__.co_consts

    def test_weakest_argument_wins_across_runs_of_one_store(self):
        def fn(x, i, u):
            x[torch.arange(4)] = u          # static on this call
            x.index_put_((i,), u)           # data-driven on this one
            return x
        # both stores share one site and op: the data-driven run decides
        assert _scatter_codes(fn, torch.zeros(16, dtype=torch.int32),
                              IDX.clone(), _i32(1, 2, 3, 4)) == ["RACE300"]

    def test_plain_version_inside_a_kernel_belongs_to_the_kernel(self):
        # firstfit's plain version scatters a forbidden table; the recorder
        # sees one kernel launch and no plan store
        from repro_torch.kernels import firstfit
        slab = torch.randint(0, 9, (12, 5), dtype=torch.int32)
        rec, _ = record(lambda: firstfit(slab, words=1),
                        data_inputs=[slab])
        assert rec.scatters == []
        assert [ln[0] for ln in rec.launches] == ["firstfit"]

    def test_info_classes_never_gate(self):
        fs = [Finding("RACE101", "a:b", "m"), Finding("RACE104", "a:c", "m")]
        assert gating(fs) == []


# --------------------------------------------------------------------------
# cache-key lint (AST) + graph values leaking into the program (recordings)
# --------------------------------------------------------------------------
_SRC_NONE_DEFAULT = """
import functools
@functools.lru_cache(maxsize=None)
def f(x, device=None):
    return x
"""

_SRC_IS_NONE_BODY = """
from functools import cache
@cache
def g(x, mode="fast"):
    if mode is None:
        mode = "fast"
    return x
"""

_SRC_MUTABLE_DEFAULT = """
import functools
@functools.cache
def h(x, opts=[]):
    return x
"""

_SRC_ASSIGNED = """
import functools
def k(x, device=None):
    return x
k_cached = functools.lru_cache(maxsize=8)(k)
"""

_SRC_SANCTIONED = """
import functools
@functools.lru_cache(maxsize=None)
def k(x, interpret=False):
    return x
"""

_SRC_HASHED_NONE = """
import dataclasses
@dataclasses.dataclass(frozen=True)
class ColoringSpec:
    mesh: object = None
    engine: str = "sort"
def use(spec):
    return spec.mesh if spec.mesh is not None else 0
"""

_SRC_HASHED_MUTABLE = """
import dataclasses
@dataclasses.dataclass(frozen=True)
class PlanShape:
    num_vertices: int = 0
    extra: list = dataclasses.field(default_factory=list)
"""


class TestRetraceLint:
    def test_none_default_cache_key_is_retrace001(self):
        got = retrace.lint_source(_SRC_NONE_DEFAULT, "fixture.py")
        assert codes(got) == ["RETRACE001"]
        assert "device" in got[0].message

    def test_is_none_test_in_body_is_retrace001(self):
        assert codes(retrace.lint_source(_SRC_IS_NONE_BODY,
                                         "fixture.py")) == ["RETRACE001"]

    def test_mutable_default_is_retrace002(self):
        assert codes(retrace.lint_source(_SRC_MUTABLE_DEFAULT,
                                         "fixture.py")) == ["RETRACE002"]

    def test_assigned_cache_wrapper_is_linted(self):
        assert codes(retrace.lint_source(_SRC_ASSIGNED,
                                         "fixture.py")) == ["RETRACE001"]

    def test_resolved_outside_the_cache_is_clean(self):
        assert retrace.lint_source(_SRC_SANCTIONED, "fixture.py") == []

    def test_hashed_field_resolved_from_none_is_retrace001(self):
        got = retrace.lint_source(_SRC_HASHED_NONE, "fixture.py")
        assert codes(got) == ["RETRACE001"]
        assert got[0].site == "fixture.py:ColoringSpec"

    def test_hashed_field_unhashable_default_is_retrace002(self):
        assert codes(retrace.lint_source(_SRC_HASHED_MUTABLE,
                                         "fixture.py")) == ["RETRACE002"]

    def test_closure_captured_data_is_retrace003(self):
        data = torch.from_numpy(np.arange(256, dtype=np.int32) ** 2)
        x = torch.zeros(256, dtype=torch.int32)
        rec, _ = record(lambda: x + data, data_inputs=[x])
        assert codes(retrace.check_trace_constants([rec])) == ["RETRACE003"]

    def test_registered_inputs_are_not_leaks(self):
        arr = np.arange(256, dtype=np.int32) ** 2
        rec, _ = record(lambda: torch.as_tensor(arr) + 1,
                        static_inputs=[arr])
        assert retrace.check_trace_constants([rec]) == []

    @pytest.mark.parametrize("const", [
        torch.arange(256, dtype=torch.int32),       # iota ramp
        torch.full((256,), 7, dtype=torch.int32),   # constant fill
        torch.from_numpy(np.arange(8) ** 2),        # below the threshold
    ], ids=["ramp", "fill", "small"])
    def test_envelope_derived_constants_exempt(self, const):
        x = torch.zeros(const.shape, dtype=const.dtype)
        rec, _ = record(lambda: x + const, data_inputs=[x])
        assert retrace.check_trace_constants([rec]) == []

    def test_shape_following_the_graph_is_retrace003(self):
        def prog(x):
            return torch.zeros(int(x.sum()), dtype=torch.int32) + 1
        a, _ = record(lambda: prog(torch.ones(8, dtype=torch.int32)))
        b, _ = record(lambda: prog(torch.ones(8, dtype=torch.int32) * 2))
        got = retrace.check_shape_stability(a, b)
        assert got and set(codes(got)) == {"RETRACE003"}
        assert any("zeros" in f.message for f in got)

    def test_envelope_pinned_shapes_are_stable(self):
        def prog(x):
            return torch.zeros(8, dtype=torch.int32) + x
        a, _ = record(lambda: prog(torch.ones(8, dtype=torch.int32)))
        b, _ = record(lambda: prog(torch.ones(8, dtype=torch.int32) * 2))
        assert retrace.check_shape_stability(a, b) == []

    def test_data_dependent_shape_ops_are_exempt(self):
        def prog(x):
            return torch.nonzero(x).sum()
        a, _ = record(lambda: prog(torch.tensor([0, 1, 1])))
        b, _ = record(lambda: prog(torch.tensor([1, 1, 1])))
        assert retrace.check_shape_stability(a, b) == []


# --------------------------------------------------------------------------
# budget checker: bit fields, int32 indexing, shared memory
# --------------------------------------------------------------------------
class TestBudgets:
    def test_color_bound_past_bit28_is_bit001(self):
        got = budgets.check_spec_budgets(
            ColoringSpec(engine="sort", color_bound=1 << 28), SHAPE)
        assert codes(got) == ["BIT001"]
        assert got[0].severity == "error"

    def test_max_color_bound_is_accepted(self):
        got = budgets.check_spec_budgets(
            ColoringSpec(engine="sort", color_bound=(1 << 28) - 1), SHAPE)
        assert "BIT001" not in codes(got)

    def test_huge_max_degree_is_bit001(self):
        got = budgets.check_spec_budgets(
            ColoringSpec(engine="sort"), PlanShape(8, 512, 1 << 28))
        assert "BIT001" in codes(got)

    def test_words_override_is_bit002(self):
        from repro_torch.core.engine import FusedPallasMexBackend
        got = budgets.check_spec_budgets(
            ColoringSpec(engine=FusedPallasMexBackend(words=(1 << 23) + 1)), SHAPE,
            vmem_ceiling=1 << 30)
        assert codes(got) == ["BIT002"]

    def test_ell_slab_overflow_is_idx001(self):
        got = budgets.check_spec_budgets(
            ColoringSpec(engine="ell_pallas"),
            PlanShape(2 ** 20, 1 << 20, 2 ** 12))
        assert "IDX001" in codes(got)

    def test_edge_capacity_overflow_is_idx002(self):
        got = budgets.check_spec_budgets(
            ColoringSpec(engine="sort"), PlanShape(48, 2 ** 31, 8))
        assert codes(got) == ["IDX002"]

    def test_bitset_past_the_opt_in_limit_is_vmem001(self):
        # Delta 2M -> 62,501 bitset words: 251,156 B per block, above
        # Hopper's 232,448 B opt-in, with no recording involved
        got = budgets.check_spec_budgets(
            ColoringSpec(engine="fused_pallas"), PlanShape(512, 4096, 2000000))
        assert codes(got) == ["VMEM001"]
        assert got[0].site == "kernels/round_fused.py:round_fused"
        assert "per-block shared memory" in got[0].message

    def test_default_shape_fits_default_ceiling(self):
        for eng in ("ell_pallas", "fused_pallas"):
            assert budgets.check_spec_budgets(ColoringSpec(engine=eng),
                                              SHAPE) == [], eng

    @pytest.mark.parametrize("words", [1, 8, 63, 57_824, 57_825])
    def test_launcher_and_budget_share_one_estimate(self, words):
        # check_slab refuses exactly what the budget pass flags
        slab = torch.zeros((2, 3), dtype=torch.int32)
        fits = smem_estimate(words) <= SMEM_LIMIT_BYTES
        if fits:
            check_slab(slab, words, "firstfit")
        else:
            with pytest.raises(ValueError, match="shared memory"):
                check_slab(slab, words, "firstfit")

    def test_recorded_launches_respect_the_ceiling_knob(self):
        fs = analyze_spec(ColoringSpec(strategy="iterative",
                                       engine="fused_pallas"), SHAPE,
                          config=AnalysisConfig(vmem_ceiling_bytes=1024),
                          device="cpu")
        assert "VMEM001" in codes(fs)
        sites = {f.site for f in fs if f.code == "VMEM001"}
        assert "kernels/round_fused.py:round_fused" in sites


@pytest.mark.parametrize("engine", ["sort", "bitmap", "ell_pallas",
                                    "fused_pallas"])
def test_bit_and_idx_budgets_equal_the_reference(engine):
    """BIT/IDX codes and sites over a grid of specs and envelopes, seeded
    violations included, equal the reference's (VMEM001 differs by design:
    TPU VMEM per grid step against shared memory per block)."""
    from repro.analysis import budgets as rbudgets
    from repro.core import api as rapi
    specs = [dict(), dict(color_bound=7), dict(color_bound=(1 << 28) - 1),
             dict(color_bound=1 << 28), dict(color_bound=1 << 30)]
    shapes = [(48, 512, 8), (8, 512, 1 << 28), (2 ** 20, 1 << 20, 2 ** 12),
              (48, 2 ** 31, 8), (1 << 16, 1 << 18, 4096), (3, 256, 0)]
    n = 0
    for kw in specs:
        for v, e, d in shapes:
            def bit_idx(mod, api):
                fs = mod.check_spec_budgets(
                    api.ColoringSpec(engine=engine, **kw),
                    api.PlanShape(v, e, d), vmem_ceiling=1 << 62)
                return [(f.code, f.site) for f in fs
                        if f.code[:3] in ("BIT", "IDX")]
            got = bit_idx(budgets, tapi)
            assert got == bit_idx(rbudgets, rapi), (kw, v, e, d)
            n += len(got)
    assert n > 0


class TestBindGuard:
    def test_bitmap_bind_rejects_29bit_bound(self):
        with pytest.raises(ValueError, match="packed-entry color field"):
            get_backend("bitmap").bind(num_vertices=8, max_colors=1 << 28)

    def test_bind_accepts_the_field_maximum(self):
        get_backend("bitmap").bind(num_vertices=8, max_colors=(1 << 28) - 1)


# --------------------------------------------------------------------------
# findings / dedupe / baseline plumbing
# --------------------------------------------------------------------------
def _same_findings(mod):
    F = mod.Finding
    return [F("RACE300", "core/x.py:f", "m", "ctx1"),
            F("RACE300", "core/x.py:f", "m2", "ctx2"),
            F("RACE300", "core/x.py:f", "m3", "ctx3"),
            F("BIT001", "core/y.py:g", "m", "ctx1"),
            F("RACE104", "core/z.py:h", "m"),
            F("COLL103", "core/d.py:w", "m", "ctx4")]


class TestFindings:
    def test_codes_and_severities_equal_the_reference(self):
        from repro.analysis.findings import CODES as RCODES
        assert set(TA.CODES) == set(RCODES)
        assert {k: v[0] for k, v in TA.CODES.items()} == \
            {k: v[0] for k, v in RCODES.items()}

    def test_unregistered_code_rejected(self):
        with pytest.raises(ValueError, match="unregistered"):
            Finding("RACE999", "a:b", "m")

    def test_severity_defaults_from_registry(self):
        assert Finding("RACE300", "a:b", "m").severity == "warning"
        assert Finding("BIT001", "a:b", "m").severity == "error"
        assert Finding("RACE104", "a:b", "m").severity == "info"

    def test_fingerprint_excludes_context_and_message(self):
        a = Finding("RACE300", "core/x.py:f", "m1", "iterative/sort/d1")
        b = Finding("RACE300", "core/x.py:f", "m2", "dataflow/bitmap/d2")
        assert a.fingerprint == b.fingerprint == "RACE300@core/x.py:f"

    def test_dedupe_folds_contexts(self):
        a = Finding("RACE300", "core/x.py:f", "m", "ctx1")
        b = Finding("RACE300", "core/x.py:f", "m", "ctx2")
        c = Finding("RACE104", "core/y.py:g", "m", "ctx1")
        out = dedupe([a, b, c])
        assert len(out) == 2
        assert out[0].context == "ctx1 +1 more"
        assert out[1].context == "ctx1"

    def test_split_by_severity(self):
        fs = [Finding("BIT001", "a:b", "m"), Finding("RACE300", "a:c", "m"),
              Finding("RACE104", "a:d", "m")]
        errs, warns, infos = split_by_severity(fs)
        assert (codes(errs), codes(warns), codes(infos)) == (
            ["BIT001"], ["RACE300"], ["RACE104"])

    def test_dedupe_gating_compare_equal_the_reference(self):
        import repro.analysis as RA
        mine, theirs = _same_findings(TA), _same_findings(RA)
        fmt = lambda fs: [f.format() for f in fs]  # noqa: E731
        assert fmt(dedupe(mine)) == fmt(RA.dedupe(theirs))
        assert fmt(gating(mine)) == fmt(RA.gating(theirs))
        base = {"RACE300@core/x.py:f": "ok", "RACE301@core/gone.py:f": "x"}
        a = compare(mine, base)
        b = RA.compare(theirs, base)
        assert (fmt(a[0]), fmt(a[1]), a[2]) == (fmt(b[0]), fmt(b[1]), b[2])


class TestBaseline:
    def test_round_trip(self, tmp_path):
        path = str(tmp_path / "b.json")
        save_baseline({"RACE300@core/x.py:f": "distinct by construction"},
                      path)
        assert load_baseline(path) == {
            "RACE300@core/x.py:f": "distinct by construction"}

    def test_empty_reason_rejected(self, tmp_path):
        path = str(tmp_path / "b.json")
        with open(path, "w") as f:
            json.dump({"version": 1, "entries": [
                {"fingerprint": "RACE300@core/x.py:f", "reason": "  "}]}, f)
        with pytest.raises(ValueError, match="no reason string"):
            load_baseline(path)

    def test_version_mismatch_rejected(self, tmp_path):
        path = str(tmp_path / "b.json")
        with open(path, "w") as f:
            json.dump({"version": 99, "entries": []}, f)
        with pytest.raises(ValueError, match="unsupported version"):
            load_baseline(path)

    def test_compare_three_outcomes(self):
        fs = [Finding("RACE300", "core/x.py:f", "m"),
              Finding("BIT001", "core/y.py:g", "m"),
              Finding("RACE104", "core/z.py:h", "m")]
        base = {"RACE300@core/x.py:f": "ok",
                "RACE301@core/gone.py:f": "stale entry"}
        new, allowed, stale = compare(fs, base)
        assert codes(new) == ["BIT001"]
        assert codes(allowed) == ["RACE300"]
        assert stale == ["RACE301@core/gone.py:f"]

    def test_committed_baseline_names_its_reference_counterpart(self):
        base = load_baseline()
        assert base and base != load_baseline(os.path.join(
            os.path.dirname(PKG), "..", "repro", "analysis",
            "baseline.json"))
        for fp, reason in base.items():
            assert "@" in fp and reason.strip()
            # each reason names the reference fingerprint, or why none
            assert "reference" in reason, fp


# --------------------------------------------------------------------------
# dead-export scan
# --------------------------------------------------------------------------
def _mini_repo(tmp_path, module_source, extra=None):
    pkg = tmp_path / "src" / "pkg"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(module_source)
    for rel, text in (extra or {}).items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(pkg), str(tmp_path)


_DEAD_FIXTURES = {
    "orphan": ("def orphan_helper():\n    pass\n", None),
    "cross_file": ("def live_helper():\n    pass\n",
                   {"tests/test_mod.py": "def test_it():\n    live_helper()\n"}),
    "laundered": ("def laundered():\n    pass\n",
                  {"src/pkg/other.py": "from .mod import laundered\n"}),
    "pending": ("# pending: wire-up later\ndef dormant():\n    pass\n", None),
    "in_module": ("def a():\n    return b()\n\ndef b():\n    return 1\n"
                  "__all__ = ['a', 'b']\n", None),
}


class TestDeadCode:
    def test_unreferenced_export_is_dead001(self, tmp_path):
        pkg, repo = _mini_repo(tmp_path, *_DEAD_FIXTURES["orphan"])
        got = deadcode.scan_package(pkg, repo)
        assert codes(got) == ["DEAD001"]
        assert got[0].site.endswith("mod.py:orphan_helper")

    def test_cross_file_reference_counts(self, tmp_path):
        pkg, repo = _mini_repo(tmp_path, *_DEAD_FIXTURES["cross_file"])
        assert deadcode.scan_package(pkg, repo) == []

    def test_reexport_plumbing_does_not_count(self, tmp_path):
        pkg, repo = _mini_repo(tmp_path, *_DEAD_FIXTURES["laundered"])
        assert codes(deadcode.scan_package(pkg, repo)) == ["DEAD001"]

    def test_pending_pragma_downgrades_to_dead100(self, tmp_path):
        pkg, repo = _mini_repo(tmp_path, *_DEAD_FIXTURES["pending"])
        got = deadcode.scan_package(pkg, repo)
        assert codes(got) == ["DEAD100"]
        assert got[0].severity == "info"
        assert "dormant" in got[0].message and "wire-up later" in \
            got[0].message

    @pytest.mark.parametrize("case", sorted(_DEAD_FIXTURES))
    def test_scan_equals_the_reference(self, tmp_path, case):
        from repro.analysis import deadcode as rdeadcode
        pkg, repo = _mini_repo(tmp_path, *_DEAD_FIXTURES[case])
        got = [f.format() for f in deadcode.scan_package(pkg, repo)]
        assert got == [f.format() for f in rdeadcode.scan_package(pkg, repo)]

    def test_the_port_has_no_dead_exports(self):
        got = [f for f in deadcode.scan_package(
            os.path.dirname(PKG), os.path.dirname(os.path.dirname(
                os.path.dirname(PKG)))) if f.code == "DEAD001"]
        assert got == [], [f.format() for f in got]


# --------------------------------------------------------------------------
# verify= front door + the clean-run pin
# --------------------------------------------------------------------------
class TestVerify:
    def test_seeded_bit001_raises_under_error(self):
        with pytest.raises(AnalysisError, match="BIT001"):
            verify_plan(ColoringSpec(engine="sort", color_bound=1 << 28),
                        SHAPE, mode="error", device="cpu")

    def test_seeded_bit001_warns_under_warn(self):
        with pytest.warns(UserWarning, match="BIT001"):
            verify_plan(ColoringSpec(engine="sort", color_bound=1 << 28),
                        SHAPE, mode="warn", device="cpu")

    def test_compile_plan_verify_error_rejects_seeded_violation(self):
        with pytest.raises(AnalysisError, match="BIT001"):
            compile_plan(ColoringSpec(engine="sort", color_bound=1 << 28),
                         SHAPE, device="cpu", verify="error")

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match="warn"):
            verify_plan(ColoringSpec(), SHAPE, mode="loud", device="cpu")
        with pytest.raises(ValueError, match="warn"):
            compile_plan(ColoringSpec(), SHAPE, device="cpu", verify="loud")

    def test_verify_findings_reports_stale(self, tmp_path):
        path = str(tmp_path / "b.json")
        save_baseline({"RACE300@core/gone.py:f": "code was deleted"}, path)
        new, allowed, stale = verify_findings(
            [], mode="warn", config=AnalysisConfig(baseline_path=path))
        assert (new, allowed) == ([], [])
        assert stale == ["RACE300@core/gone.py:f"]

    def test_shipping_plan_verifies_clean_and_keeps_its_findings(self):
        plan = compile_plan(ColoringSpec(), SHAPE, device="cpu",
                            verify="error")
        assert plan.statics == SHAPE
        assert plan.findings and "ANALYSIS000" not in codes(plan.findings)
        assert compile_plan(ColoringSpec(), SHAPE,
                            device="cpu").findings is None

    def test_analyze_plan_reads_the_plans_envelope(self):
        plan = compile_plan(ColoringSpec(strategy="dataflow"), SHAPE,
                            device="cpu")
        got = dedupe(TA.analyze_plan(plan))
        want = dedupe(analyze_spec(plan.spec, SHAPE, device="cpu"))
        assert [f.format() for f in got] == [f.format() for f in want]

    def test_verify_records_the_given_graph(self):
        from repro_torch.core import rmat
        g = rmat.paper_graph("RMAT-ER", 8, seed=0)
        plan = compile_plan(ColoringSpec(engine="fused_pallas"), g,
                            device="cpu", verify="error")
        assert "RACE300" in codes(plan.findings)

    def test_unreachable_path_is_analysis000(self, monkeypatch):
        # a graph builder that never makes a conflict leaves the frontier
        # round unreached: unverified, not clean
        from repro_torch.core.graph import Graph
        monkeypatch.setattr(TA, "seeded_graph", lambda spec, statics, **k:
                            Graph.from_edges(statics.num_vertices,
                                             np.zeros((0, 2), np.int64)))
        fs = analyze_spec(ColoringSpec(engine="sort"), SHAPE, device="cpu")
        assert "ANALYSIS000" in codes(fs)
        assert any("frontier round" in f.message for f in fs)

    def test_source_tree_gating_findings_are_all_allowlisted(self):
        new, _, _ = compare(lint_tree(), load_baseline())
        assert new == []

    def test_wire_cost_only_for_distributed_plans(self):
        assert compile_plan(ColoringSpec(), SHAPE,
                            device="cpu").wire_cost() is None
        t = compile_plan(ColoringSpec(strategy="distributed"), SHAPE,
                         device="cpu").wire_cost()
        assert set(t["tiers"]) == {"halo", "setup", "slab"}


@pytest.mark.parametrize("model", ["d1", "d2", "pd2"])
@pytest.mark.parametrize("engine", ["sort", "bitmap", "ell_pallas",
                                    "fused_pallas"])
@pytest.mark.parametrize("strategy", ["iterative", "dataflow", "distributed",
                                      "recolor"])
def test_every_shipping_plan_verifies_clean(strategy, engine, model):
    plan = compile_plan(ColoringSpec(strategy=strategy, engine=engine,
                                     model=model), SHAPE, device="cpu",
                        verify="error")
    assert "ANALYSIS000" not in codes(plan.findings)


def test_full_sweep_is_clean_against_the_committed_baseline():
    findings = dedupe(sweep_registry(device="cpu")
                      + sweep_distributed(device="cpu") + lint_tree())
    baseline = load_baseline()
    new, allowed, stale = compare(findings, baseline)
    assert [f.format() for f in new] == []
    assert stale == []
    assert {f.fingerprint for f in allowed} == set(baseline)
    assert "ANALYSIS000" not in codes(findings)


# --------------------------------------------------------------------------
# CLI (the lint lane)
# --------------------------------------------------------------------------
_CELL = ["--strategies", "iterative", "--engines", "sort", "--models", "d1",
         "--no-source", "--device", "cpu"]


class TestCli:
    def test_default_run_is_clean(self, capsys):
        assert analysis_main(["--device", "cpu"]) == 0
        assert "clean:" in capsys.readouterr().out

    def test_single_cell_sweep_is_clean_and_dumps_json(self, tmp_path):
        fps = {f.fingerprint: "scoped to the iterative/sort/d1 cell"
               for f in gating(sweep_registry(
                   strategies=("iterative",), engines=("sort",),
                   models=("d1",), device="cpu"))}
        assert fps, "the iterative/sort cell must have gating findings"
        base = str(tmp_path / "cell.json")
        save_baseline(fps, base)
        out = str(tmp_path / "findings.json")
        assert analysis_main(_CELL + ["--baseline", base,
                                      "--json", out]) == 0
        with open(out) as f:
            doc = json.load(f)
        assert doc["findings"] and all(d["code"] and d["site"]
                                       for d in doc["findings"])
        assert doc["summary"]["new"] == 0 and doc["summary"]["stale"] == 0
        assert doc["wire_cost"] == []

    def test_stale_baseline_exits_2(self, tmp_path):
        fps = {f.fingerprint: "scoped" for f in gating(sweep_registry(
            strategies=("iterative",), engines=("sort",), models=("d1",),
            device="cpu"))}
        fps["RACE300@core/nowhere.py:f"] = "stale"
        base = str(tmp_path / "b.json")
        save_baseline(fps, base)
        assert analysis_main(_CELL + ["--baseline", base]) == 2

    def test_new_violation_exits_1(self, tmp_path):
        base = str(tmp_path / "b.json")
        save_baseline({"RACE300@core/nowhere.py:f": "stale"}, base)
        assert analysis_main(_CELL + ["--baseline", base]) == 1

    def test_distributed_flag_sweeps_clean_with_wire_cost(self, tmp_path):
        out = str(tmp_path / "report.json")
        assert analysis_main(["--device", "cpu", "--distributed",
                              "--json", out]) == 0
        with open(out) as f:
            doc = json.load(f)
        assert len(doc["wire_cost"]) == 6
        for t in doc["wire_cost"]:
            assert ({"halo", "setup"} <= set(t["tiers"])
                    if t["wire"] == "boundary" else "spill" in t["tiers"])
        spmd = {d["code"] for d in doc["findings"]
                if d["code"].startswith(("COLL", "WIRE", "HALO"))}
        assert {"COLL101", "COLL102", "WIRE101", "HALO101"} <= spmd


# --------------------------------------------------------------------------
# the subpackage stands alone
# --------------------------------------------------------------------------
def test_analysis_imports_neither_jax_nor_the_reference():
    for fname in sorted(os.listdir(PKG)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(PKG, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (fname, name)
