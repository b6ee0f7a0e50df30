"""``python -m repro_torch.analysis`` — sweep the full registry against the
committed baseline (the port of ``python -m repro.analysis``).

Records every strategy x engine x model combination through the
plan-level passes (races, envelope leaks, budgets) plus the source-level
passes (cache-key AST lint, dead-export scan), dedupes by fingerprint, and
compares against ``repro_torch/analysis/baseline.json``.
``--distributed`` additionally sweeps the host strategy across wire x
partition scheme x engine and runs the SPMD verifier (collective safety,
wire-cost model, halo exactness) on every recorded program (one rank).
``--device cpu|cuda`` picks where the programs run (the card by default,
as every entry point of the port).

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --device cpu --distributed

Exit codes are stable (this is the lint lane ``tools/lint_plans.py`` runs
for the reference):

* exit 0 — every gating finding is allowlisted and no baseline entry is
  stale;
* exit 1 — new violations (fix the code or extend the baseline with a
  reason string), possibly alongside stale entries;
* exit 2 — baseline drift only: no new violations, but stale entries
  match nothing and must be removed (deleted, not ignored).

``--json PATH`` writes a machine-readable report object::

    {"findings": [{code, site, severity, message, context}, ...],
     "wire_cost": [<closed-form cost table per distributed cell>, ...],
     "summary": {errors, warnings, infos, new, stale}}

(``wire_cost`` is populated by ``--distributed``; ``ColoringPlan.wire_cost()``
returns the same tables, and ``chip_smoke.py`` holds the bytes its
distributed runs gather against them.)

``--write-baseline`` regenerates the entry list from the current run,
preserving reason strings for fingerprints that already have one and
stamping ``TODO: justify`` on new ones — the file is meant to be
hand-annotated before committing, and the loader rejects empty reasons.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import (AnalysisConfig, SWEEP_ENGINES, SWEEP_MODELS, SWEEP_SCHEMES,
               SWEEP_STRATEGIES, SWEEP_WIRES, dedupe, lint_tree,
               load_baseline, save_baseline, split_by_severity,
               sweep_distributed, sweep_registry, compare)


def _csv(text):
    return tuple(s.strip() for s in text.split(",") if s.strip())


def _wire_cost_tables(wires, schemes, engines):
    """One closed-form cost table per distributed sweep cell (the --json
    ``wire_cost`` section)."""
    from ..core.api import ColoringSpec, PlanShape
    from . import DEFAULT_SHAPE
    from .wirecost import wire_cost_table

    statics = PlanShape(**DEFAULT_SHAPE)
    tables = []
    for wire in wires:
        for scheme in schemes:
            spec = ColoringSpec(strategy="distributed", engine=engines[0],
                                wire=wire, partition=scheme)
            t = wire_cost_table(spec, statics)
            if t is not None:
                t["cell"] = f"wire={wire}/{scheme}"
                tables.append(t)
    return tables


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis sweep over the coloring registry")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the recorded programs run (default: the "
                         "card)")
    ap.add_argument("--strategies", type=_csv, default=SWEEP_STRATEGIES,
                    help="comma list (default: all registered)")
    ap.add_argument("--engines", type=_csv, default=SWEEP_ENGINES)
    ap.add_argument("--models", type=_csv, default=SWEEP_MODELS)
    ap.add_argument("--distributed", action="store_true",
                    help="also sweep the distributed strategy across "
                         "wire x partition scheme x engine and run the "
                         "SPMD verifier on every traced mesh program")
    ap.add_argument("--wires", type=_csv, default=SWEEP_WIRES,
                    help="comma list for --distributed "
                         "(default: boundary,full,auto)")
    ap.add_argument("--schemes", type=_csv, default=SWEEP_SCHEMES,
                    help="comma list for --distributed (default: 1d,2d)")
    ap.add_argument("--no-source", action="store_true",
                    help="skip the source-level passes (AST lint, dead "
                         "exports); plan sweep only")
    ap.add_argument("--vmem-ceiling", type=int, default=None,
                    help="per-block shared-memory budget of a kernel in "
                         "bytes (default: the card's opt-in limit; "
                         "232,448 on the CPU)")
    ap.add_argument("--baseline", default=None,
                    help="allowlist path (default: the committed "
                         "repro_torch/analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from this run "
                         "(hand-annotate reasons before committing)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the machine-readable report object "
                         "(findings + wire-cost tables + summary)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print info-grade and allowlisted findings")
    args = ap.parse_args(argv)

    config = AnalysisConfig(vmem_ceiling_bytes=args.vmem_ceiling,
                            baseline_path=args.baseline)
    progress = lambda ctx: print(f"  analyzing {ctx}", file=sys.stderr)  # noqa: E731
    findings = sweep_registry(
        strategies=args.strategies, engines=args.engines, models=args.models,
        config=config, progress=progress, device=args.device)
    wire_cost = []
    if args.distributed:
        findings = dedupe(findings + sweep_distributed(
            wires=args.wires, schemes=args.schemes, engines=args.engines,
            config=config, progress=progress, device=args.device))
        wire_cost = _wire_cost_tables(args.wires, args.schemes, args.engines)
    if not args.no_source:
        findings = dedupe(findings + lint_tree())

    errors, warnings_, infos = split_by_severity(findings)
    print(f"{len(findings)} finding(s): {len(errors)} error, "
          f"{len(warnings_)} warning, {len(infos)} info")

    if args.write_baseline:
        old = {}
        try:
            old = load_baseline(args.baseline)
        except ValueError:
            pass  # regenerating a malformed baseline is the point
        entries = {f.fingerprint: old.get(f.fingerprint, "TODO: justify")
                   for f in errors + warnings_}
        save_baseline(entries, args.baseline)
        print(f"wrote {len(entries)} baseline entr(ies); annotate any "
              "'TODO: justify' reasons before committing")
        return 0

    baseline = load_baseline(args.baseline)
    new, allowed, stale = compare(findings, baseline)

    if args.json_path:
        report = {
            "findings": [{"code": x.code, "site": x.site,
                          "severity": x.severity, "message": x.message,
                          "context": x.context} for x in findings],
            "wire_cost": wire_cost,
            "summary": {"errors": len(errors), "warnings": len(warnings_),
                        "infos": len(infos), "new": len(new),
                        "stale": len(stale)},
        }
        with open(args.json_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)

    if args.verbose:
        for f in infos:
            print(f.format())
        for f in allowed:
            print(f"allowed {f.format()}")
    for f in new:
        print(f"NEW     {f.format()}")
    for fp in stale:
        print(f"STALE   baseline entry {fp} matches nothing — remove it")
    if new:
        print(f"FAIL: {len(new)} new violation(s), {len(stale)} stale "
              "baseline entr(ies)")
        return 1
    if stale:
        print(f"DRIFT: {len(stale)} stale baseline entr(ies) — delete them")
        return 2
    print(f"clean: {len(allowed)} allowlisted, {len(infos)} info")
    return 0


if __name__ == "__main__":
    sys.exit(main())
