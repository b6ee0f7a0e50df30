"""Typed findings — the analyzer's one output currency (the PyTorch port of
``repro.analysis.findings``: the same codes, severities and fingerprints).

Every check in :mod:`repro_torch.analysis` reports :class:`Finding` values;
nothing prints, raises or warns on its own. Severity is three-valued:

* ``info``    — classified and benign by construction (idempotent constant
                stores, commutative scatter reductions, static-index writes).
                Never gates anything; the CLI shows them under ``-v``.
* ``warning`` — benign only under an argument the analyzer cannot make
                itself (the paper's speculate-then-resolve model, a
                distinctness-by-construction claim). Must be allowlisted in
                the committed baseline WITH a reason string, or CI fails.
* ``error``   — a genuine hazard (non-idempotent overlapping accumulation,
                a trace-time static-arg sentinel, a bit-field overflow).
                Also allowlistable — some hazards are accepted deliberately
                — but the default posture is: fix it.

Each code keeps the reference's meaning. Where the port checks a property
on a recorded run rather than proving it from a trace, the finding's
message says so. ``RACE301`` (``unique_indices`` asserted) has no public
torch counterpart: it stays registered, and no pass of the port can emit
it.

The ``fingerprint`` (``CODE@site``) is what baselines match on. Sites are
``<package-relative file>:<function>`` with NO line numbers, so refactors
that move code within a function never invalidate the baseline, while
moving a race to a new function (a new benignity argument) does.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

SEVERITIES = ("info", "warning", "error")

# finding-code registry: code -> (default severity, one-line meaning).
# Codes are append-only — baselines reference them by string.
CODES = {
    # race classifier (races.py)
    "RACE101": ("info", "commutative-idempotent scatter reduction "
                        "(min/max/and/or): order-independent, benign"),
    "RACE102": ("info", "static-index store: indices derive from "
                        "constants/iota only — no data-driven overlap"),
    "RACE103": ("info", "idempotent constant store: overlapping writes all "
                        "write the same constant (the bitmap scatter-or)"),
    "RACE104": ("info", "single-site store: one update row, trivially "
                        "unique"),
    "RACE300": ("warning", "speculative overlapping store: data-driven "
                           "indices, last-writer-wins — benign ONLY under "
                           "the paper's conflict-detected speculation model "
                           "(allowlist with the argument)"),
    "RACE301": ("warning", "unique_indices asserted on data-driven indices: "
                           "undefined behavior if the assertion is ever "
                           "violated (allowlist with the distinctness "
                           "argument)"),
    "RACE201": ("error", "floating-point scatter-accumulate: "
                         "accumulation-order nondeterminism"),
    "RACE202": ("error", "non-idempotent overlapping accumulation "
                         "(add/mul): double-counts under speculative "
                         "replay"),
    # cache-key lint and envelope leaks (retrace.py; the reference's
    # static-jit-arg hazards, on what the port keys its caches on)
    "RETRACE001": ("error", "cache key admits a None sentinel resolved after "
                            "the key is taken: the resolved value freezes "
                            "into the cached entry"),
    "RETRACE002": ("error", "cache key has a non-hashable default: every "
                            "lookup raises"),
    "RETRACE003": ("error", "a value of the concrete graph leaks into the "
                            "program (a held host array, or a shape that "
                            "follows the graph): it defeats the plan "
                            "envelope's one-program guarantee"),
    # budget checker (budgets.py)
    "BIT001": ("error", "color bound collides with the packed-entry "
                        "FORBID/CONFLICT bits (color field is bits 0..27)"),
    "BIT002": ("error", "words= capacity override exceeds the packed-entry "
                        "color field"),
    "IDX001": ("error", "ELL slab addressing (V+1)*D overflows int32 index "
                        "arithmetic"),
    "IDX002": ("error", "edge-list capacity overflows int32 index "
                        "arithmetic"),
    "VMEM001": ("error", "kernel per-block shared memory estimate exceeds "
                         "the configured ceiling (or the kernel cannot "
                         "launch at its block size)"),
    # SPMD collective safety (collectives.py)
    "COLL101": ("info", "unconditional collective in the shard program "
                        "(inventory: every device reaches it every round)"),
    "COLL102": ("info", "cond-guarded collectives verified safe: the "
                        "predicate is provably shard-uniform (derived from "
                        "a full-axis reduction), so every device takes the "
                        "same branch"),
    "COLL103": ("warning", "collectives under a predicate the analyzer "
                           "cannot prove shard-uniform: the branch pair "
                           "issues identical ordered collective sequences "
                           "(operationally safe TODAY, one edit from "
                           "deadlock — allowlist with the uniformity "
                           "argument)"),
    "COLL201": ("error", "cond branches issue mismatched collective "
                         "sequences under a predicate not provably "
                         "shard-uniform: devices taking different branches "
                         "block on different collectives (SPMD deadlock)"),
    "COLL202": ("error", "collective inside a loop whose continuation "
                         "predicate is not provably shard-uniform: devices "
                         "can exit on different rounds and leave peers "
                         "blocked in the collective (ragged-exit deadlock)"),
    "COLL203": ("error", "a loop-carried buffer patched from this round's "
                         "exchange is never read before being carried out: "
                         "the conflict pass consumes a stale snapshot"),
    # static wire-cost model (wirecost.py)
    "WIRE101": ("info", "per-round bytes-on-wire cost table entry "
                        "(machine-readable; the dist_scale benchmark "
                        "asserts measured bytes against it)"),
    "WIRE201": ("error", "a wire tier's traced per-round bytes diverge from "
                         "the closed-form accounting documented in "
                         "DESIGN.md §Perf (code/doc drift)"),
    "WIRE202": ("error", "per-round collective matches no documented wire "
                         "tier: unaccounted bytes on the wire"),
    "WIRE203": ("error", "pre-loop setup exchange diverges from the "
                         "one-time D*Bl*4 boundary-map gather accounting"),
    # halo exactness (halo.py)
    "HALO101": ("info", "halo exactness proof: every per-round payload is a "
                        "boundary/slab selection and raw gathered state "
                        "reaches no conflict compare or mex table except "
                        "through the snapshot patch"),
    "HALO201": ("error", "a per-round payload in the boundary-wire program "
                         "carries the full local state: interior entries "
                         "ship on the wire (the boundary selection was "
                         "bypassed)"),
    "HALO202": ("error", "raw gathered payload reaches a conflict "
                         "equality-compare or a non-snapshot table scatter "
                         "without passing the [Vp] snapshot patch: remote "
                         "interior state becomes referenceable"),
    # dead-code report (deadcode.py)
    "DEAD001": ("warning", "public export referenced nowhere outside its "
                           "defining module"),
    "DEAD100": ("info", "module carries a '# pending:' pragma: exports "
                        "exempt from DEAD001 until wired up"),
    # infrastructure
    "ANALYSIS000": ("warning", "a program could not be traced/analyzed; "
                               "the cell is unverified, not clean"),
}


class AnalysisError(RuntimeError):
    """Raised by ``verify="error"`` paths on non-allowlisted findings."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One typed analyzer result.

    code      registry key (CODES);
    site      ``<file>:<function>`` provenance (package-relative, no line
              numbers — the stable half of the fingerprint);
    message   human-readable specifics (shapes, values, dtypes);
    context   which plan produced it (``strategy/engine/model``), or the
              analysis pass name for non-plan findings. NOT part of the
              fingerprint: one allowlist entry covers every plan that
              shares the site.
    severity  defaults to the code's registry severity.
    """

    code: str
    site: str
    message: str
    context: str = ""
    severity: str = ""

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered finding code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][0])
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        return f"{self.code}@{self.site}"

    def format(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.severity:7s} {self.code} {self.site}{ctx}: {self.message}"


def dedupe(findings: Iterable[Finding]) -> List[Finding]:
    """Collapse findings sharing a fingerprint (the same site re-traced
    under many plans), keeping the first and folding the distinct contexts
    into it."""
    by_fp: dict = {}
    order: List[str] = []
    ctxs: dict = {}
    for f in findings:
        fp = f.fingerprint
        if fp not in by_fp:
            by_fp[fp] = f
            order.append(fp)
            ctxs[fp] = []
        if f.context and f.context not in ctxs[fp]:
            ctxs[fp].append(f.context)
    out = []
    for fp in order:
        f = by_fp[fp]
        merged = ctxs[fp]
        ctx = merged[0] if len(merged) == 1 else (
            f"{merged[0]} +{len(merged) - 1} more" if merged else f.context)
        out.append(dataclasses.replace(f, context=ctx))
    return out


def gating(findings: Iterable[Finding]) -> List[Finding]:
    """The findings that must be allowlisted or fixed (warning + error)."""
    return [f for f in findings if f.severity != "info"]


def split_by_severity(findings: Iterable[Finding]
                      ) -> Tuple[List[Finding], List[Finding], List[Finding]]:
    fs = list(findings)
    return ([f for f in fs if f.severity == "error"],
            [f for f in fs if f.severity == "warning"],
            [f for f in fs if f.severity == "info"])
