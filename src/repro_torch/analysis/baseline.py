"""Committed findings baseline: the accepted-risk ledger (the port's own
``baseline.json``, in the reference's version-1 format).

``baseline.json`` (committed next to this module) lists every gating
finding (warning/error) the project has *accepted*, keyed by fingerprint
(``CODE@site``), each with a mandatory human-written ``reason`` string —
the benignity argument the analyzer could not make itself. Three outcomes
when comparing a run against it:

* **new violation** — a gating finding with no entry: CI fails. Fix the
  code or add an entry with a real argument (review will read it).
* **allowlisted** — matched entry; reported under ``-v`` but never gates.
* **stale entry** — an entry no current finding matches. Also a FAILURE
  (baseline drift): a stale entry is a risk-acceptance for code that no
  longer exists, and leaving it around would silently re-accept a future
  regression at the same site.

Info findings never consult the baseline.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Tuple

from .findings import Finding, gating

BASELINE_VERSION = 1


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str = None) -> Dict[str, str]:
    """fingerprint -> reason. Missing file = empty baseline."""
    path = default_baseline_path() if path is None else path
    if not os.path.isfile(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {doc.get('version')!r}")
    out: Dict[str, str] = {}
    for entry in doc.get("entries", ()):
        fp, reason = entry["fingerprint"], entry.get("reason", "")
        if not reason.strip():
            raise ValueError(
                f"baseline {path}: entry {fp!r} has no reason string — "
                "every accepted finding needs its argument written down")
        out[fp] = reason
    return out


def save_baseline(entries: Dict[str, str], path: str = None) -> None:
    path = default_baseline_path() if path is None else path
    doc = {
        "version": BASELINE_VERSION,
        "entries": [{"fingerprint": fp, "reason": entries[fp]}
                    for fp in sorted(entries)],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def compare(findings: Iterable[Finding], baseline: Dict[str, str]
            ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new_violations, allowlisted, stale_fingerprints) — see module
    docstring. Only gating (warning/error) findings participate."""
    gate = gating(findings)
    new = [f for f in gate if f.fingerprint not in baseline]
    allowed = [f for f in gate if f.fingerprint in baseline]
    hit = {f.fingerprint for f in allowed}
    stale = sorted(fp for fp in baseline if fp not in hit)
    return new, allowed, stale
