"""Dead-export report: public names defined but referenced nowhere.

A *public export* is a top-level ``def``/``class``/assignment whose name has
no leading underscore (or the module's ``__all__``, when declared). A name
is *referenced* when it appears (word-boundary match) anywhere in the
corpus — ``.py`` under ``src``/``tests``/``tools``/``benchmarks`` plus the
repo's markdown docs — beyond its own definition. Two plumbing rules keep
re-exports from laundering dead symbols:

* import statements and ``__all__`` blocks are stripped from every file
  before matching (a bare ``from .m import name`` re-export is not usage);
* in the defining module itself, the definition binding is discounted, so
  a symbol used only where it is defined still needs a second mention
  (an internal call, a registration, a docstring cross-reference) to
  count as live.

Intentionally-dormant modules opt out with a pragma comment of the form
"pending: <why>" after a hash at the start of a line (see
``parallel/compression.py``), which downgrades the module's would-be
DEAD001 findings to a single DEAD100 info ("exports exempt until wired
up"). The pragma is a *promise with a name* — grep the pragma to find the
debt.

Sites are package-relative (``core/engine.py:name`` for a module of
``repro_torch``), as in the reference.
"""
from __future__ import annotations

import ast
import os
import re
from typing import List, Sequence, Tuple

from .findings import Finding

PENDING_PRAGMA = re.compile(r"^\s*#\s*pending:\s*(?P<why>\S.*)$", re.M)

# names that are structurally referenced even when no source mentions them
_IMPLICIT = frozenset({"main"})


def module_exports(source: str, filename: str) -> List[str]:
    """Public export names of one module (``__all__`` wins if declared)."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError:
        return []
    declared: List[str] = []
    names: List[str] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    if tgt.id == "__all__" and isinstance(
                            node.value, (ast.List, ast.Tuple)):
                        declared.extend(
                            e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str))
                    else:
                        names.append(tgt.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            names.append(node.target.id)
    if declared:
        return declared
    return [n for n in names if not n.startswith("_")]


def strip_plumbing(source: str) -> str:
    """Blank out import statements and ``__all__`` blocks (including their
    parenthesized/bracketed continuation lines) so re-export plumbing does
    not count as a reference."""
    out_lines: List[str] = []
    active = False  # inside an import/__all__ statement
    depth = 0       # its unclosed () / [] brackets
    for line in source.splitlines():
        if not active and line.lstrip().startswith(
                ("from ", "import ", "__all__")):
            active = True
            depth = 0
        if active:
            depth += (line.count("(") + line.count("[")
                      - line.count(")") - line.count("]"))
            out_lines.append("")
            if depth <= 0 and not line.rstrip().endswith("\\"):
                active = False
            continue
        out_lines.append(line)
    return "\n".join(out_lines)


def _corpus(repo_root: str) -> List[Tuple[str, str]]:
    """(path, plumbing-stripped text) for every reference-countable file."""
    out: List[Tuple[str, str]] = []
    for sub in ("src", "tests", "tools", "benchmarks"):
        base = os.path.join(repo_root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in sorted(os.walk(base)):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    path = os.path.join(dirpath, fname)
                    with open(path, "r", encoding="utf-8") as f:
                        out.append((path, strip_plumbing(f.read())))
    for doc in ("README.md", "DESIGN.md", "ROADMAP.md"):
        path = os.path.join(repo_root, doc)
        if os.path.isfile(path):
            with open(path, "r", encoding="utf-8") as f:
                out.append((path, f.read()))
    return out


def scan_package(package_root: str, repo_root: str,
                 context: str = "deadcode") -> List[Finding]:
    """DEAD001/DEAD100 findings for every module under ``package_root``."""
    corpus = _corpus(repo_root)
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in sorted(os.walk(package_root)):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fname in sorted(filenames):
            if not fname.endswith(".py") or fname == "__init__.py":
                continue
            path = os.path.join(dirpath, fname)
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            rel = os.path.relpath(path, os.path.dirname(package_root))
            rel = rel.replace(os.sep, "/")
            site_file = (rel.split("repro_torch/", 1)[-1]
                         if "repro_torch/" in rel else rel)
            pragma = PENDING_PRAGMA.search(source)
            exports = module_exports(source, path)
            own = strip_plumbing(source)
            dead = [n for n in exports
                    if n not in _IMPLICIT
                    and not _referenced(n, path, own, corpus)]
            if pragma is not None:
                if dead:
                    findings.append(Finding(
                        "DEAD100", f"{site_file}:<module>",
                        f"pending ({pragma.group('why').strip()}): "
                        f"{len(dead)} unreferenced export(s) exempt: "
                        + ", ".join(sorted(dead)), context))
                continue
            for name in sorted(dead):
                findings.append(Finding(
                    "DEAD001", f"{site_file}:{name}",
                    "public export referenced nowhere outside its defining "
                    "module (re-exports in __init__.py do not count)",
                    context))
    return findings


def _referenced(name: str, defining_path: str, defining_stripped: str,
                corpus: Sequence[Tuple[str, str]]) -> bool:
    pat = re.compile(rf"\b{re.escape(name)}\b")
    # in-module: any mention beyond the definition binding itself
    if len(pat.findall(defining_stripped)) > 1:
        return True
    for path, text in corpus:
        if path == defining_path:
            continue
        if pat.search(text):
            return True
    return False
