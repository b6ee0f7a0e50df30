"""Collective-safety pass — the SPMD-deadlock classifier (COLL codes; the
port of ``repro.analysis.collectives``).

One process per rank runs the same host program, so a collective
deadlocks exactly when control flow lets ranks *reach different
collectives*: a branch taken on a value that can differ across ranks, or a
round loop that some ranks leave while the rest block in the next
collective. The reference proves shard-uniformity over the traced
``shard_map`` program. The port's programs branch on host values, so this
pass works on the recordings of every rank of one launch, in two halves:

* **what the ranks did** — the ordered collective signatures (kind,
  reduction, payload shape and dtype) of every rank must agree (COLL201),
  and every rank must leave the round loop after the same number of
  collectives (COLL202). A recording shows one execution: equal sequences
  prove this run deadlock-free, not every run;
* **why they had to** — every collective's call stack is read against the
  program's source: each ``if``/``while`` enclosing a frame of the stack is
  a branch point, and its test is traced back through the assignments of
  its function to the host syncs that produced its values (the recorder
  logs every ``.item()``/``bool()``/``int()``/``.tolist()`` with its call
  stack and whether the synced tensor is *uniform*: derived only from
  all-reduce/all-gather outputs and constants). A test built only from
  parameters, shapes and constants is static (the program's configuration,
  the same on every rank); an assignment that reads the host but made no
  recorded sync did not run, and contributes nothing.

Checks emitted (codes in :mod:`.findings`):

* COLL101 info — a collective under no host-data branch (inventory);
* COLL102 info — under a branch whose test derives from an all-reduce
  (a uniform vote), and from static values otherwise;
* COLL103 warning — under a branch whose test derives from rank-local
  data; the ranks issued identical sequences in this run, so it is safe
  only while that stays so (allowlist with the uniformity argument);
* COLL201 error — the ranks' collective sequences differ;
* COLL202 error — the ranks leave a round loop after different numbers of
  collectives, or the ``while`` test of a loop holding collectives derives
  from rank-local data;
* COLL203 error — a buffer patched from a round's exchange is not read
  before the next round (the conflict pass would consume a stale
  snapshot).
"""
from __future__ import annotations

import ast
import functools
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding
from .record import rel_source_path
from .spmd import fmt_signature, signature

_STATIC, _UNIFORM, _VARYING = 0, 1, 2
_MAX_DEPTH = 12


@functools.lru_cache(maxsize=64)
def _parse(path: str) -> Optional[ast.AST]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def _functions(path: str, line: int, name: str) -> List[ast.AST]:
    """The function defs enclosing ``line`` of ``path``, innermost first
    (the innermost is named ``name``)."""
    tree = _parse(path)
    if tree is None:
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.lineno <= line <= (node.end_lineno or node.lineno):
            out.append(node)
    out.sort(key=lambda n: n.lineno, reverse=True)
    while out and out[0].name != name:
        out.pop(0)
    return out


def _branches(fn: ast.AST, line: int) -> List[Tuple[str, ast.AST]]:
    """``(kind, test)`` of every ``if``/``while`` of ``fn`` (not of nested
    defs) whose body or else-branch holds ``line``."""
    out = []

    def holds(stmts):
        return any(s.lineno <= line <= (s.end_lineno or s.lineno)
                   for s in stmts)

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, (ast.If, ast.While)) and (
                    holds(child.body) or holds(child.orelse)):
                out.append(("while" if isinstance(child, ast.While)
                            else "if", child.test))
            visit(child)

    visit(fn)
    return out


def _targets(node) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for e in node.elts for n in _targets(e)]
    if isinstance(node, ast.Starred):
        return _targets(node.value)
    return []


def _assignments(fn: ast.AST, name: str) -> List[Tuple[ast.AST, ast.AST]]:
    """``(statement, value)`` of every binding of ``name`` in ``fn`` (not
    in nested defs)."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, ast.Assign):
                if any(name in _targets(t) for t in child.targets):
                    out.append((child, child.value))
            elif isinstance(child, (ast.AugAssign, ast.AnnAssign)):
                if name in _targets(child.target) and child.value is not None:
                    out.append((child, child.value))
            elif isinstance(child, (ast.For, ast.AsyncFor)):
                if name in _targets(child.target):
                    out.append((child, child.iter))
            elif isinstance(child, ast.NamedExpr):
                if name in _targets(child.target):
                    out.append((child, child.value))
            visit(child)

    visit(fn)
    return out


class _Syncs:
    """Host syncs by (file, line, function): True if every sync made there
    read a uniform tensor."""

    def __init__(self, recordings: Sequence):
        self.at: Dict[Tuple[str, int, str], bool] = {}
        for rec in recordings:
            for e in rec.events:
                if e["k"] != "sync":
                    continue
                for path, line, func in e["stack"]:
                    key = (path, line, func)
                    self.at[key] = self.at.get(key, True) and e["uniform"]

    def in_range(self, path, lo, hi, func) -> Optional[bool]:
        hits = [u for (p, ln, f), u in self.at.items()
                if p == path and f == func and lo <= ln <= hi]
        return None if not hits else all(hits)


def _classify_expr(expr, path, fns, syncs, depth, seen) -> int:
    names = {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}
    worst = _STATIC
    for name in names:
        worst = max(worst, _classify_name(name, path, fns, syncs, depth,
                                          seen))
    return worst


def _classify_name(name, path, fns, syncs, depth, seen) -> int:
    if depth > _MAX_DEPTH or (name, id(fns[0]) if fns else 0) in seen:
        return _STATIC
    seen = seen | {(name, id(fns[0]) if fns else 0)}
    for i, fn in enumerate(fns):
        binds = _assignments(fn, name)
        if not binds:
            continue            # a closure: the enclosing def binds it
        worst = _STATIC
        for stmt, value in binds:
            synced = syncs.in_range(path, stmt.lineno,
                                    stmt.end_lineno or stmt.lineno, fn.name)
            if synced is not None:
                worst = max(worst, _UNIFORM if synced else _VARYING)
            elif _reads_host(value):
                continue        # a host read this run never executed
            else:
                worst = max(worst, _classify_expr(value, path, fns[i:],
                                                  syncs, depth + 1, seen))
        return worst
    return _STATIC              # a parameter, a global or a builtin


_HOST_READS = frozenset({"item", "tolist"})
_HOST_CASTS = frozenset({"int", "bool", "float"})


def _reads_host(expr) -> bool:
    """True when ``expr`` reads a tensor on the host (``.item()``,
    ``.tolist()``, ``int(...)``/``bool(...)``/``float(...)`` of a
    non-literal): such a statement is classified by its recorded syncs."""
    for n in ast.walk(expr):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_READS:
            return True
        if isinstance(f, ast.Name) and f.id in _HOST_CASTS and n.args and \
                not isinstance(n.args[0], ast.Constant):
            return True
    return False


def _guards(stack, syncs) -> Tuple[int, int, str]:
    """(worst ``if`` class, worst ``while`` class, the deciding test) over
    every frame of a collective's call stack."""
    worst_if = worst_while = _STATIC
    where = ""
    for path, line, func in stack:
        fns = _functions(path, line, func)
        if not fns:
            continue
        for kind, test in _branches(fns[0], line):
            c = _classify_expr(test, path, fns, syncs, 0, frozenset())
            synced = syncs.in_range(path, test.lineno,
                                    test.end_lineno or test.lineno, func)
            if synced is not None:      # the test reads the host itself
                c = max(c, _UNIFORM if synced else _VARYING)
            text = (f"{rel_source_path(path)}:{func} "
                    f"`{kind} {ast.unparse(test)}`")
            if kind == "while":
                if c > worst_while:
                    worst_while = c
                    if c == _VARYING:
                        where = text
            elif c > worst_if:
                worst_if = c
                if c >= _UNIFORM and worst_while < _VARYING:
                    where = text
    return worst_if, worst_while, where


def check_collectives(recordings: Sequence, *,
                      context: str = "") -> List[Finding]:
    """The collective-safety pass over the recordings of every rank of one
    launch (rank order). Programs without collectives give no findings."""
    findings: List[Finding] = []
    seen = set()

    def add(code, site, msg):
        if (code, site) not in seen:
            seen.add((code, site))
            findings.append(Finding(code, site, msg, context))

    seqs = [[signature(e) for e in rec.collectives()] for rec in recordings]
    if not any(seqs):
        return findings
    colls0 = recordings[0].collectives()
    # ---- what the ranks did ---------------------------------------------
    for r, seq in enumerate(seqs[1:], start=1):
        if seq == seqs[0]:
            continue
        k = next((i for i, (a, b) in enumerate(zip(seqs[0], seq)) if a != b),
                 min(len(seq), len(seqs[0])))
        ev = (recordings[0].collectives() + [None])[k] or \
            recordings[r].collectives()[k]
        add("COLL201", ev["site"],
            f"ranks 0 and {r} issue different collective sequences from "
            f"position {k}: "
            f"{[fmt_signature(s) for s in seqs[0][k:k + 2]]} vs "
            f"{[fmt_signature(s) for s in seq[k:k + 2]]} (recorded run): "
            "ranks taking different branches block on different "
            "collectives")
    in_loop = [sum(1 for e in rec.collectives() if e["phase"] == "round")
               for rec in recordings]
    if len(set(in_loop)) > 1 or len({rec.rounds for rec in recordings}) > 1:
        exits = [e for e in recordings[0].events if e["k"] == "exit"]
        site = (f"{rel_source_path(exits[0]['stack'][0][0])}:"
                f"{exits[0]['stack'][0][2]}" if exits and exits[0]["stack"]
                else colls0[0]["site"])
        add("COLL202", site,
            f"ranks leave the round loop after different numbers of "
            f"collectives ({in_loop}) and rounds "
            f"({[rec.rounds for rec in recordings]}): ragged exit, peers "
            "block in the next collective (recorded run)")
    # ---- why they had to ------------------------------------------------
    syncs = _Syncs(recordings)
    inventory = set()
    for e in colls0:
        sig = signature(e)
        g_if, g_while, where = _guards(e["stack"], syncs)
        if e["phase"] == "round" and g_while == _VARYING:
            add("COLL202", e["site"],
                f"round loop issues {fmt_signature(sig)} but its "
                f"continuation test {where} derives from rank-local data: "
                "ranks can exit on different rounds (ragged-exit deadlock)")
            continue
        if g_if == _VARYING:
            add("COLL103", e["site"],
                f"{fmt_signature(sig)} sits under {where}, a test derived "
                "from rank-local data (not provably uniform); every rank "
                "issued the same collective sequence in this run — safe "
                "only while the branches stay identical")
        elif g_if == _UNIFORM:
            add("COLL102", e["site"],
                f"{fmt_signature(sig)} sits under {where}, a test derived "
                "from an all-reduce vote: every rank takes the same branch")
        elif (e["site"], sig) not in inventory:
            inventory.add((e["site"], sig))
            findings.append(Finding(
                "COLL101", e["site"],
                f"unconditional collective {fmt_signature(sig)} "
                f"({e['phase']})", context))
    # ---- stale snapshots ------------------------------------------------
    for rec in recordings:
        for site, shape, dtype, rnd in rec.stale:
            add("COLL203", site,
                f"buffer {shape}:{dtype} is patched from round {rnd}'s "
                "exchange but never read before the next round (recorded "
                "run) — in-round consumers see last round's state")
    return findings
