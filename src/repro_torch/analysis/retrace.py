"""Cache-key hazard lint and plan-envelope leaks (RETRACE codes; the port of
``repro.analysis.retrace``).

The reference guards ``jax.jit`` caches: a static argument resolved at
trace time freezes into the cache. The port compiles nothing, but it keys
caches all the same, and the hazard is the same: a key that admits a
sentinel resolved *inside* the cached computation, or a key that cannot
be hashed. Two complementary passes:

**AST pass** (:func:`lint_source` / :func:`lint_package`) over what the
port keys a cache on:

* functions wrapped by ``functools.cache`` / ``functools.lru_cache``
  (decorated, or assigned ``f = lru_cache(...)(g)``): every parameter is
  part of the key;
* the fields of the dataclasses the serving ``PlanCache`` hashes as its
  key, ``ColoringSpec`` and ``PlanShape`` (:data:`HASHED_KEY_CLASSES`).

For each key parameter or field:

* RETRACE001 — it admits a ``None`` sentinel that is resolved after the
  key is taken: a ``None`` default tested ``is None`` in the cached body,
  or a hashed field defaulting to ``None`` that the package resolves
  (``.<field> is None`` / ``is not None`` anywhere in the package). The
  resolved value freezes into the cached entry, and a later change of
  what ``None`` resolves to is served stale;
* RETRACE002 — its default is a non-hashable literal (list/dict/set, or a
  ``field(default_factory=list|dict|set)``): every lookup raises.

**Recording pass** — RETRACE003, "a value of the concrete graph leaks into
the program", in two forms: a host array the recorded program lifts onto
the device (or holds from a closure) that is neither a registered program
input nor envelope-derived (constant fills and affine ramps are exempt —
the reference's ``_is_envelope_derived`` rules,
:func:`check_trace_constants`); or an op whose shape differs between
recordings of one program on two graphs of one envelope
(:func:`check_shape_stability`): a plan pins every shape to the envelope,
so a shape that follows the graph means the program reads the graph where
it should read the envelope.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Sequence

from .findings import Finding
from .record import Recording, rel_source_path

# the dataclasses the serve PlanCache hashes as its key
HASHED_KEY_CLASSES = ("ColoringSpec", "PlanShape")

_CACHE_WRAPPERS = frozenset({"cache", "lru_cache"})
_MUTABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set)
_MUTABLE_FACTORIES = frozenset({"list", "dict", "set"})


# --------------------------------------------------------------------------
# AST pass
# --------------------------------------------------------------------------
def _is_cache_wrapper(node: ast.AST) -> bool:
    """``functools.cache`` / ``functools.lru_cache`` / their bare names,
    called or not."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr in _CACHE_WRAPPERS
    return isinstance(node, ast.Name) and node.id in _CACHE_WRAPPERS


def _defaults_of(fn: ast.FunctionDef) -> dict:
    """param name -> default AST node (positional + kw-only)."""
    out = {}
    pos = fn.args.args
    for arg, d in zip(pos[len(pos) - len(fn.args.defaults):],
                      fn.args.defaults):
        out[arg.arg] = d
    for arg, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
        if d is not None:
            out[arg.arg] = d
    return out


class _IsNoneFinder(ast.NodeVisitor):
    """Names (and attribute names) compared against None with is/is not."""

    def __init__(self):
        self.names = set()
        self.attrs = set()

    def visit_Compare(self, node: ast.Compare):
        operands = [node.left] + list(node.comparators)
        if any(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) and \
                any(isinstance(o, ast.Constant) and o.value is None
                    for o in operands):
            for o in operands:
                if isinstance(o, ast.Name):
                    self.names.add(o.id)
                elif isinstance(o, ast.Attribute):
                    self.attrs.add(o.attr)
        self.generic_visit(node)


def _cached_functions(tree: ast.AST):
    assigned = set()
    for node in ast.walk(tree):
        # g = lru_cache(maxsize=...)(f)  /  g = functools.cache(f)
        if isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Name) and (
                    _is_cache_wrapper(node.func)
                    or (isinstance(node.func, ast.Call)
                        and _is_cache_wrapper(node.func.func))):
            assigned.add(node.args[0].id)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                node.name in assigned
                or any(_is_cache_wrapper(d) for d in node.decorator_list)):
            yield node


def lint_source(source: str, filename: str, context: str = "retrace-lint",
                resolved_attrs: Iterable[str] = ()) -> List[Finding]:
    """AST-lint one module's source for cache-key hazards.
    ``resolved_attrs``: attribute names the package tests ``is None``
    (the hashed-field rule); the module's own tests are added."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        findings.append(Finding(
            "ANALYSIS000", f"{rel_source_path(filename)}:<module>",
            f"could not parse: {e}", context))
        return findings
    finder = _IsNoneFinder()
    finder.visit(tree)
    resolved = set(resolved_attrs) | finder.attrs
    rel = rel_source_path(filename)

    for fn in _cached_functions(tree):
        site = f"{rel}:{fn.name}"
        defaults = _defaults_of(fn)
        body = _IsNoneFinder()
        for stmt in fn.body:
            body.visit(stmt)
        params = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
        for name in params:
            d = defaults.get(name)
            none_default = isinstance(d, ast.Constant) and d.value is None
            if none_default or name in body.names:
                how = ("defaults to None" if none_default else
                       "is tested `is None` in the cached body")
                findings.append(Finding(
                    "RETRACE001", site,
                    f"cache-key parameter {name!r} {how}: the sentinel is "
                    "the cache key, so its resolution freezes into the "
                    "cached entry (resolve before the cached call)",
                    context))
            if isinstance(d, _MUTABLE_DEFAULTS):
                findings.append(Finding(
                    "RETRACE002", site,
                    f"cache-key parameter {name!r} has a non-hashable "
                    f"default ({type(d).__name__.lower()} literal)",
                    context))

    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name in HASHED_KEY_CLASSES):
            continue
        site = f"{rel}:{node.name}"
        for stmt in node.body:
            if not isinstance(stmt, ast.AnnAssign) or \
                    not isinstance(stmt.target, ast.Name) or \
                    stmt.value is None:
                continue
            name, d = stmt.target.id, stmt.value
            if isinstance(d, ast.Constant) and d.value is None and \
                    name in resolved:
                findings.append(Finding(
                    "RETRACE001", site,
                    f"hashed key field {name!r} defaults to None and the "
                    f"package resolves it (`.{name} is None`) after the "
                    "plan cache keyed on it: the resolution freezes into "
                    "the cached plan", context))
            factory = None
            if isinstance(d, ast.Call):
                for kw in d.keywords:
                    if kw.arg == "default_factory" and \
                            isinstance(kw.value, ast.Name):
                        factory = kw.value.id
                    if kw.arg == "default" and \
                            isinstance(kw.value, _MUTABLE_DEFAULTS):
                        factory = type(kw.value).__name__.lower()
            if isinstance(d, _MUTABLE_DEFAULTS) or \
                    factory in _MUTABLE_FACTORIES | {"list", "dict", "set"}:
                findings.append(Finding(
                    "RETRACE002", site,
                    f"hashed key field {name!r} has a non-hashable default "
                    f"({factory or type(d).__name__.lower()}): every plan "
                    "cache lookup raises", context))
    return findings


def _py_files(root: str):
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def lint_package(root: str, context: str = "retrace-lint") -> List[Finding]:
    """Lint every ``.py`` under ``root`` (a directory)."""
    sources = {}
    resolved = set()
    for path in _py_files(root):
        with open(path, "r", encoding="utf-8") as f:
            sources[path] = f.read()
        try:
            finder = _IsNoneFinder()
            finder.visit(ast.parse(sources[path], filename=path))
            resolved |= finder.attrs
        except SyntaxError:
            pass
    findings: List[Finding] = []
    for path, source in sources.items():
        findings.extend(lint_source(source, path, context, resolved))
    return findings


# --------------------------------------------------------------------------
# recording pass
# --------------------------------------------------------------------------
def check_trace_constants(recordings: Sequence[Recording], context: str = "",
                          site: str = "plan:program") -> List[Finding]:
    """RETRACE003: host arrays the recorded program holds that are neither
    program inputs nor envelope-derived (see module docstring)."""
    findings: List[Finding] = []
    seen = set()
    for rec in recordings:
        for where, dtype, shape in rec.leaks:
            if (where, dtype, tuple(shape)) in seen:
                continue
            seen.add((where, dtype, tuple(shape)))
            findings.append(Finding(
                "RETRACE003", site,
                f"the program holds a host {dtype}{list(shape)} array (at "
                f"{where}) that is neither a fill nor a ramp nor a program "
                "input: a closure-captured data array is frozen for every "
                "graph the plan ever serves — pass it as a program "
                "argument instead", context))
    return findings


def check_shape_stability(a: Recording, b: Recording, context: str = "",
                          site: str = "plan:program") -> List[Finding]:
    """RETRACE003: ops seen in both recordings (one program, two graphs of
    one envelope) whose shape sets are not nested — the op's shape follows
    the graph, not the envelope."""
    findings: List[Finding] = []
    for key in sorted(set(a.shapes) & set(b.shapes)):
        sa, sb = set(a.shapes[key]), set(b.shapes[key])
        if sa <= sb or sb <= sa:
            continue
        where, op = key.split("|", 1)
        findings.append(Finding(
            "RETRACE003", site,
            f"{op} at {where} takes shapes {sorted(sa - sb)[:2]} on one "
            f"graph and {sorted(sb - sa)[:2]} on another of the same "
            "envelope: the program reads a value of the concrete graph "
            "where it should read the envelope", context))
    return findings
