"""The recorder: one run of a plan's program, seen op by op — the port's
counterpart of ``repro.analysis.jaxpr_walk``.

The reference traces a plan program with ``jax.make_jaxpr`` and walks the
equations. The port's programs are eager PyTorch with host loops: every
sweep ends in a host sync, so ``make_fx``/``torch.export`` would break or
specialize at the first ``bool()``. The analyzer's trace is therefore a
*recording of one run*: a ``TorchDispatchMode`` sees every aten op the
program dispatches, with its dtypes, shapes and site, and keeps, per
storage, the op's provenance:

* **static** — derived only from the graph's structure arrays (``src``,
  ``dst``, ``ell_slot``, ``inc_ptr``, the ``ShardLayout`` arrays, which the
  caller registers) and from factory ops;
* **data** — reached from colors, pending sets or a gathered payload;
* **constant fill** — every element equal (a fill factory, a lifted
  scalar, or a fill-preserving op over one);
* **uniform** — provably the same on every rank: factory outputs and
  collective outputs, and ops whose inputs are all uniform (registered
  inputs are per-rank, so never uniform);
* **raw** — derived from an all-gather payload of the current round
  without passing the ``[Vp]`` snapshot patch (the halo-exactness taint).

The **site** of an op is ``<package-relative file>:<function>`` of the
innermost frame of the program (frames of torch, of the standard library,
of this package and of ``ProcessMesh``'s collective plumbing are skipped),
as ``core/engine.py:ell_slab`` — the counterpart of ``site_of``.

Two kinds of call never reach the dispatcher as one op, so they report
themselves through ``repro_torch.kernels.ops``:

* a **kernel launch** is a ctypes call: each wrapper runs inside
  ``kernel_scope`` and is recorded as one op with its name, slab shape,
  words and shared memory. On the CPU the plain version runs inside that
  scope, and its aten ops belong to the kernel, not to the plan, so a
  recording on the CPU equals one on the card;
* a **collective**: ``ProcessMesh`` runs every all-gather and all-reduce in
  ``collective_scope``, before it looks at its group, so a one-rank
  program records its wire too. The distributed round loop reports its
  round boundaries (``report_round``/``report_loop_exit``), and every
  program the paths it took (``report_path``).

Host syncs (``.item()``, ``bool()``, ``int()``, ``.tolist()``) are events
too: the SPMD passes ask whether the branch a collective sits under was
decided by a value derived from an all-reduce.

A recording shows one execution, not every one: what it proves, it proves
for the paths the run took (``Recording.paths``), and the analyzer records
again on graphs built to reach the paths a run missed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.multiprocessing.reductions import StorageWeakRef

from ..kernels import ops as _ops

# constants at or above this element count are checked against the
# envelope-derived exemptions (the reference's threshold)
CONST_ELEMS_THRESHOLD = 128

_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep
_SKIP_DIRS = (_ANALYSIS_DIR,
              os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
              os.path.dirname(os.path.abspath(os.__file__)) + os.sep,
              os.path.dirname(os.path.abspath(np.__file__)) + os.sep)
_OPS_FILE = os.path.abspath(_ops.__file__)
# ProcessMesh's collective plumbing: a collective's site is its caller
_MESH_FUNCS = frozenset({"all_gather_tiled", "_all_gather", "_all_reduce",
                         "_reduce", "all_reduce_sum", "all_reduce_max",
                         "_out", "_back"})
_MESH_FILE = os.sep + os.path.join("core", "distributed.py")

# scatter classes (races.py words them)
SET_OPS = frozenset({"index_put_", "index_put", "scatter_", "scatter",
                     "index_copy_", "index_copy", "index_fill_",
                     "index_fill"})
REDUCE_OPS = frozenset({"scatter_reduce_", "scatter_reduce",
                        "index_reduce_", "index_reduce"})
ADD_OPS = frozenset({"scatter_add_", "scatter_add", "index_add_",
                     "index_add", "bincount"})
SCATTER_OPS = SET_OPS | REDUCE_OPS | ADD_OPS

_FILL_FACTORIES = frozenset({"zeros", "ones", "full", "new_zeros",
                             "new_ones", "new_full", "zeros_like",
                             "ones_like", "full_like", "scalar_tensor",
                             "fill", "fill_", "zero_"})
_FACTORIES = _FILL_FACTORIES | frozenset({
    "arange", "empty", "empty_like", "new_empty", "empty_strided",
    "new_empty_strided", "linspace", "eye"})
_RANDOM = frozenset({"rand", "randn", "randint", "randperm", "rand_like",
                     "randn_like", "randint_like", "uniform_", "normal_",
                     "bernoulli", "bernoulli_"})
_FILL_PRESERVING = frozenset({
    "_to_copy", "clone", "expand", "view", "reshape", "_unsafe_view",
    "unsqueeze", "squeeze", "slice", "select", "alias", "detach",
    "lift_fresh", "lift_fresh_copy", "contiguous", "t", "permute",
    "copy", "_reshape_alias", "expand_copy", "view_copy"})
_DYNAMIC_SHAPE = frozenset({"nonzero", "masked_select", "unique",
                            "_unique", "_unique2", "unique_dim",
                            "unique_consecutive", "repeat_interleave",
                            "argwhere", "nonzero_static"})
_COMPARE_SINKS = frozenset({"eq", "ne", "eq_", "ne_"})
_SYNC_OPS = frozenset({"_local_scalar_dense", "item"})


def rel_source_path(path: str) -> str:
    """Package-relative source path: '.../src/repro_torch/core/engine.py'
    -> 'core/engine.py'; files outside the package keep their basename."""
    norm = path.replace(os.sep, "/")
    marker = "/repro_torch/"
    if marker in norm:
        return norm.rsplit(marker, 1)[1]
    return norm.rsplit("/", 1)[-1]


@functools.lru_cache(maxsize=4096)
def _program_file(path: str) -> bool:
    """True when frames of ``path`` belong to the recorded program."""
    if path.startswith("<"):
        return False
    path = os.path.abspath(path)
    return not (path.startswith(_SKIP_DIRS) or path == _OPS_FILE
                or "-packages" + os.sep in path)


def _is_program_frame(code) -> bool:
    if not _program_file(code.co_filename):
        return False
    return not (code.co_name in _MESH_FUNCS
                and code.co_filename.endswith(_MESH_FILE))


def program_stack(depth: int = 1) -> List[Tuple[str, int, str]]:
    """``[(absolute file, line, function), ...]`` of the program's frames,
    innermost first."""
    out = []
    f = sys._getframe(depth)
    while f is not None:
        code = f.f_code
        if _is_program_frame(code):
            out.append((os.path.abspath(code.co_filename), f.f_lineno,
                        code.co_name))
        f = f.f_back
    return out


def program_site(depth: int = 1, fallback: str = "unknown:unknown") -> str:
    """``<file>:<function>`` of the innermost program frame."""
    f = sys._getframe(depth)
    while f is not None:
        code = f.f_code
        if _is_program_frame(code):
            return f"{rel_source_path(code.co_filename)}:{code.co_name}"
        f = f.f_back
    return fallback


def _is_affine_ramp(arr: np.ndarray) -> bool:
    """iota/arange-like: 1-D with constant stride (stride 0 = constant)."""
    if arr.ndim != 1 or arr.size < 2:
        return True
    if not np.issubdtype(arr.dtype, np.number):
        return False
    d = np.diff(arr.astype(np.float64))
    return bool((d == d[0]).all())


def is_envelope_derived(arr: np.ndarray) -> bool:
    """Constants a shape-specialized program may legitimately hold:
    constant fills and affine ramps (arange and their reshapes) are pure
    functions of the static envelope (the reference's rule)."""
    if arr.size == 0:
        return True
    flat = arr.reshape(-1)
    if not np.issubdtype(arr.dtype, np.number):
        return bool((flat == flat[0]).all())
    if (flat == flat[0]).all():
        return True
    return _is_affine_ramp(flat)


# --------------------------------------------------------------------------
# what one run leaves behind (plain data: JSON- and pickle-able, so the
# ranks of a launch can pool their recordings)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Recording:
    """One rank's recording of one run.

    scatters  ``[site, op, class, dtype, count]`` per distinct store
              (class: ``commutative`` | ``accumulate`` | ``static`` |
              ``single`` | ``fill`` | ``data``);
    leaks     ``[site, dtype, shape]`` per host constant of at least
              ``CONST_ELEMS_THRESHOLD`` elements that is neither a fill, a
              ramp, nor a registered program input;
    shapes    ``"site|op"`` -> the op's distinct shape signatures (ops of
              data-dependent shape, and everything downstream, excluded);
    launches  ``[name, site, rows, width, words, smem, device, count]``;
    events    the collective program, in order (SPMD passes): ``sync``,
              ``coll``, ``round`` and ``exit`` records;
    halo      ``[site, message, round]`` raw-payload sinks (HALO202);
    stale     ``[site, shape, dtype, round]`` buffers patched from a
              round's exchange and never read in that round (COLL203);
    paths     the program paths this run took (``report_path``);
    rounds    the rounds of the collective round loop.
    """

    device: str = "cpu"
    rank: int = 0
    num_devices: int = 1
    scatters: List[list] = dataclasses.field(default_factory=list)
    leaks: List[list] = dataclasses.field(default_factory=list)
    shapes: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    launches: List[list] = dataclasses.field(default_factory=list)
    events: List[dict] = dataclasses.field(default_factory=list)
    halo: List[list] = dataclasses.field(default_factory=list)
    stale: List[list] = dataclasses.field(default_factory=list)
    paths: List[str] = dataclasses.field(default_factory=list)
    rounds: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Recording":
        return cls(**d)

    def collectives(self) -> List[dict]:
        return [e for e in self.events if e["k"] == "coll"]


class _Prov:
    """Provenance of one storage (see the module docstring)."""

    __slots__ = ("data", "uniform", "fill", "raw", "dyn", "patched", "read",
                 "ref")

    def __init__(self, ref, *, data=False, uniform=True, fill=False, raw=-1,
                 dyn=False):
        self.ref = ref
        self.data = data
        self.uniform = uniform
        self.fill = fill
        self.raw = raw
        self.dyn = dyn
        self.patched = -1
        self.read = False


def _flat_tensors(args, kwargs):
    """(argument position or name, tensor) pairs, one level of lists."""
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            yield i, a
        elif isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, torch.Tensor):
                    yield i, x
    for k, a in kwargs.items():
        if isinstance(a, torch.Tensor):
            yield k, a


def _out_tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for x in out:
            if isinstance(x, torch.Tensor):
                yield x


class _Schema:
    __slots__ = ("base", "writes", "view")

    def __init__(self, func):
        self.base = func._overloadpacket.__name__
        s = func._schema
        self.writes = set()
        for i, a in enumerate(s.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                self.writes.add(i)
                self.writes.add(a.name)
        self.view = (not self.writes and any(
            r.alias_info is not None for r in s.returns))


class _Scope:
    def __init__(self):
        self.out = None

    def result(self, out):
        self.out = out
        return out


class _CollectiveScope(_Scope):
    """A one-rank collective returns its payload itself; under the recorder
    it returns a copy (the same values), so the gathered output has a
    provenance of its own, as on a real group."""

    def __init__(self, payload: torch.Tensor):
        super().__init__()
        self.payload = payload

    def result(self, out):
        if isinstance(out, torch.Tensor) and out.untyped_storage().data_ptr() \
                == self.payload.untyped_storage().data_ptr():
            out = out.clone()
        self.out = out
        return out


class _Mode(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if rec._quiet:
            return func(*args, **kwargs)
        rec._before(func, args, kwargs)
        out = func(*args, **kwargs)
        rec._after(func, args, kwargs, out)
        return out


class Recorder:
    """Record one run: ``with Recorder(...) as rec: program(...)``, then
    ``rec.recording``. ``register`` the program's inputs first (torch
    tensors or numpy arrays): structure arrays as static, runtime state as
    data. ``vp`` is the distributed snapshot length (``Vl * D``): an
    index store of raw payload into a ``[Vp]`` or ``[Vp + 1]`` buffer is
    the sanctioned snapshot patch of the halo-exactness proof."""

    def __init__(self, *, device: str = "cpu", rank: int = 0,
                 num_devices: int = 1, vp: int = 0, spmd: bool = False):
        self.recording = Recording(device=str(device), rank=int(rank),
                                   num_devices=int(num_devices))
        self.vp = int(vp)
        self.spmd = bool(spmd)
        self._provs: Dict[StorageWeakRef, _Prov] = {}
        self._ranges: List[Tuple[int, int, dict]] = []
        self._schemas: Dict[object, _Schema] = {}
        self._scatters: Dict[tuple, int] = {}
        self._launches: Dict[tuple, int] = {}
        self._shapes: Dict[str, set] = {}
        self._leaked: set = set()
        self._patched: List[tuple] = []
        self._paths: set = set()
        self._quiet = 0
        self._round = -1
        self._in_loop = False
        self._after_loop = False
        self._inserts = 0
        self._mode = None
        self._prev = None
        self._tolist = None
        self._outer = 0

    # ---- inputs ----------------------------------------------------------
    def register(self, obj, *, data: bool) -> None:
        """Declare a program input: static structure (``data=False``) or
        runtime state (``data=True``). Neither is uniform across ranks."""
        if obj is None:
            return
        if isinstance(obj, torch.Tensor):
            ref = StorageWeakRef(obj.untyped_storage())
            self._provs[ref] = _Prov(ref, data=data, uniform=False)
            return
        arr = np.asarray(obj)
        if arr.size:
            start = arr.__array_interface__["data"][0]
            self._ranges.append((start, start + arr.nbytes,
                                 dict(data=data)))

    # ---- entering and leaving -------------------------------------------
    def _stack(self) -> List[Tuple[str, int, str]]:
        """The program frames of the current call, without the frames
        above the recorded program (its caller's)."""
        stack = program_stack(2)
        return stack[:max(0, len(stack) - self._outer)]

    def __enter__(self) -> "Recorder":
        self._outer = len(program_stack())
        self._prev = _ops.set_recorder(self)
        rec = self
        original = torch.Tensor.tolist
        self._tolist = original

        def tolist(t):
            if _ops.active_recorder() is rec and not rec._quiet:
                rec._sync(t)
            return original(t)

        torch.Tensor.tolist = tolist
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        torch.Tensor.tolist = self._tolist
        _ops.set_recorder(self._prev)
        self._close_round()
        r = self.recording
        r.scatters = [list(k) + [n] for k, n in self._scatters.items()]
        r.launches = [list(k) + [n] for k, n in self._launches.items()]
        r.shapes = {k: sorted(v) for k, v in self._shapes.items()}
        r.paths = sorted(self._paths)

    # ---- provenance ------------------------------------------------------
    def _key(self, t: torch.Tensor) -> StorageWeakRef:
        return StorageWeakRef(t.untyped_storage())

    def _new(self, t: torch.Tensor, **kw) -> _Prov:
        ref = self._key(t)
        p = _Prov(ref, **kw)
        self._provs[ref] = p
        self._inserts += 1
        if self._inserts % 8192 == 0:
            self._provs = {k: v for k, v in self._provs.items()
                           if not v.ref.expired()}
        return p

    def _prov(self, t: torch.Tensor) -> _Prov:
        p = self._provs.get(self._key(t))
        return p if p is not None else self._adopt(t)

    def _adopt(self, t: torch.Tensor) -> _Prov:
        """A tensor the recording never saw made: a registered host array,
        or a constant the program holds (a closure, a lifted literal)."""
        if t.device.type == "cpu" and t.numel():
            ptr = t.data_ptr()
            for lo, hi, kw in self._ranges:
                if lo <= ptr < hi:
                    return self._new(t, uniform=False, **kw)
        arr = t.detach().cpu().numpy() if t.numel() else np.zeros(0)
        fill = bool(arr.size <= 1 or (arr.reshape(-1) == arr.reshape(-1)[0])
                    .all())
        if arr.size >= CONST_ELEMS_THRESHOLD and not is_envelope_derived(arr):
            site = program_site()
            key = (site, str(t.dtype), tuple(t.shape))
            if key not in self._leaked:
                self._leaked.add(key)
                self.recording.leaks.append(
                    [site, str(t.dtype).replace("torch.", ""),
                     list(t.shape)])
        return self._new(t, fill=fill)

    # ---- ops -------------------------------------------------------------
    def _schema(self, func) -> _Schema:
        s = self._schemas.get(func)
        if s is None:
            s = self._schemas[func] = _Schema(func)
        return s

    def _before(self, func, args, kwargs) -> None:
        for _, t in _flat_tensors(args, kwargs):
            if self._key(t) not in self._provs:
                self._adopt(t)

    def _after(self, func, args, kwargs, out) -> None:
        sch = self._schema(func)
        base = sch.base
        if base in _SYNC_OPS:
            self._sync(args[0])
            return
        ins, writes = [], []
        for pos, t in _flat_tensors(args, kwargs):
            (writes if pos in sch.writes else ins).append(t)
        pins = [self._prov(t) for t in ins]
        raw_now = any(p.raw == self._round and p.raw >= 0 for p in pins)
        data = any(p.data for p in pins)
        uniform = all(p.uniform for p in pins)
        dyn = any(p.dyn for p in pins)
        site = program_site()

        # reads of buffers patched from this round's exchange (COLL203)
        if not sch.view:
            for p in pins:
                if p.patched == self._round:
                    p.read = True

        if base in SCATTER_OPS:
            self._scatter(base, args, kwargs, site)
        if base in _COMPARE_SINKS and raw_now:
            self.recording.halo.append(
                [site, "raw gathered payload reaches an equality compare "
                       "(the conflict-predicate class) without passing "
                       "the [Vp] snapshot patch", self._round])

        # shape signature (RETRACE003's second form)
        if base in _DYNAMIC_SHAPE or (base == "index" and any(
                isinstance(x, torch.Tensor) and x.dtype == torch.bool
                for x in (args[1] if len(args) > 1 else ()))):
            dyn = True
        if not dyn:
            sig = ";".join(
                [",".join(map(str, t.shape)) for _, t in
                 _flat_tensors(args, kwargs)]
                + ["->"] + [",".join(map(str, t.shape))
                            for t in _out_tensors(out)])
            key = f"{site}|{base}"
            sigs = self._shapes.setdefault(key, set())
            if len(sigs) < 16:
                sigs.add(sig)

        # in-place writes
        for w in writes:
            pw = self._prov(w)
            if base in SCATTER_OPS and raw_now and self.vp and \
                    w.numel() in (self.vp, self.vp + 1):
                # the sanctioned [Vp] snapshot patch: downstream reads see
                # the patched view, not the raw wire
                pass
            elif raw_now:
                pw.raw = self._round
                if base in SCATTER_OPS:
                    self.recording.halo.append(
                        [site, f"raw gathered payload written into a "
                               f"{tuple(w.shape)} buffer (not the [Vp]="
                               f"[{self.vp}] snapshot view): remote state "
                               f"becomes referenceable outside the patch",
                         self._round])
            if raw_now and self._in_loop:
                pw.patched, pw.read = self._round, False
                self._patched.append((pw, site, list(w.shape),
                                      str(w.dtype).replace("torch.", "")))
            pw.data = pw.data or data
            pw.uniform = pw.uniform and uniform
            pw.fill = base in ("fill_", "zero_")
            pw.dyn = pw.dyn or dyn

        # fresh outputs
        if sch.view or writes:
            return
        if base in _FACTORIES:
            kw = dict(fill=base in _FILL_FACTORIES)
        elif base in _RANDOM:
            kw = dict(data=True, uniform=False)
        else:
            kw = dict(data=data, uniform=uniform,
                      fill=base in _FILL_PRESERVING and bool(pins)
                      and all(p.fill for p in pins),
                      raw=self._round if raw_now else -1)
        for t in _out_tensors(out):
            if self._key(t) in self._provs:
                continue
            p = self._new(t, dyn=dyn, **kw)
            if raw_now and self._in_loop:
                p.patched = self._round
                self._patched.append((p, site, list(t.shape),
                                      str(t.dtype).replace("torch.", "")))

    def _scatter(self, base, args, kwargs, site) -> None:
        """Classify one store (see races.py for the classes)."""
        operand = args[0]
        if base in ("index_put_", "index_put"):
            idx = [x for x in args[1] if isinstance(x, torch.Tensor)]
            values = args[2] if len(args) > 2 else kwargs.get("values")
            accumulate = bool(args[3] if len(args) > 3
                              else kwargs.get("accumulate", False))
            reduce = "sum" if accumulate else None
        elif base == "bincount":
            idx, values, reduce = [operand], None, "sum"
        else:
            idx = [args[2]] if len(args) > 2 and isinstance(
                args[2], torch.Tensor) else []
            values = args[3] if len(args) > 3 else kwargs.get(
                "src", kwargs.get("source", kwargs.get("value")))
            if base in REDUCE_OPS:
                reduce = args[4] if len(args) > 4 else kwargs.get("reduce")
            elif base in ADD_OPS:
                reduce = "sum"
            else:
                reduce = kwargs.get("reduce")
                reduce = {"add": "sum", "multiply": "prod"}.get(reduce,
                                                                 reduce)
        vt = values if isinstance(values, torch.Tensor) else None
        dtype = (vt.dtype if vt is not None else
                 operand.dtype if base != "bincount" else torch.int64)
        if reduce in ("amin", "amax"):
            cls = "commutative"
        elif reduce in ("sum", "prod", "mean"):
            cls = "accumulate"
        elif idx and all(not self._prov(x).data for x in idx):
            cls = "static"
        elif max((x.numel() for x in idx), default=1) <= 1:
            cls = "single"
        elif vt is None or self._prov(vt).fill:
            cls = "fill"
        else:
            cls = "data"
        key = (site, base, cls, str(dtype).replace("torch.", ""),
               str(reduce or ""))
        self._scatters[key] = self._scatters.get(key, 0) + 1

    # ---- syncs, kernels, collectives, loop markers -----------------------
    def _sync(self, t: torch.Tensor) -> None:
        if not self.spmd:
            return
        p = self._prov(t)
        self.recording.events.append(dict(
            k="sync", uniform=bool(p.uniform), stack=self._stack(),
            round=self._round if self._in_loop else None))

    @contextlib.contextmanager
    def kernel(self, name: str, inputs, info: dict):
        if self._quiet:
            yield _Scope()
            return
        site = f"kernels/{'conflict' if name == 'conflict_mask' else name}.py:{name}"
        caller = program_site()
        pins = [self._prov(t) for t in inputs]
        raw_now = any(p.raw == self._round and p.raw >= 0 for p in pins)
        if raw_now:
            self.recording.halo.append(
                [caller, f"raw gathered payload reaches the {name} kernel "
                         "(a conflict compare or a mex table) without "
                         "passing the [Vp] snapshot patch", self._round])
        for p in pins:
            if p.patched == self._round:
                p.read = True
        dev = inputs[0].device.type if inputs else "cpu"
        key = (name, site, int(info.get("rows", 0)),
               int(info.get("width", 0)), int(info.get("words", 0)),
               int(info.get("smem", 0)), dev)
        self._launches[key] = self._launches.get(key, 0) + 1
        scope = _Scope()
        self._quiet += 1
        try:
            yield scope
        finally:
            self._quiet -= 1
        kw = dict(data=any(p.data for p in pins),
                  uniform=all(p.uniform for p in pins),
                  raw=self._round if raw_now else -1)
        for t in _out_tensors(scope.out):
            self._new(t, **kw)

    @contextlib.contextmanager
    def collective(self, kind: str, payload: torch.Tensor, num_devices: int,
                   op: str):
        if self._quiet:
            yield _Scope()
            return
        stack = self._stack()
        p = self._prov(payload)
        if p.patched == self._round:
            p.read = True
        scope = _CollectiveScope(payload)
        self._quiet += 1
        try:
            yield scope
        finally:
            self._quiet -= 1
        out = scope.out
        phase = ("round" if self._in_loop else
                 "result" if self._after_loop else "setup")
        self.recording.events.append(dict(
            k="coll", kind=kind, op=op,
            site=(f"{rel_source_path(stack[0][0])}:{stack[0][2]}"
                  if stack else "unknown:unknown"),
            stack=stack, phase=phase,
            round=self._round if self._in_loop else None,
            in_elems=int(payload.numel()),
            in_bytes=int(payload.numel() * payload.element_size()),
            out_elems=int(out.numel()),
            out_bytes=int(out.numel() * out.element_size()),
            dtype=str(payload.dtype).replace("torch.", ""),
            shape=list(payload.shape), num_devices=int(num_devices),
            raw_in=bool(p.raw == self._round and p.raw >= 0)))
        raw = self._round if (kind == "all_gather" and self._in_loop) else -1
        self._new(out, data=p.data, uniform=True, raw=raw)

    def round(self, rnd: int) -> None:
        self._close_round()
        self._in_loop, self._round = True, int(rnd)
        self.recording.rounds = max(self.recording.rounds, int(rnd) + 1)
        self.recording.events.append(dict(k="round", round=int(rnd)))

    def loop_exit(self) -> None:
        self._close_round()
        self._in_loop, self._after_loop = False, True
        self.recording.events.append(dict(k="exit", stack=self._stack()))
        self._round = -1

    def path(self, name: str) -> None:
        self._paths.add(name)

    def state(self, tensors) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                p = self._prov(t)
                p.data, p.fill = True, False

    def _close_round(self) -> None:
        """COLL203 candidates: buffers patched from this round's exchange,
        still alive, of more than one element, never read since."""
        for p, site, shape, dtype in self._patched:
            if p.patched == self._round and not p.read \
                    and not p.ref.expired() and int(np.prod(shape)) > 1:
                self.recording.stale.append([site, shape, dtype,
                                             self._round])
                p.read = True  # report each buffer once
        self._patched = []


def record(fn, *, static_inputs=(), data_inputs=(), device: str = "cpu",
           rank: int = 0, num_devices: int = 1, vp: int = 0,
           spmd: bool = False):
    """Run ``fn()`` under a :class:`Recorder`; returns ``(recording,
    fn's result)``."""
    rec = Recorder(device=device, rank=rank, num_devices=num_devices,
                   vp=vp, spmd=spmd)
    for x in static_inputs:
        rec.register(x, data=False)
    for x in data_inputs:
        rec.register(x, data=True)
    with rec:
        out = fn()
    return rec.recording, out
