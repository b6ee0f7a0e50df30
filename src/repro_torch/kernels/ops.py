"""The kernel registry.

The coloring algorithms reach the kernels only through the engine registry
(``repro_torch.core.engine``: ``engine="ell_pallas"`` binds ``firstfit``,
``engine="fused_pallas"`` binds ``round_fused``, ``engine="sort"`` ends
in ``sorted_mex``), the Alg. 2 phase-2 conflict pass (``conflict_mask``)
and the frontier compaction (``frontier_expand``). What lives here: the
standalone slab helpers :func:`ell_gather_colors` and :func:`ell_mex`
(serial-style mex over an ELL adjacency), :data:`KERNELS`, one entry per
hand-written kernel (its CUDA source, the TPU kernel it replaces, its C
entry's argtypes), the launch
counters that :func:`launch_counts` reads, :func:`kernel_attributes` (what
the CUDA runtime reports for a kernel), and the hooks through which a
running program reports to the static analyzer's recorder
(``repro_torch.analysis.record``):

* :func:`kernel_scope` — every wrapper runs its launch (or, for a CPU
  tensor, its plain version) inside one, so the recorder sees one kernel
  op, never the plain version's aten ops;
* :func:`collective_scope` — ``ProcessMesh`` runs every all-gather and
  all-reduce inside one, before it decides whether a group exists;
* :func:`report_state` — the speculation state a program carries
  (colors, pending sets, the exchanged snapshot): what the recorder's
  provenance calls *data*;
* :func:`report_round` / :func:`report_loop_exit` / :func:`report_path` —
  the distributed round loop's boundaries and the program paths a run
  took.

With no recorder active (the normal case) each hook is one thread-local
read.

Beside them, the program's span log: where a request's time goes, layer by
layer, recorded inside the functions that do the work.

* :func:`span` — a context manager around one piece of a request's work
  (``plan.call``, ``plan.layout``, ``round``, ``serve.flush``, ...);
  :func:`record` — a span whose start was taken earlier (a queue wait);
  :func:`host_read` — the one way the round loop reads device data: the
  ``.tolist()`` inside the span ``sync.<site>``;
* :func:`spans` — the records so far, :func:`summary` — per name the
  count, total and self seconds (a span's duration less what its children
  cover), :func:`reset`, :func:`enable` / :func:`disable`, and
  :func:`request_ids` / :func:`new_request` — the request ids a span
  carries.

Each record holds the name, start and end on ``time.perf_counter_ns()``,
its parent's index in the log (from a per-thread stack), the request id(s)
(one plan call is one id; a service request keeps the id ``submit`` gave
it through its queue wait, its flush and its graph's layout), the thread
and an optional count ``n``. The log is bounded: past :data:`MAX_SPANS`
records a span is counted as dropped.

The log records while a ``torch.profiler`` profile records (a process-wide
flag: a worker thread's spans are recorded too) or between :func:`enable`
and :func:`disable`. Under the profiler each span also opens
``torch.profiler.record_function(name)``, so it sits in the trace as a
``user_annotation`` on the device's clock. When nothing records, a span is
one read of the profiler flag and a shared no-op: no lock, no allocation,
no ``record_function``.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

from .firstfit import firstfit

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Kernel(NamedTuple):
    name: str                # its C entry is repro_<name>
    source: str              # the CUDA source, relative to the repository root
    replaces: Optional[str]  # the pl.pallas_call of the TPU kernel it ports
    argtypes: tuple          # of repro_<name>, which returns a cudaError_t


# One entry per hand-written kernel. _build binds the C entries from it,
# the launches are counted by its names, and a kernel's position is its id
# in csrc/attributes.cu.
KERNELS = (
    Kernel("firstfit", "src/repro_torch/kernels/csrc/firstfit.cu",
           "src/repro/kernels/firstfit.py:117",
           (_P, _L, _I, _I, _I, _P, _P)),
    Kernel("round_fused", "src/repro_torch/kernels/csrc/round_fused.cu",
           "src/repro/kernels/round_fused.py:181",
           (_P, _L, _P, _I, _I, _I, _P, _P, _P)),
    Kernel("conflict_mask", "src/repro_torch/kernels/csrc/conflict.cu",
           "src/repro/kernels/conflict.py:57",
           (_P, _P, _P, _P, _L, _P, _P)),
    # the sort engine's segment-min; the reference takes XLA's segment_min
    Kernel("sorted_mex", "src/repro_torch/kernels/csrc/sorted_mex.cu", None,
           (_P, _P, _L, _I, _P, _P)),
    # the frontier's row-owner flood; the reference takes XLA's lax.cummax
    Kernel("frontier_expand", "src/repro_torch/kernels/csrc/frontier_expand.cu",
           None, (_P, _L, _P, _L, _P, _L, _P, _P, _L, _P, _L, _I, _I, _I, _I,
                  _I, _I, _P, _P, _P, _P, _P)),
)

# launches on the card by kernel name; _build.launch counts them
_LAUNCHES = {k.name: 0 for k in KERNELS}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# the fields repro_kernel_attributes fills, in order
ATTRIBUTE_FIELDS = ("registers", "static_smem_bytes", "local_bytes",
                    "max_threads", "block_threads", "optin_smem_bytes")


def kernel_attributes(name: str, *, words: int = 1, width: int = 1) -> dict:
    """``cudaFuncGetAttributes`` of the kernel variant the launcher of
    ``name`` picks for a ``words``-word bitset over rows of ``width``
    (the bulk-copy variant; the other kernels have one), beside the block
    size the launcher asks for and the card's opt-in shared memory per
    block. Needs the card."""
    from . import _build
    ids = {k.name: i for i, k in enumerate(KERNELS)}
    if name not in ids:
        raise ValueError(f"unknown kernel {name!r}; choose from {sorted(ids)}")
    lib = _build.load()
    out = (ctypes.c_int * len(ATTRIBUTE_FIELDS))()
    rc = lib.repro_kernel_attributes(ids[name], int(words), int(width),
                                     ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, rc, f"{name} attributes")
    return dict(zip(ATTRIBUTE_FIELDS, (int(x) for x in out)))


# --------------------------------------------------------------------------
# the analysis recorder's hooks
# --------------------------------------------------------------------------
_HOOKS = threading.local()


def active_recorder():
    """The recorder this thread's program reports to, or None."""
    return getattr(_HOOKS, "recorder", None)


def set_recorder(recorder) -> Optional[object]:
    """Make ``recorder`` this thread's active recorder; returns the one it
    replaces."""
    prev = active_recorder()
    _HOOKS.recorder = recorder
    return prev


class _Unrecorded:
    """What a scope yields when nothing records: ``result`` passes through."""

    @staticmethod
    def result(out):
        return out


_UNRECORDED = _Unrecorded()


@contextlib.contextmanager
def kernel_scope(name: str, inputs, **info):
    """Run a kernel wrapper's launch (or plain version) as one recorded op:
    ``inputs`` its tensor operands, ``info`` its geometry (rows, width,
    words, smem). The body returns ``scope.result(out)``. The launch, host
    side, is the span ``kernel.<name>``."""
    with span(f"kernel.{name}"):
        rec = active_recorder()
        if rec is None:
            yield _UNRECORDED
            return
        with rec.kernel(name, inputs, info) as scope:
            yield scope


@contextlib.contextmanager
def collective_scope(kind: str, payload, num_devices: int, op: str = ""):
    """Run one ``ProcessMesh`` collective (``"all_gather"`` or
    ``"all_reduce"``, reduction ``op``) as one recorded op, whether or not
    a process group exists. The body returns ``scope.result(out)``."""
    rec = active_recorder()
    if rec is None:
        yield _UNRECORDED
        return
    with rec.collective(kind, payload, num_devices, op) as scope:
        yield scope


def report_state(*tensors) -> None:
    """``tensors`` are the program's speculation state (colors, pending
    sets, snapshots): values computed from them are data, not structure."""
    rec = active_recorder()
    if rec is not None:
        rec.state(tensors)


def report_round(rnd: int) -> None:
    """A round of a collective round loop begins."""
    rec = active_recorder()
    if rec is not None:
        rec.round(rnd)


def report_loop_exit() -> None:
    """The collective round loop has ended."""
    rec = active_recorder()
    if rec is not None:
        rec.loop_exit()


def report_path(name: str) -> None:
    """The program took the path ``name`` (coverage for the recorder)."""
    rec = active_recorder()
    if rec is not None:
        rec.path(name)


# --------------------------------------------------------------------------
# the span log
# --------------------------------------------------------------------------
MAX_SPANS = 1 << 18

Request = Union[None, int, Tuple[int, ...]]


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]     # None while the span is open
    parent: int               # index of the enclosing span in the log; -1
    request: Request          # one request's id, a batch's ids, or None
    thread: int               # threading.get_ident() of the thread
    n: Optional[int]          # a count: bytes copied, requests in a flush


class SpanLog:
    """A bounded, thread-safe log of spans, with a per-thread stack of the
    open ones."""

    def __init__(self, capacity: int = MAX_SPANS):
        self.capacity = capacity
        self.enabled = False
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self._generation = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def add(self, name: str, start_ns: int, end_ns: Optional[int],
            parent: int, request: Request, n: Optional[int],
            parent_generation: Optional[int] = None) -> Tuple[int, int]:
        """Append a record; returns ``(generation, index)``, index -1 when
        the log is full and the record is dropped. ``parent_generation``
        is the generation ``parent`` was indexed in: a parent from before a
        :meth:`reset` is no parent in this log."""
        with self._lock:
            if len(self.records) >= self.capacity:
                self.dropped += 1
                return self._generation, -1
            if parent_generation not in (None, self._generation):
                parent = -1
            self.records.append(SpanRecord(name, start_ns, end_ns, parent,
                                           request, threading.get_ident(), n))
            return self._generation, len(self.records) - 1

    def close(self, generation: int, index: int, end_ns: int) -> None:
        with self._lock:
            if index >= 0 and generation == self._generation:
                self.records[index] = self.records[index]._replace(
                    end_ns=end_ns)

    def reset(self) -> None:
        with self._lock:
            self.records = []
            self.dropped = 0
            self._generation += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``count``, ``total_s`` and ``self_s`` of the
        closed spans (self: the duration less its children's)."""
        with self._lock:
            recs = list(self.records)
        covered = [0] * len(recs)
        for r in recs:
            if r.end_ns is not None and r.parent >= 0:
                covered[r.parent] += r.end_ns - r.start_ns
        out: Dict[str, Dict[str, float]] = {}
        for i, r in enumerate(recs):
            if r.end_ns is None:
                continue
            s = out.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            s["count"] += 1
            s["total_s"] += (r.end_ns - r.start_ns) * 1e-9
            s["self_s"] += (r.end_ns - r.start_ns - covered[i]) * 1e-9
        return out


_SPANS = SpanLog()
_REQUEST_IDS = itertools.count(1)


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``)
    profile is recording, in any thread of the process: the one read of
    the profiler's state (``torch._C._autograd._profiler_enabled()`` is
    per thread, and false in a service's worker)."""
    return _autograd_profiler._is_profiler_enabled


def recording() -> bool:
    """Whether the span log records now."""
    return _SPANS.enabled or profiler_recording()


class _NoSpan:
    """What :func:`span` returns when nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _LiveSpan:
    __slots__ = ("name", "request", "n", "handed", "index", "generation",
                 "annotation")

    def __init__(self, name: str, request: Request, n: Optional[int]):
        self.name, self.request, self.n = name, request, n
        self.handed = 0

    def __enter__(self):
        stack = _SPANS.stack()
        parent = stack[-1] if stack else None
        if self.request is None and parent is not None:
            self.request = parent.request
        self.annotation = None
        if profiler_recording():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.generation, self.index = _SPANS.add(
            self.name, time.perf_counter_ns(), None,
            -1 if parent is None else parent.index, self.request, self.n,
            None if parent is None else parent.generation)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _SPANS.stack().pop()
        _SPANS.close(self.generation, self.index, end)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, *, request: Request = None, n: Optional[int] = None):
    """A context manager that records ``name`` around its block. A span
    without ``request`` carries its parent's."""
    if not recording():
        return _NO_SPAN
    return _LiveSpan(name, request, n)


def record(name: str, start_ns: int, end_ns: int, *,
           request: Request = None, n: Optional[int] = None) -> None:
    """Record a span that started earlier (``time.perf_counter_ns()``
    stamps), outside the stack: no parent, and no trace annotation."""
    if recording():
        _SPANS.add(name, start_ns, end_ns, -1, request, n)


def host_read(tensor: torch.Tensor, site: str) -> list:
    """``tensor.tolist()``, the round loop's one way to read device data,
    inside the span ``sync.<site>``."""
    if not recording():
        return tensor.tolist()
    with _LiveSpan(f"sync.{site}", None, None):
        return tensor.tolist()


def new_request() -> int:
    """A fresh request id."""
    return next(_REQUEST_IDS)


def request_ids(k: int = 1) -> Request:
    """The ids of ``k`` requests that start here, or None when nothing
    records: the enclosing span's next ``k`` where it carries a batch's ids
    (a service flush hands each request its own, a ``plan.map`` each
    graph), its one id where it carries one, else new ids. One id is an
    int, several a tuple."""
    if not recording():
        return None
    stack = _SPANS.stack()
    top = stack[-1] if stack else None
    if top is not None and isinstance(top.request, tuple):
        if len(top.request) - top.handed >= k:
            ids = top.request[top.handed:top.handed + k]
            top.handed += k
            return ids[0] if k == 1 else ids
    elif top is not None and top.request is not None and k == 1:
        return top.request
    ids = tuple(new_request() for _ in range(k))
    return ids[0] if k == 1 else ids


def spans() -> List[SpanRecord]:
    """The records so far, in the order the spans opened (an open span's
    ``end_ns`` is None)."""
    with _SPANS._lock:
        return list(_SPANS.records)


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``total_s`` and ``self_s``."""
    return _SPANS.summary()


def dropped() -> int:
    """Spans not recorded because the log was full."""
    return _SPANS.dropped


def reset() -> None:
    """Empty the log. A span open across it is not recorded, and is no
    parent to the spans opened after it."""
    _SPANS.reset()


def enable() -> None:
    """Record spans without a profiler, until :func:`disable`."""
    _SPANS.enabled = True


def disable() -> None:
    _SPANS.enabled = False


def ell_gather_colors(colors: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """Gather neighbor colors for an ELL adjacency slab.

    colors: [V] int32 (0 = uncolored); ell: [V, D] int32 neighbor ids with
    pad = V. Returns [V, D] int32 (pad slots -> 0); the gather stays outside
    the kernel.
    """
    cpad = torch.cat([colors.to(torch.int32),
                      colors.new_zeros(1, dtype=torch.int32)])
    return cpad[torch.clamp_max(ell.long(), colors.shape[0])]


def ell_mex(colors: torch.Tensor, ell: torch.Tensor, *,
            words: int = 16) -> torch.Tensor:
    """mex per vertex from an ELL slab — the Alg. 1 inner loop through
    :func:`firstfit` (its CUDA kernel for a tensor on the card, its plain
    version for a CPU tensor)."""
    return firstfit(ell_gather_colors(colors, ell), words=words)
