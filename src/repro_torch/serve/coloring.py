"""The coloring service — async admission, deadline batching, restartable
(PyTorch port of ``repro.serve.coloring``).

Two front ends share one plan LRU (:class:`PlanCache`, keyed by the
``(spec, PlanShape)`` *bucket envelope* of a request, so a whole graph
family rides ONE built program):

* :class:`ColoringService` — the synchronous in-process server:
  ``color``/``color_batch`` with same-key micro-batching through
  ``plan.map`` and flush-atomic stats.
* :class:`AsyncColoringService` — the production shape. ``submit`` is
  **admission**, not execution: requests land on per-tenant FIFO queues
  behind a bounded global depth (overflow raises :class:`AdmissionError`).
  A scheduler turn (:meth:`~AsyncColoringService.pump`, driven inline, by
  :meth:`~AsyncColoringService.start`'s worker thread, or by a test with
  a fake clock) moves work in two steps:

  1. **deficit round-robin** over tenant queues — each backlogged tenant
     admits at most ``tenant_quantum`` requests per turn into the open
     micro-batches, so one flooding tenant cannot starve the rest;
  2. **deadline flushing** — an open batch (same ``(spec, envelope)``
     key) flushes when it reaches ``max_batch`` (reason ``"size"``) OR
     when its oldest request ages past ``max_delay_s`` (``"deadline"``);
     ``drain()`` force-flushes the rest (``"drain"``).

  Per-tenant **streams** (:meth:`~AsyncColoringService.open_stream` /
  :meth:`~AsyncColoringService.submit_delta`) ride the same queues: edge
  deltas interleave fairly with coloring requests and apply to the
  tenant's :class:`repro_torch.core.dynamic.DynamicColoring` strictly in
  submission order. :meth:`~AsyncColoringService.checkpoint` snapshots
  every stream plus the cumulative metrics through
  ``repro_torch.train.checkpoint`` (the reference's format, schema 1);
  :meth:`~AsyncColoringService.restore` resumes a killed server so that
  every later repair reproduces the unkilled run's colors exactly — from a
  checkpoint written by this package or by the reference.

Plans, streams and kernels run on ``device`` (``None`` = the card; pass
``device="cpu"`` for the host). Observability is always on: a
:class:`repro_torch.serve.metrics.WindowedMetrics` tracks windowed p50/p99
latency, cache hit rate, program rebuilds and the flush-reason histogram,
committed atomically per flush.

CLI (``python -m repro_torch.serve``):

    PYTHONPATH=src python -m repro_torch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.serve --scale 16 --requests 48 \\
        --tenants 3 --batch 8 --deadline-ms 20 --stream-batches 4
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.api import (ColoringPlan, ColoringReport, ColoringSpec,
                        PlanShape, _plan_shape, compile_plan)
from ..core.dynamic import DeltaReport, DynamicColoring
from ..core.graph import DeviceSpec, resolve_device
from .metrics import WindowedMetrics

Request = Union[object, Tuple[object, ColoringSpec]]  # graph | (graph, spec)


def _latency_summary(lat_s: Sequence[float]) -> dict:
    if not lat_s:
        return {"count": 0}
    a = np.asarray(lat_s, np.float64) * 1e3
    return {
        "count": int(a.size),
        "mean_ms": float(a.mean()),
        "p50_ms": float(np.percentile(a, 50)),
        "p95_ms": float(np.percentile(a, 95)),
        "max_ms": float(a.max()),
    }


# --------------------------------------------------------------------------
# the shared plan cache
# --------------------------------------------------------------------------
class PlanCache:
    """LRU of :class:`ColoringPlan`s on ``device`` keyed ``(spec,
    envelope)`` — the one cache both service front ends share.

    Pure mechanism: lookups return ``(plan, was_hit, evictions)`` and
    mutate NO statistics — callers commit hit/miss/eviction counters
    atomically per flush."""

    def __init__(self, cache_size: int = 32, device: DeviceSpec = None):
        if cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        self.cache_size = int(cache_size)
        self.device = resolve_device(device)
        self._plans: "OrderedDict[Tuple[ColoringSpec, PlanShape], ColoringPlan]" = OrderedDict()
        self._lock = threading.Lock()

    def envelope(self, spec: ColoringSpec, graph) -> PlanShape:
        """The bucket envelope a request is served under (== cache key
        shape): constraint-space vertex count, pad_bucket edge capacity,
        and the max-degree bound rounded up to a full power-of-two octave
        (floored at 8). Degree is quantized much more coarsely than edges
        on purpose: max-degree jitter across one graph family spans tens
        of percent (R-MAT hubs), and an oversized color table is cheap
        next to the rebuild a fragmented cache key would cost."""
        raw = _plan_shape(spec, graph)
        d = int(raw.max_degree)
        return PlanShape(
            num_vertices=raw.num_vertices,
            padded_edges=raw.padded_edges,
            max_degree=max(8, 1 << (d - 1).bit_length()) if d > 0 else d)

    def get(self, spec: ColoringSpec, graph_or_shape
            ) -> Tuple[ColoringPlan, bool, int]:
        """The cached plan serving ``(spec, envelope)`` — built on
        first use, LRU-refreshed on every hit. Returns
        ``(plan, was_hit, evictions)``. Building happens outside the
        cache lock (it is the slow path)."""
        shape = (graph_or_shape if isinstance(graph_or_shape, PlanShape)
                 else self.envelope(spec, graph_or_shape))
        key = (spec, shape)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                return plan, True, 0
        plan = compile_plan(spec, shape, device=self.device)
        with self._lock:
            raced = self._plans.get(key)
            if raced is not None:
                return raced, True, 0
            self._plans[key] = plan
            evicted = 0
            while len(self._plans) > self.cache_size:
                self._plans.popitem(last=False)
                evicted += 1
        return plan, False, evicted

    def __len__(self) -> int:
        return len(self._plans)


# --------------------------------------------------------------------------
# the synchronous service (flush-atomic stats)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServedReport:
    """One served request: the report plus the service-side bookkeeping
    (which cache key it rode, whether the plan was built for it, and
    whether it went through a ``plan.map`` micro-batch)."""

    report: ColoringReport
    key: Tuple[ColoringSpec, PlanShape]
    cache_hit: bool
    batched: bool
    latency_s: float


class ColoringService:
    """An in-process coloring server with a plan LRU cache.

    cache_size   max resident plans; least-recently-used plans evict.
    default_spec spec applied to bare-graph requests (default:
                 ``ColoringSpec()`` — iterative/d1/sort).
    clock        monotonic float-seconds callable (injectable — tests
                 drive a fake clock; default ``time.perf_counter``).
    device       where plans run (``None`` = the card).

    Stats discipline: latency/cache counters commit **atomically per
    flush** through :meth:`_commit` — one locked update per ``color``
    call or per ``color_batch`` group, never per enqueue, so a concurrent
    ``stats()`` reader always sees requests == recorded latencies.
    """

    def __init__(self, *, cache_size: int = 32,
                 default_spec: Optional[ColoringSpec] = None,
                 latency_window: int = 4096,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceSpec = None):
        self.default_spec = default_spec or ColoringSpec()
        self._cache = PlanCache(cache_size=cache_size, device=device)
        self._clock = clock or time.perf_counter
        # sliding latency window: a long-lived service must not grow one
        # float per request forever, and stats() must not re-percentile an
        # unbounded history — counters/throughput stay exact over the full
        # lifetime, percentiles cover the last `latency_window` requests
        self._lat: deque = deque(maxlen=int(latency_window))
        self._counters = dict(requests=0, cache_hits=0, cache_misses=0,
                              evictions=0, batched_requests=0,
                              micro_batches=0)
        self._t_serving = 0.0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- the cache
    @property
    def cache_size(self) -> int:
        return self._cache.cache_size

    def envelope(self, spec: ColoringSpec, graph) -> PlanShape:
        """The bucket envelope a request is served under (== cache key
        shape); see :meth:`PlanCache.envelope`."""
        return self._cache.envelope(spec, graph)

    def plan_for(self, spec: ColoringSpec, graph_or_shape
                 ) -> Tuple[ColoringPlan, bool]:
        """The cached plan serving ``(spec, envelope)``. Returns
        ``(plan, was_cache_hit)``; the lookup's cache counters commit as
        one atomic update."""
        plan, hit, ev = self._cache.get(spec, graph_or_shape)
        self._commit(hits=int(hit), misses=int(not hit), evictions=ev)
        return plan, hit

    # ----------------------------------------------------------- the serving
    def _norm(self, req: Request) -> Tuple[object, ColoringSpec]:
        if isinstance(req, tuple) and len(req) == 2 \
                and isinstance(req[1], ColoringSpec):
            return req
        return req, self.default_spec

    def color(self, graph, spec: Optional[ColoringSpec] = None,
              **runtime) -> ServedReport:
        """Serve one request (``runtime`` kwargs flow to the plan — e.g.
        the ``"recolor"`` strategy's ``colors=``/``seed=`` warm start)."""
        spec = spec or self.default_spec
        t0 = self._clock()
        plan, hit, ev = self._cache.get(spec, graph)
        report = plan(graph, **runtime)
        dt = self._clock() - t0
        self._commit(n=1, latencies=(dt,), serving_s=dt, hits=int(hit),
                     misses=int(not hit), evictions=ev)
        return ServedReport(report=report, key=(spec, plan.statics),
                            cache_hit=hit, batched=False, latency_s=dt)

    def color_batch(self, requests: Sequence[Request]) -> list:
        """Serve a batch: requests sharing a cache key micro-batch through
        one ``plan.map`` call (strategies that support it); the rest loop
        over their cached plan. Results come back in
        submission order as :class:`ServedReport`s; stats commit once per
        flushed group."""
        reqs = [self._norm(r) for r in requests]
        groups: "OrderedDict[tuple, list]" = OrderedDict()
        for i, (g, spec) in enumerate(reqs):
            key = (spec, self.envelope(spec, g))
            groups.setdefault(key, []).append(i)
        out: list = [None] * len(reqs)
        for key, idxs in groups.items():
            spec, shape = key
            t0 = self._clock()
            plan, hit, ev = self._cache.get(spec, shape)
            if plan.strategy.supports_map and len(idxs) > 1:
                reports = plan.map([reqs[i][0] for i in idxs])
                dt = self._clock() - t0
                per = dt / len(idxs)
                for i, rep in zip(idxs, reports):
                    out[i] = ServedReport(report=rep, key=key,
                                          cache_hit=hit, batched=True,
                                          latency_s=per)
                self._commit(n=len(idxs), latencies=[per] * len(idxs),
                             serving_s=dt, hits=int(hit),
                             misses=int(not hit), evictions=ev,
                             micro_batches=1, batched=len(idxs))
            else:
                lats: List[float] = []
                for j, i in enumerate(idxs):
                    t1 = self._clock()
                    rep = plan(reqs[i][0])
                    now = self._clock()
                    # the group's first request carries the plan lookup /
                    # compile cost, matching color() and the map path —
                    # stats stay comparable across serving paths
                    d1 = (now - t0) if j == 0 else (now - t1)
                    lats.append(d1)
                    out[i] = ServedReport(report=rep, key=key,
                                          cache_hit=hit or j > 0,
                                          batched=False, latency_s=d1)
                self._commit(n=len(idxs), latencies=lats,
                             serving_s=sum(lats), hits=int(hit),
                             misses=int(not hit), evictions=ev)
        return out

    def _commit(self, *, n: int = 0, latencies: Sequence[float] = (),
                serving_s: float = 0.0, hits: int = 0, misses: int = 0,
                evictions: int = 0, micro_batches: int = 0,
                batched: int = 0) -> None:
        """The ONE stats mutation point: every counter update for a flush
        (or a standalone plan lookup) lands in a single critical section.
        Per-enqueue mutation is exactly the race this class used to have —
        a reader between a latency append and its counter increment saw
        requests != latencies — so all paths route here."""
        with self._lock:
            c = self._counters
            c["requests"] += n
            c["cache_hits"] += hits
            c["cache_misses"] += misses
            c["evictions"] += evictions
            c["micro_batches"] += micro_batches
            c["batched_requests"] += batched
            self._lat.extend(latencies)
            self._t_serving += serving_s

    # -------------------------------------------------------------- the stats
    def stats(self) -> dict:
        """Aggregate service stats: request/cache counters, resident plan
        count, latency summary in ms (over the sliding ``latency_window``),
        and end-to-end throughput (over the full lifetime)."""
        with self._lock:
            s = dict(self._counters)
            lat = list(self._lat)
            t_serving = self._t_serving
        s["resident_plans"] = len(self._cache)
        s["latency"] = _latency_summary(lat)
        s["throughput_gps"] = (s["requests"] / t_serving
                               if t_serving > 0 else 0.0)
        return s


# --------------------------------------------------------------------------
# the async service
# --------------------------------------------------------------------------
class AdmissionError(RuntimeError):
    """Raised by ``submit``/``submit_delta`` when the global queue depth is
    at capacity — the caller sheds load or retries after a pump."""


class ServeHandle:
    """A pending request's completion handle.

    ``done`` flips when the request's flush resolves it; :meth:`result`
    returns the :class:`AsyncServed` (or raises the flush's error). With
    no timeout the request must already be served — ``pump()``/``drain()``
    the service, or ``start()`` its worker thread and pass a timeout."""

    __slots__ = ("_ev", "_out", "_err")

    def __init__(self):
        self._ev = threading.Event()
        self._out = None
        self._err: Optional[BaseException] = None

    def _resolve(self, out=None, err: Optional[BaseException] = None):
        self._out, self._err = out, err
        self._ev.set()

    @property
    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if timeout is not None:
            self._ev.wait(timeout)
        if not self._ev.is_set():
            raise RuntimeError(
                "request not served yet: pump()/drain() the service, or "
                "start() its worker thread and pass result(timeout=...)")
        if self._err is not None:
            raise self._err
        return self._out


@dataclasses.dataclass(frozen=True)
class AsyncServed:
    """One asynchronously served request: the result plus the scheduling
    facts (which flush reason released it, how long it queued)."""

    kind: str                    # "color" | "delta"
    tenant: str
    result: object               # ColoringReport | DeltaReport
    cache_hit: Optional[bool]    # None for stream deltas (no plan cache)
    batched: bool
    flush_reason: str
    queue_age_s: float           # enqueue -> flush start
    latency_s: float             # enqueue -> result ready

    @property
    def report(self):
        return self.result


@dataclasses.dataclass
class _Pending:
    kind: str
    tenant: str
    key: tuple
    enqueue_t: float
    handle: ServeHandle
    graph: object = None
    spec: Optional[ColoringSpec] = None
    inserts: Optional[np.ndarray] = None
    deletes: Optional[np.ndarray] = None


class AsyncColoringService:
    """Async, multi-tenant, observable, restartable coloring service.

    default_spec     spec for bare ``submit`` calls;
    cache_size       resident plans (LRU);
    max_queue_depth  bound on requests admitted but not yet flushed —
                     ``submit`` raises :class:`AdmissionError` beyond it;
    tenant_quantum   DRR quantum: requests a backlogged tenant may admit
                     into open batches per scheduler turn;
    max_batch        micro-batch size that triggers a ``"size"`` flush;
    max_delay_s      the deadline budget: an open batch older than this
                     flushes on the next turn (reason ``"deadline"``); no
                     request's queue age exceeds it by more than one
                     in-flight flush (``metrics`` records ``max_exec_s``,
                     the stall bound);
    clock            injectable monotonic clock (fake-clock tests);
    metrics          a :class:`WindowedMetrics` (default: fresh, on the
                     same clock);
    device           where plans and streams run (``None`` = the card).

    Drive it inline (``pump()`` per scheduler turn, ``drain()`` to
    finish), or call ``start()`` for a background worker thread.
    """

    def __init__(self, *, default_spec: Optional[ColoringSpec] = None,
                 cache_size: int = 32, max_queue_depth: int = 1024,
                 tenant_quantum: int = 4, max_batch: int = 8,
                 max_delay_s: float = 0.005,
                 clock: Optional[Callable[[], float]] = None,
                 metrics: Optional[WindowedMetrics] = None,
                 stream_edge_headroom: float = 1.5,
                 stream_degree_headroom: float = 1.5,
                 device: DeviceSpec = None):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if tenant_quantum < 1:
            raise ValueError("tenant_quantum must be >= 1")
        self.default_spec = default_spec or ColoringSpec()
        self.plans = PlanCache(cache_size=cache_size, device=device)
        self.device = self.plans.device
        self.max_queue_depth = int(max_queue_depth)
        self.tenant_quantum = int(tenant_quantum)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self._clock = clock or time.perf_counter
        self.metrics = metrics or WindowedMetrics(clock=self._clock)
        self._stream_headroom = (float(stream_edge_headroom),
                                 float(stream_degree_headroom))
        self._lock = threading.Lock()        # queues/batches/depth state
        self._pump_lock = threading.Lock()   # serializes flush callers
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._open: "OrderedDict[tuple, List[_Pending]]" = OrderedDict()
        self._depth = 0
        self._streams: Dict[str, DynamicColoring] = {}
        self._stream_specs: Dict[str, ColoringSpec] = {}
        self._stream_tr: Dict[str, int] = {}
        self.tenant_served: Dict[str, int] = {}
        self._ckpt_step = -1
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()

    # ------------------------------------------------------------- admission
    @property
    def backlog(self) -> int:
        """Requests admitted but not yet flushed (queued + open batches)."""
        return self._depth

    def _enqueue(self, p: _Pending) -> ServeHandle:
        with self._lock:
            if self._depth >= self.max_queue_depth:
                self.metrics.record_rejected()
                raise AdmissionError(
                    f"queue depth {self._depth} at capacity "
                    f"{self.max_queue_depth}; pump()/drain() or shed load")
            self._queues.setdefault(p.tenant, deque()).append(p)
            self._deficit.setdefault(p.tenant, 0.0)
            self._depth += 1
        return p.handle

    def submit(self, graph, spec: Optional[ColoringSpec] = None, *,
               tenant: str = "default") -> ServeHandle:
        """Admit one coloring request onto ``tenant``'s queue. Returns a
        :class:`ServeHandle` immediately; the request executes in a later
        flush (micro-batched with same-``(spec, envelope)`` peers)."""
        spec = spec or self.default_spec
        key = ("color", spec, self.plans.envelope(spec, graph))
        return self._enqueue(_Pending(
            kind="color", tenant=tenant, key=key, enqueue_t=self._clock(),
            handle=ServeHandle(), graph=graph, spec=spec))

    def submit_delta(self, tenant: str, inserts=None,
                     deletes=None) -> ServeHandle:
        """Admit one edge-delta batch for ``tenant``'s open stream. Deltas
        ride the same tenant queue as coloring requests (fair interleaving)
        and apply to the stream strictly in submission order."""
        if tenant not in self._streams:
            raise KeyError(f"no open stream for tenant {tenant!r}; call "
                           "open_stream first")
        return self._enqueue(_Pending(
            kind="delta", tenant=tenant, key=("stream", tenant),
            enqueue_t=self._clock(), handle=ServeHandle(),
            inserts=None if inserts is None else np.asarray(inserts),
            deletes=None if deletes is None else np.asarray(deletes)))

    # --------------------------------------------------------------- streams
    def open_stream(self, tenant: str, graph,
                    spec: Optional[ColoringSpec] = None,
                    **dyn_kwargs) -> DynamicColoring:
        """Open ``tenant``'s stream: cold-start a
        :class:`DynamicColoring` (synchronously — the initial coloring is
        the stream's creation cost) that subsequent ``submit_delta``
        batches repair incrementally. One stream per tenant."""
        if tenant in self._streams:
            raise ValueError(f"tenant {tenant!r} already has an open stream")
        if "/" in tenant or "__" in tenant:
            raise ValueError("tenant names must avoid '/' and '__' (the "
                             f"checkpoint path encoding): {tenant!r}")
        spec = spec or ColoringSpec(strategy="recolor",
                                    engine=self.default_spec.engine)
        eh, dh = self._stream_headroom
        dyn_kwargs.setdefault("edge_headroom", eh)
        dyn_kwargs.setdefault("degree_headroom", dh)
        dyn_kwargs.setdefault("device", self.device)
        dyn = DynamicColoring(graph, spec, **dyn_kwargs)
        self._streams[tenant] = dyn
        self._stream_specs[tenant] = spec
        self._stream_tr[tenant] = dyn.plan.traces + dyn.recompiles
        return dyn

    def stream(self, tenant: str) -> DynamicColoring:
        """The live stream of ``tenant`` (read access: ``.graph``,
        ``.colors``, ``.num_colors``...)."""
        return self._streams[tenant]

    @property
    def stream_tenants(self) -> Tuple[str, ...]:
        return tuple(sorted(self._streams))

    # ------------------------------------------------------------- scheduling
    def _admit(self) -> None:
        """One deficit-round-robin cycle: every backlogged tenant gains
        ``tenant_quantum`` deficit and admits that many requests (FIFO)
        from its queue into the open batches. Idle tenants' deficit resets
        — DRR's classic rule, so quiet tenants don't bank unfair bursts."""
        for tenant in list(self._queues):
            q = self._queues[tenant]
            if not q:
                self._deficit[tenant] = 0.0
                continue
            self._deficit[tenant] += self.tenant_quantum
            take = min(len(q), int(self._deficit[tenant]))
            for _ in range(take):
                p = q.popleft()
                self._open.setdefault(p.key, []).append(p)
            self._deficit[tenant] -= take

    def _take_due(self, force: bool) -> List[Tuple[tuple, list, str]]:
        """Pop every batch that must flush: full ``max_batch`` chunks
        (reason ``"size"``), batches whose oldest request aged past
        ``max_delay_s`` (``"deadline"``), and — under ``force`` — whatever
        remains (``"drain"``). Order within a key is always preserved."""
        out: List[Tuple[tuple, list, str]] = []
        now = self._clock()
        for key in list(self._open):
            batch = self._open[key]
            while len(batch) >= self.max_batch:
                out.append((key, batch[:self.max_batch], "size"))
                batch = batch[self.max_batch:]
            if batch:
                if now - batch[0].enqueue_t >= self.max_delay_s:
                    out.append((key, batch, "deadline"))
                    batch = []
                elif force:
                    out.append((key, batch, "drain"))
                    batch = []
            if batch:
                self._open[key] = batch
            else:
                del self._open[key]
        return out

    def pump(self) -> int:
        """One scheduler turn: DRR-admit, then flush every due batch.
        Returns the number of requests flushed. Safe to call from one
        caller at a time (a worker thread or the submitting thread);
        callers serialize on an internal lock."""
        with self._pump_lock:
            with self._lock:
                self._admit()
                due = self._take_due(force=False)
            n = 0
            for key, batch, reason in due:
                n += self._flush(key, batch, reason)
            return n

    def drain(self) -> int:
        """Serve everything admitted so far: repeat scheduler turns with
        forced flushing until no work remains. Returns requests served."""
        total = 0
        while True:
            with self._pump_lock:
                with self._lock:
                    self._admit()
                    due = self._take_due(force=True)
                    empty = not due and self._depth == 0
                for key, batch, reason in due:
                    total += self._flush(key, batch, reason)
            if not due:
                if empty:
                    return total
                # tenant queues still hold work beyond this cycle's deficit
                continue

    # ---------------------------------------------------------- the executor
    def _flush(self, key: tuple, batch: List[_Pending], reason: str) -> int:
        """Execute one micro-batch and commit its metrics atomically."""
        t0 = self._clock()
        try:
            if key[0] == "color":
                served = self._flush_color(key, batch, reason, t0)
            else:
                served = self._flush_stream(key, batch, reason, t0)
        except Exception as e:  # resolve every handle; the service survives
            for p in batch:
                if not p.handle.done:
                    p.handle._resolve(err=e)
            served = 0
        with self._lock:
            self._depth -= len(batch)
            for p in batch:
                self.tenant_served[p.tenant] = \
                    self.tenant_served.get(p.tenant, 0) + 1
        return served

    def _flush_color(self, key, batch, reason, t0) -> int:
        _, spec, shape = key
        plan, hit, _ = self.plans.get(spec, shape)
        tr0 = plan.traces
        use_map = len(batch) > 1 and plan.strategy.supports_map
        if use_map:
            # the port's map runs the one program per graph, so a batch
            # of any occupancy reuses it: no padding to max_batch
            reports = plan.map([p.graph for p in batch])
        else:
            reports = [plan(p.graph) for p in batch]
        t1 = self._clock()
        lats = [t1 - p.enqueue_t for p in batch]
        ages = [t0 - p.enqueue_t for p in batch]
        for p, rep, lat, age in zip(batch, reports, lats, ages):
            p.handle._resolve(AsyncServed(
                kind="color", tenant=p.tenant, result=rep, cache_hit=hit,
                batched=use_map, flush_reason=reason, queue_age_s=age,
                latency_s=lat))
        self.metrics.record_flush(
            reason, latencies=lats, queue_ages=ages, exec_s=t1 - t0,
            cache_hit=hit, retraces=plan.traces - tr0, batched=use_map)
        return len(batch)

    def _flush_stream(self, key, batch, reason, t0) -> int:
        tenant = key[1]
        dyn = self._streams[tenant]
        outs = []
        for p in batch:  # strictly in submission order — stream semantics
            outs.append(dyn.apply_batch(inserts=p.inserts,
                                        deletes=p.deletes))
        t1 = self._clock()
        lats = [t1 - p.enqueue_t for p in batch]
        ages = [t0 - p.enqueue_t for p in batch]
        for p, dr, lat, age in zip(batch, outs, lats, ages):
            p.handle._resolve(AsyncServed(
                kind="delta", tenant=tenant, result=dr, cache_hit=None,
                batched=len(batch) > 1, flush_reason=reason,
                queue_age_s=age, latency_s=lat))
        tr = dyn.plan.traces + dyn.recompiles
        retraces = max(0, tr - self._stream_tr[tenant])
        self._stream_tr[tenant] = tr
        self.metrics.record_flush(
            reason, latencies=lats, queue_ages=ages, exec_s=t1 - t0,
            retraces=retraces, batched=len(batch) > 1, stream=True)
        return len(batch)

    # ------------------------------------------------------------ the worker
    def start(self, tick_s: float = 0.001) -> None:
        """Spawn the background scheduler thread (pumps until
        :meth:`stop`). Don't combine with a fake clock — deadline ages
        would never advance. A flush that raises resolves its handles
        with the error; the thread keeps serving."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop_ev.clear()

        def loop():
            while not self._stop_ev.is_set():
                if self.pump() == 0:
                    self._stop_ev.wait(tick_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="coloring-serve")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_ev.set()
        self._thread.join()
        self._thread = None

    # --------------------------------------------------------- checkpointing
    def checkpoint(self, root: str, *, step: Optional[int] = None,
                   keep: int = 3) -> int:
        """Snapshot every tenant stream + the cumulative metrics to
        ``root`` (atomic, via ``repro_torch.train.checkpoint.save``). Only
        quiescent state checkpoints: the backlog must be zero (``drain()``
        first) — queued request graphs are caller-owned and not part of
        the restartable state. Returns the checkpoint step."""
        if self.backlog:
            raise RuntimeError(
                f"cannot checkpoint with {self.backlog} requests in "
                "flight; drain() first")
        from ..train import checkpoint as ckpt
        if step is None:
            step = self._ckpt_step + 1
        tree = {
            "streams": {t: dyn.state_dict()
                        for t, dyn in self._streams.items()},
            "metrics": self.metrics.state_dict(),
        }
        meta = {
            "schema": 1,
            "stream_specs": {t: s.to_dict()
                             for t, s in self._stream_specs.items()},
        }
        ckpt.save(root, step, tree, keep=keep, meta=meta)
        self._ckpt_step = step
        return step

    @classmethod
    def restore(cls, root: str, *, step: Optional[int] = None,
                **kwargs) -> "AsyncColoringService":
        """Rebuild a service from :meth:`checkpoint` output (this
        package's or the reference's): every tenant stream resumes
        bit-identically (colors, graph, plan envelope, palette bound) and
        the cumulative metrics counters continue from their checkpointed
        values. ``kwargs`` are the service's process config
        (``max_batch``, ``max_delay_s``, ``device``, ... — deliberately
        not checkpointed)."""
        from ..train import checkpoint as ckpt
        tree, manifest, step = ckpt.load(root, step=step)
        meta = manifest.get("meta", {})
        if meta.get("schema") != 1:
            raise ValueError(f"unknown service checkpoint schema in {root}: "
                             f"{meta.get('schema')!r}")
        self = cls(**kwargs)
        self.metrics.load_state(tree.get("metrics", {}))
        for tenant, state in tree.get("streams", {}).items():
            spec = ColoringSpec.from_dict(meta["stream_specs"][tenant])
            dyn = DynamicColoring.from_state(state, spec,
                                             device=self.device)
            self._streams[tenant] = dyn
            self._stream_specs[tenant] = spec
            self._stream_tr[tenant] = dyn.plan.traces + dyn.recompiles
        self._ckpt_step = step
        return self


# ---------------------------------------------------------------- CLI smoke
def main(argv=None):
    ap = argparse.ArgumentParser(
        description="coloring service smoke: open-loop multi-tenant "
                    "serving through the async admission loop, then a "
                    "streaming + checkpoint/restore demo")
    ap.add_argument("--smoke", action="store_true",
                    help="small preset (scale 8, 16 requests)")
    ap.add_argument("--family", default="RMAT-G",
                    choices=["RMAT-ER", "RMAT-G", "RMAT-B"])
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8,
                    help="micro-batch size (the 'size' flush trigger)")
    ap.add_argument("--deadline-ms", type=float, default=20.0,
                    help="deadline flush budget per open batch")
    ap.add_argument("--queue-depth", type=int, default=256)
    ap.add_argument("--strategy", default="dataflow")
    ap.add_argument("--engine", default="sort")
    ap.add_argument("--cache-size", type=int, default=8)
    ap.add_argument("--stream-batches", type=int, default=4,
                    help="edge-delta batches for the streaming + restore "
                         "demo (0 disables)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for the restore demo (default: a "
                         "temporary directory)")
    ap.add_argument("--device", default=None,
                    help="where plans and streams run: 'cuda' (the "
                         "default, needs a card) or 'cpu'")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scale, args.requests = min(args.scale, 8), min(args.requests, 16)

    from ..core import rmat, validate_coloring

    spec = ColoringSpec(strategy=args.strategy, engine=args.engine,
                        concurrency=64)
    svc = AsyncColoringService(
        default_spec=spec, cache_size=args.cache_size,
        max_batch=args.batch, max_delay_s=args.deadline_ms / 1e3,
        max_queue_depth=args.queue_depth, device=args.device)
    graphs = [rmat.paper_graph(args.family, scale=args.scale, seed=s)
              for s in range(args.requests)]
    print(f"[serve] family={args.family} scale={args.scale} "
          f"requests={args.requests} tenants={args.tenants} "
          f"batch={args.batch} deadline={args.deadline_ms}ms "
          f"strategy={args.strategy} engine={args.engine} "
          f"device={svc.device}")

    t0 = time.perf_counter()
    handles = []
    for i, g in enumerate(graphs):
        while True:
            try:
                handles.append(svc.submit(g, tenant=f"t{i % args.tenants}"))
                break
            except AdmissionError:
                svc.pump()
        svc.pump()
    svc.drain()
    wall = time.perf_counter() - t0
    served = [h.result() for h in handles]
    for s_, g in zip(served, graphs):
        assert validate_coloring(g, s_.report.colors)
    snap = svc.metrics.snapshot()
    cum, win = snap["cumulative"], snap["window"]
    print(f"[serve] served {cum['requests']} requests in {wall:.2f}s "
          f"({cum['requests'] / wall:.1f} graphs/s) across "
          f"{len(svc.tenant_served)} tenants")
    print(f"[serve] flushes: {cum['flushes']} "
          f"(size={cum['flush_reasons']['size']} "
          f"deadline={cum['flush_reasons']['deadline']} "
          f"drain={cum['flush_reasons']['drain']}); "
          f"cache hit rate={snap['cache_hit_rate']:.2f}; "
          f"retraces={cum['retraces']}")
    if win["count"]:
        print(f"[serve] latency: p50={win['p50_ms']:.1f}ms "
              f"p99={win['p99_ms']:.1f}ms max={win['max_ms']:.1f}ms "
              f"(max includes the compile); max queue age "
              f"{cum['max_queue_age_s'] * 1e3:.1f}ms")

    if args.stream_batches > 0:
        g = graphs[0]
        rng = np.random.default_rng(0)
        svc.open_stream("stream", g,
                        ColoringSpec(strategy="recolor", engine=args.engine,
                                     concurrency=64))
        m = max(1, g.num_edges // 100)  # ~1% edge-delta batches
        print(f"[serve] streaming: {args.stream_batches} delta batches of "
              f"~{m} inserts + ~{m} deletes (1% of |E|)")
        for b in range(args.stream_batches):
            V = g.num_vertices
            ins = np.stack([rng.integers(0, V, m),
                            rng.integers(0, V, m)], 1)
            cur = svc.stream("stream").graph.undirected_edges()
            dels = cur[rng.integers(0, cur.shape[0], m)]
            h = svc.submit_delta("stream", inserts=ins, deletes=dels)
            svc.drain()
            dr = h.result().result
            dyn = svc.stream("stream")
            assert validate_coloring(dyn.graph, dyn.colors)
            print(f"[serve]   batch {b}: +{dr.inserted}/-{dr.deleted} "
                  f"edges, seed={dr.seed_size}, repaired={dr.repaired}, "
                  f"colors={dyn.num_colors} (bound {dyn.color_bound}), "
                  f"{dr.wall_time_s * 1e3:.1f}ms")
        # the restart story, live: checkpoint, restore, bit-compare
        import tempfile
        root = args.checkpoint_dir or tempfile.mkdtemp(prefix="serve_ckpt_")
        step = svc.checkpoint(root)
        svc2 = AsyncColoringService.restore(
            root, default_spec=spec, max_batch=args.batch,
            max_delay_s=args.deadline_ms / 1e3, device=args.device)
        same = np.array_equal(svc.stream("stream").colors,
                              svc2.stream("stream").colors)
        print(f"[serve] checkpoint step {step} -> restore: "
              f"bit-identical colors={same}, metrics requests="
              f"{svc2.metrics.snapshot()['cumulative']['requests']}")
        assert same
        dyn = svc.stream("stream")
        print(f"[serve] streaming done: colors={dyn.num_colors}, "
              f"plan builds={dyn.plan.traces} (1 = every repair reused "
              f"one program), recompiles={dyn.recompiles}")
    return svc


if __name__ == "__main__":
    main()
