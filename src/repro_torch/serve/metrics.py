"""Windowed serving metrics — the observability half of the serving layer
(PyTorch port of ``repro.serve.metrics``; host-side, numpy only).

One :class:`WindowedMetrics` instance rides
:class:`repro_torch.serve.coloring.AsyncColoringService` and answers three
questions:

* **latency** — p50/p99/mean/max over a sliding *time* window, plus the
  max queue age ever observed (the deadline-flush guarantee is stated
  against it: no request waits past its budget plus one in-flight flush);
* **cache/compile health** — cumulative plan-cache hit/miss counts and
  program rebuilds ("retraces"); a rebuild in steady state means the
  plan-cache envelope quantization regressed;
* **flush accounting** — a histogram over :data:`FLUSH_REASONS`
  (``size`` = the micro-batch filled, ``deadline`` = the oldest request
  aged past the flush budget, ``drain`` = an explicit flush-everything).

**Atomicity.** All counters for one flush commit in ONE
:meth:`record_flush` call under one lock, so a concurrent
:meth:`snapshot` never sees a half-recorded flush.

**Restart.** :meth:`state_dict` / :meth:`load_state` round-trip the
cumulative counters as a flat array dict, in the reference's keys, through
``repro_torch.train.checkpoint``. Only :data:`RESTART_INVARIANT` counters
are guaranteed equal between a killed-and-restored run and an unkilled
one: rebuilds and cache misses are process-local, latencies wall-clock.

The clock is injectable (``clock=``), so deadline and window tests drive a
fake monotonic clock and never sleep.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

FLUSH_REASONS = ("size", "deadline", "drain")

# counters a kill + checkpoint/restore cycle must NOT perturb (everything
# deterministic about what was served; excludes retraces/cache/latency,
# which are legitimately process-local)
RESTART_INVARIANT = ("requests", "flushes", "batched_requests",
                     "stream_deltas", "rejected")

_COUNTERS = RESTART_INVARIANT + ("cache_hits", "cache_misses", "retraces")


class WindowedMetrics:
    """Sliding-window latency percentiles + cumulative serving counters.

    window_s      time width of the percentile window;
    max_samples   hard cap on retained samples (memory bound for a
                  long-lived service under heavy rates);
    clock         monotonic float-seconds callable (injectable for tests).
    """

    def __init__(self, *, window_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None,
                 max_samples: int = 65536):
        self.window_s = float(window_s)
        self._clock = clock or time.perf_counter
        self._max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: deque = deque()  # (t, latency_s, queue_age_s)
        self._c = {k: 0 for k in _COUNTERS}
        self._flush_reasons = {r: 0 for r in FLUSH_REASONS}
        self._max_queue_age_s = 0.0
        self._exec_s = 0.0      # total in-flush execution time
        self._max_exec_s = 0.0  # longest single flush (the stall bound)

    # ------------------------------------------------------------- recording
    def record_flush(self, reason: str, *, latencies: Sequence[float],
                     queue_ages: Sequence[float], exec_s: float,
                     cache_hit: Optional[bool] = None, retraces: int = 0,
                     batched: bool = False, stream: bool = False) -> None:
        """Commit ONE flush atomically: n requests' latencies/queue ages,
        the flush reason, execution time, and (optional) plan-cache and
        retrace accounting — a single critical section, so a concurrent
        :meth:`snapshot` never observes a half-recorded flush."""
        if reason not in self._flush_reasons:
            raise ValueError(f"unknown flush reason {reason!r}; known: "
                             f"{FLUSH_REASONS}")
        now = self._clock()
        with self._lock:
            self._c["requests"] += len(latencies)
            self._c["flushes"] += 1
            self._flush_reasons[reason] += 1
            if batched:
                self._c["batched_requests"] += len(latencies)
            if stream:
                self._c["stream_deltas"] += len(latencies)
            if cache_hit is not None:
                self._c["cache_hits" if cache_hit else "cache_misses"] += 1
            self._c["retraces"] += int(retraces)
            self._exec_s += float(exec_s)
            self._max_exec_s = max(self._max_exec_s, float(exec_s))
            for lat, age in zip(latencies, queue_ages):
                self._samples.append((now, float(lat), float(age)))
                if age > self._max_queue_age_s:
                    self._max_queue_age_s = float(age)
            while len(self._samples) > self._max_samples:
                self._samples.popleft()

    def record_rejected(self, n: int = 1) -> None:
        """Admission-control rejections (queue full)."""
        with self._lock:
            self._c["rejected"] += int(n)

    # ------------------------------------------------------------- reporting
    def _prune(self, now: float) -> None:
        edge = now - self.window_s
        while self._samples and self._samples[0][0] < edge:
            self._samples.popleft()

    def snapshot(self) -> dict:
        """The exported metrics: window percentiles + cumulative counters.

        ``window``      p50/p99/mean/max latency and max queue age (ms)
                        over the last ``window_s`` seconds;
        ``cumulative``  lifetime counters, the flush-reason histogram,
                        total/max flush execution time, max queue age ever;
        ``cache_hit_rate``  lifetime hits / (hits + misses), or ``None``
                        before the first plan lookup.
        """
        now = self._clock()
        with self._lock:
            self._prune(now)
            lats = np.asarray([s[1] for s in self._samples], np.float64)
            ages = np.asarray([s[2] for s in self._samples], np.float64)
            c = dict(self._c)
            reasons = dict(self._flush_reasons)
            max_age, exec_s = self._max_queue_age_s, self._exec_s
            max_exec = self._max_exec_s
        window = {"count": int(lats.size)}
        if lats.size:
            window.update(
                p50_ms=float(np.percentile(lats, 50) * 1e3),
                p99_ms=float(np.percentile(lats, 99) * 1e3),
                mean_ms=float(lats.mean() * 1e3),
                max_ms=float(lats.max() * 1e3),
                max_queue_age_ms=float(ages.max() * 1e3))
        looked = c["cache_hits"] + c["cache_misses"]
        return {
            "window": window,
            "cumulative": {**c, "flush_reasons": reasons,
                           "exec_s": exec_s, "max_exec_s": max_exec,
                           "max_queue_age_s": max_age},
            "cache_hit_rate": (c["cache_hits"] / looked if looked else None),
        }

    # ---------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """Cumulative counters as a flat array dict (a
        ``repro_torch.train.checkpoint`` tree). Window samples are wall-clock
        and deliberately not checkpointed."""
        with self._lock:
            out = {k: np.int64(v) for k, v in self._c.items()}
            out.update({f"flush-{r}": np.int64(n)
                        for r, n in self._flush_reasons.items()})
            out["max-queue-age-s"] = np.float64(self._max_queue_age_s)
            out["exec-s"] = np.float64(self._exec_s)
        return out

    def load_state(self, state: dict) -> None:
        """Resume cumulative counters from :meth:`state_dict` output (the
        restored process keeps accumulating on top)."""
        with self._lock:
            for k in self._c:
                if k in state:
                    self._c[k] = int(state[k])
            for r in self._flush_reasons:
                key = f"flush-{r}"
                if key in state:
                    self._flush_reasons[r] = int(state[key])
            self._max_queue_age_s = float(state.get("max-queue-age-s", 0.0))
            self._exec_s = float(state.get("exec-s", 0.0))
