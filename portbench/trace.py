"""What a traced run reads: the device's timeline from ``torch.profiler`` and
the kernels' launch geometry from the program's ``kernel_scope`` hook.

* :class:`KernelLog` — a recorder for ``repro_torch.kernels.ops``: while
  open, it keeps ``(kernel, rows, width, words)`` of every launch on the
  card; every other hook passes through.
* :class:`Profiled` — the window under ``torch.profiler`` (host ops and
  device activity), inside a ``portbench.window`` annotation that marks the
  traced span on the device's clock; the trace is read back into
  :class:`Parsed` and its file removed.
* :class:`HostSampler` — what the host was doing: every few ms, the
  innermost frame of the program or the benchmark on each thread that is
  not waiting.
* :class:`Parsed` — device intervals in the span, their union (``busy_s``),
  the idle time by what the host was doing across it (the frames sampled
  in each gap; a gap shorter than a sample takes the nearest one), and the
  ``breakdown`` the result line carries.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
SAMPLE_S = 0.002
_OWN_FILES = ("/repro_torch/", "/portbench/")


class _PassThrough:
    @staticmethod
    def result(out):
        return out


class KernelLog:
    """The launch geometry of every kernel on the card while ``open``."""

    def __init__(self):
        self.open = False
        self.launches: List[Tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def kernel(self, name, inputs, info):
        if (self.open and int(info.get("rows", 0)) > 0 and inputs
                and inputs[0].device.type == "cuda"):
            with self._lock:
                self.launches.append((name, int(info["rows"]),
                                      int(info.get("width", 1)),
                                      int(info.get("words", 0))))
        yield _PassThrough

    @contextlib.contextmanager
    def collective(self, kind, payload, num_devices, op=""):
        yield _PassThrough

    def state(self, tensors):
        pass

    def round(self, rnd):
        pass

    def loop_exit(self):
        pass

    def path(self, name):
        pass


class HostSampler:
    """Samples ``(time.perf_counter(), label)`` every :data:`SAMPLE_S` for
    each thread that is running: ``label`` is the innermost frame of the
    program or the benchmark (``core/graph.py:to_device``). A thread whose
    innermost frame is in ``threading`` waits, and is not sampled."""

    def __init__(self):
        self.samples: List[Tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="portbench-sampler")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(SAMPLE_S):
            now = time.perf_counter()
            for tid, f in sys._current_frames().items():
                if tid == me or f.f_code.co_filename.endswith("threading.py"):
                    continue
                while f is not None and not any(
                        o in f.f_code.co_filename for o in _OWN_FILES):
                    f = f.f_back
                if f is not None:
                    path = f.f_code.co_filename
                    for o in _OWN_FILES:
                        if o in path:
                            path = path.split(o, 1)[1]
                            if o == "/portbench/":
                                path = "portbench/" + path
                    self.samples.append((now, f"{path}:{f.f_code.co_name}"))


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start_us: float
    dur_us: float


@dataclasses.dataclass
class Parsed:
    ops: List[DeviceOp]                 # device activity inside the span
    window_s: float
    busy_s: float
    idle: List[Tuple[str, float]]       # idle seconds by host activity

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur_us * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in self.idle]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def parse(events: List[dict], samples: List[Tuple[float, str]] = (),
          host_t0: Optional[float] = None) -> Optional[Parsed]:
    """The span's device activity and idle time. ``samples`` (host clock)
    label the idle gaps; ``host_t0`` is the host clock at the span's
    start."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s, d = float(e["ts"]), float(e["dur"])
            if s + d > t0 and s < t1:
                lo, hi = max(s, t0), min(s + d, t1)
                ops.append(DeviceOp(e["name"], e["cat"], lo, hi - lo))
    busy = _union([(o.start_us, o.start_us + o.dur_us) for o in ops])
    gaps, prev = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    stamps = ([(t - host_t0) * 1e6 + t0 for t, _ in samples]
              if host_t0 is not None else [])
    idle: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        lo, hi = bisect.bisect_left(stamps, a), bisect.bisect_right(stamps, b)
        if hi == lo:  # shorter than a sample: the nearest sample's activity
            near = [i for i in (lo - 1, lo) if 0 <= i < len(stamps)
                    and abs(stamps[i] - 0.5 * (a + b)) <= 2e6 * SAMPLE_S]
            lo, hi = (near[0], near[0] + 1) if near else (0, 0)
        hit = collections.Counter(samples[i][1] for i in range(lo, hi))
        n = sum(hit.values())
        for label, k in hit.items():
            idle[label] += (b - a) * 1e-6 * k / n
        if not n:
            idle["unsampled"] += (b - a) * 1e-6
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Parsed(ops=ops, window_s=(t1 - t0) * 1e-6,
                  busy_s=sum(b - a for a, b in busy) * 1e-6, idle=top)


class Profiled:
    """The window, under the profiler when ``enabled``; ``parsed`` after."""

    def __init__(self, enabled: bool, cell):
        self.enabled, self.cell = enabled, cell
        self.parsed: Optional[Parsed] = None

    def __enter__(self):
        if not self.enabled:
            return self
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cell.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._host_t0 = time.perf_counter()
        self._sampler = HostSampler()
        self._sampler.start()
        self.cell.recorder.open = True
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self.cell.sync()
        self.cell.recorder.open = False
        self._sampler.stop()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.parsed = parse(json.load(f)["traceEvents"],
                                    self._sampler.samples, self._host_t0)
        finally:
            os.remove(path)
        return False


@dataclasses.dataclass
class ReadContext:
    """What a per-layer reader reads: the window, the parsed trace (None
    when there is none), the kernels' launch geometry in the window, and
    the device's allocation peak in it (None off the card)."""

    window: object
    trace: Optional[Parsed]
    launches: List[Tuple[str, int, int, int]]
    window_peak_bytes: Optional[int]
