"""The benchmark's run of one cell, found by name in ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``, with its plain
reference beside it in ``configs/<name>.py``) and a traffic mix
(``traffic/<name>.json``), whose ``driver`` names the module under
``drivers/`` that sets the program up and drives its window. A per-layer
metric ``<stem>.<split>`` is read by ``metrics/<stem>.<split>.py`` or, where
that file is absent, by ``metrics/<stem>.py``. Adding a cell, a traffic mix
or a metric adds files and entries; no file here changes.

A reference file defines ``reference(g, config)`` and ``control(g,
config)``, each a :class:`portbench.plain.Answer` for a
:class:`portbench.plain.DeviceCsr`. An answer is a cold request on a pool
graph, or it continues an earlier answer's state: a stream's batch names the
answer whose graph and colors it started from and carries the edge changes
it applied. The judge replays such a chain with the reference file's
``reference_after(g, config, before, prev)`` (``before`` the previous graph,
``prev`` the reference's own answer there), each graph rebuilt from the
records by :func:`portbench.plain.apply_delta`, and holds each answer to the
reference's colors, not to the program's earlier ones. A stream's traffic
gives ``batch: {inserts, deletes, chain}`` (``chain``: the batches
``control.py`` follows on each pool graph, at least as many as a run's
window makes). Its driver draws batch ``k`` after the cold start on pool
graph ``i`` with ``gen.edge_batch(csr, ..., cell.seed, i, k, ...)`` from
the harness's own chain (``csr`` the pool graph with the batches before
applied by :func:`portbench.plain.apply_delta`, never the program's graph),
so that a seed gives the same batches whatever the program does;
``control.py`` draws the same batches for ``control_after``.

:func:`run_cell` is a whole run but the look for a card: make the graphs
from the seed, set the program up, drive the window (under the profiler
when traced), free the program, judge every answer against the reference,
and return the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import gen, plain, trace

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")


class Answered(NamedTuple):
    """One request's answer as its caller got it (``colors`` None: no
    answer; ``error`` says why).

    ``after`` None: a cold request on pool graph ``index``. Otherwise the
    position, in the run's answers (the window's set-up answers first, then
    its own), of the earlier answer whose graph and colors this one
    continued; the graph is that one's with ``deletes`` and then
    ``inserts`` applied (host ``[M, 2]`` endpoint arrays or None, set
    semantics), and ``index`` names the chain's pool graph."""

    index: int                        # the pool graph it colored
    colors: Optional[np.ndarray]
    conflicts_per_round: Optional[np.ndarray]
    latency_s: Optional[float]
    error: Optional[str] = None
    after: Optional[int] = None
    inserts: Optional[np.ndarray] = None
    deletes: Optional[np.ndarray] = None


@dataclasses.dataclass
class Window:
    """What a driver's window produced: its length, the graphs that count
    toward the end-to-end metric, every answer (in flight at the close
    included), the end-to-end values by name, counters read from the
    program over the window, and the answers made in set-up that the
    window's continue from (judged, but counted toward nothing)."""

    seconds: float
    graphs: int
    answers: List[Answered]
    values: Dict[str, float]
    facts: Dict[str, float] = dataclasses.field(default_factory=dict)
    setup_answers: List[Answered] = dataclasses.field(default_factory=list)

    @property
    def requests(self) -> int:
        """Requests the device served in the traced span."""
        return sum(a.colors is not None for a in self.answers)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    device: torch.device
    csrs: List[gen.Csr]
    program_graphs: list
    recorder: Optional[trace.KernelLog] = None
    seed: int = 0                     # the run's --seed (a stream's batches)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def worker_threads_report(self):
        """Threads the program starts inside this block report their
        kernel launches to the run's recorder (traced runs only): the
        recorder is per thread, and a service's worker is not this one.
        Keep the block open until the thread has run."""
        if self.recorder is None:
            yield
            return
        rec = self.recorder

        def hook(*_):
            from repro_torch.kernels import ops
            ops.set_recorder(rec)
            sys.setprofile(None)

        threading.setprofile(hook)
        try:
            yield
        finally:
            threading.setprofile(None)


# --------------------------------------------------------------------------
# files found by name
# --------------------------------------------------------------------------
def load_bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench._by_name." + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.exists() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                     f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, kind: str, cell: str) -> List[dict]:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


# --------------------------------------------------------------------------
# the judgement
# --------------------------------------------------------------------------
def judge(ref, config: dict, csrs: List[gen.Csr], answers: List[Answered],
          device: torch.device, setup_answers: Sequence[Answered] = ()
          ) -> Dict[str, Dict[str, float]]:
    """Every answer against the reference's coloring of its graph: the
    numbers compared, each with its limit (all exact: limit 0).

    Cold answers are judged per pool graph, its reference worked out once.
    Continued answers are judged in order along their chains: each graph is
    its predecessor's with the answer's edge changes applied, and its
    reference is ``ref.reference_after(g, config, before, prev)`` from the
    predecessor's graph and the reference's own answer there. A state is
    kept only while a later answer still continues it. An answer whose
    predecessor is not among the earlier answers, or whose configuration
    has no ``reference_after``, counts as unanswered; so does every answer
    that continues it. ``setup_answers`` come first in the positions that
    ``after`` names, and are judged like the rest."""
    seq = list(setup_answers) + list(answers)
    waiting = Counter(a.after for a in seq if a.after is not None)
    states: Dict[int, Tuple[gen.Csr, plain.Answer]] = {}
    wrong = bad = history = missing = 0

    def score(g: plain.DeviceCsr, want: plain.Answer, a: Answered) -> None:
        nonlocal wrong, bad, history, missing
        if a.colors is None:
            missing += 1
            return
        got = np.asarray(a.colors)
        wrong += (int(np.count_nonzero(got != want.colors))
                  if got.shape == want.colors.shape else g.n)
        bad += plain.bad_edges(g, got)
        if want.conflicts_per_round is not None and not np.array_equal(
                np.asarray(a.conflicts_per_round), want.conflicts_per_round):
            history += 1

    by_graph: Dict[int, List[int]] = {}
    for j, a in enumerate(seq):
        if a.after is not None:
            continue
        if not 0 <= a.index < len(csrs) or (a.colors is None
                                            and not waiting[j]):
            missing += 1
        else:
            by_graph.setdefault(a.index, []).append(j)
    for i, group in sorted(by_graph.items()):
        g = plain.to_device(csrs[i], device)
        want = ref.reference(g, config)
        for j in group:
            score(g, want, seq[j])
            if waiting[j]:
                states[j] = (csrs[i], want)
        del g

    after = getattr(ref, "reference_after", None)
    for j, a in enumerate(seq):
        if a.after is None:
            continue
        p = a.after
        state = states.get(p) if after is not None and 0 <= p < j else None
        if state is not None:
            waiting[p] -= 1
            if not waiting[p]:
                del states[p]
            try:
                csr = plain.apply_delta(state[0], a.inserts, a.deletes, device)
            except ValueError:
                state = None
        if state is None:
            missing += 1
            continue
        g = plain.to_device(csr, device)
        want = after(g, config, plain.to_device(state[0], device), state[1])
        score(g, want, a)
        if waiting[j]:
            states[j] = (csr, want)
        del g
    return {"wrong_colors": {"value": wrong, "limit": 0},
            "bad_edges": {"value": bad, "limit": 0},
            "wrong_histories": {"value": history, "limit": 0},
            "unanswered": {"value": missing, "limit": 0}}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {k}: {c['value']} (limit {c['limit']})"
            for k, c in checks.items()]


def loaded_banned() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED_MODULES)


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------
def make_cell(bench: dict, name: str, seed: int, device: torch.device,
              config: Optional[dict] = None,
              traffic: Optional[dict] = None) -> Cell:
    """The cell's graphs, made on ``device`` from ``seed``. ``config`` and
    ``traffic`` replace the files' (the tests' small sizes)."""
    from repro_torch.core.graph import Graph
    w = workload(bench, name)
    config = config or load_json("configs", w["config"])
    traffic = traffic or load_json("traffic", w["traffic"])
    scale = int(config["scale"][traffic["request_scale"]])
    csrs = gen.make_pool(config["graph"], scale, int(traffic["pool"]), seed,
                         device)
    graphs = [Graph(c.num_vertices, c.row_ptr, c.col_idx) for c in csrs]
    return Cell(name, config, traffic, device, csrs, graphs, seed=int(seed))


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, *, bench: Optional[dict] = None,
             started: Optional[float] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> Dict[str, Any]:
    """One run of cell ``name``; returns the result line's object (its
    ``checks`` key last). ``started`` is the process's start on the
    ``time.perf_counter`` clock (set-up is timed from it)."""
    started = time.perf_counter() if started is None else started
    bench = bench or load_bench()
    w = workload(bench, name)
    cell = make_cell(bench, name, seed, device, config, traffic)
    driver = load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")
    ref = load_module(HERE / "configs" / f"{w['config']}.py")
    from repro_torch.kernels import ops
    if traced:
        cell.recorder = trace.KernelLog()
    before = ops.set_recorder(cell.recorder)
    try:
        state = driver.setup(cell)
        cell.sync()
        setup_s = time.perf_counter() - started
        on_card = device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        with trace.Profiled(traced, cell) as prof:
            win = driver.window(cell, state, seconds)
        window_peak = (torch.cuda.max_memory_allocated(device) if on_card
                       else 0)
        driver.close(cell, state)
    finally:
        ops.set_recorder(before)
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    lat = sorted(a.latency_s for a in win.answers if a.latency_s is not None)
    errors = [a.error for a in win.answers if a.error]
    print(f"window: {win.graphs} graphs counted in {win.seconds:.3f} s; "
          f"{len(lat)} answered"
          + (f", latency s min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} "
             f"max {lat[-1]:.4f}" if lat else "")
          + "".join(f"; {k} {v}" for k, v in win.facts.items())
          + (f"; {len(errors)} unanswered, first: {errors[0]}" if errors
             else ""), file=sys.stderr)
    checks = judge(ref, cell.config, cell.csrs, win.answers, device,
                   win.setup_answers)
    metrics = {}
    if traced:
        ctx = trace.ReadContext(window=win, trace=prof.parsed,
                                launches=cell.recorder.launches,
                                window_peak_bytes=window_peak if on_card
                                else None)
        for m in metrics_of(bench, "per_layer", name):
            value = load_module(reader_path(m["name"])).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, "end_to_end", name):
            value = setup_s if m["name"] == "setup_s" else win.values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": w["chips"] if on_card else 0,
           "memory_peak_bytes": max(peak, window_peak)}
    out: Dict[str, Any] = {
        "correct": passed(checks),
        "attempted": len(win.answers),
        "failed": checks["unanswered"]["value"],
        "metrics": metrics,
        "device": dev,
    }
    if traced and prof.parsed is not None:
        dev["busy_s"] = prof.parsed.busy_s
        dev["window_s"] = prof.parsed.window_s
        out["breakdown"] = prof.parsed.breakdown()
    out["checks"] = checks
    return out
