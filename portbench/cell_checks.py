"""The benchmark's per-cell checks, each callable on any bench dict and any
of its cells: ``(bench, cell)`` in, assertions out (with the cell's small
run, where the check reads one). The tests parametrized over
``BENCHMARK.json``'s cells call them, and so does the guard in
``test_portbench_stream.py`` on a stream cell made only of new files and
entries. Each decides by the cell's traffic and metrics, never by its name,
so a cell of a new traffic kind that passes them needs no edit here."""
import json
import re
import types

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.conftest import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# the layers of PERF.md's section 3, spelled as there; a later layer is a
# lower-case phrase of its own
LAYERS = {"service", "plan and host layout", "round loop", "engine sweep",
          "kernels", "device"}
PHRASE = re.compile(r"^[a-z0-9]+(?:[ -][a-z0-9]+)*$")
CPU = torch.device("cpu")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _cells(bench):
    return [w["name"] for w in bench["workloads"]]


def _per_layer_names(bench, cell):
    return [m["name"] for m in harness.metrics_of(bench, "per_layer", cell)]


def queued(bench, cell) -> bool:
    """Whether the cell's requests wait in a queue (it reads
    ``queue_wait_ms``); without one they run back to back from one caller,
    so their layout and sync waits fit in the window's time per graph."""
    return "queue_wait_ms" in _per_layer_names(bench, cell)


def stem(bench, cell) -> str:
    """The split of the cell's own ``layout_ms_per_graph.*`` entry."""
    got = [n.split(".", 1)[1] for n in _per_layer_names(bench, cell)
           if n.startswith("layout_ms_per_graph.")]
    assert len(got) == 1, (cell, got)
    return got[0]


# --------------------------------------------------------------------------
# entries
# --------------------------------------------------------------------------
def config_entry(bench, entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    cfg = harness.load_json("configs", entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert all(NAME.match(k) for k in entry["reduced"])
    assert cfg["scale"] and all(s <= cfg["published_scale"]
                                for s in cfg["scale"].values())
    ref = harness.load_module(harness.HERE / "configs" / f"{entry['name']}.py")
    assert callable(ref.reference) and callable(ref.control)
    assert any(w["config"] == entry["name"] for w in bench["workloads"])


def workload_entry(bench, cell):
    w = harness.workload(bench, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _line(w["why"])
    assert w["config"] in [c["name"] for c in bench["configs"]]
    traffic = harness.load_json("traffic", w["traffic"])
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    config = harness.load_json("configs", w["config"])
    assert traffic["request_scale"] in config["scale"]
    e2e = [m["name"] for m in harness.metrics_of(bench, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(bench, "per_layer", cell)
    pairs = [(x["config"], x["traffic"]) for x in bench["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def metric_entry(bench, metric):
    cells = _cells(bench)
    per_layer = metric in bench["per_layer"]
    keys = ({"name", "unit", "better", "source", "layer", "moves"} if per_layer
            else {"name", "unit", "better", "bound", "source"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert all(c in cells for c in metric.get("workloads", []))
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert names.count(metric["name"]) == 1
    if per_layer:
        assert _line(metric["layer"])
        moved = [m for m in bench["end_to_end"]
                 if m["name"] == metric["moves"]]
        assert moved, metric["moves"]
        # every cell that reads this metric reports the metric it moves
        for cell in metric.get("workloads", cells):
            assert cell in moved[0].get("workloads", cells)
        reader = harness.load_module(harness.reader_path(metric["name"]))
        assert callable(reader.read)
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def layers(bench):
    """One spelling per layer: the six of PERF.md stay as spelled there, and
    no two names are one once case, spaces and hyphens are dropped."""
    names = {m["layer"] for m in bench["per_layer"]}
    assert LAYERS <= names
    assert all(PHRASE.match(n) for n in names - LAYERS), names - LAYERS
    folded = [re.sub(r"[ -]", "", n.lower()) for n in names]
    assert len(set(folded)) == len(folded), sorted(names)


def entries(bench, cell):
    """The cell's own entries: its configuration, its workload, every
    metric it reports, and the layers they are filed under."""
    w = harness.workload(bench, cell)
    config_entry(bench, next(c for c in bench["configs"]
                             if c["name"] == w["config"]))
    workload_entry(bench, cell)
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(bench, kind, cell):
            metric_entry(bench, m)
    layers(bench)


# --------------------------------------------------------------------------
# test sizes
# --------------------------------------------------------------------------
def sizes(bench, cell):
    """``conftest.small()`` as it documents: ``scale_served`` for the
    request scale ``served`` and ``scale_oneshot`` for every other; a pool
    of 6 for the service and at most 2 otherwise; a stream's batches cut in
    the graphs' proportion."""
    w = harness.workload(bench, cell)
    full = harness.load_json("configs", w["config"])["scale"]
    given = harness.load_json("traffic", w["traffic"])
    rs = given["request_scale"]
    for kw, (so, ss) in (({}, (9, 8)),
                         ({"scale_oneshot": 14, "scale_served": 12},
                          (14, 12))):
        config, traffic = small(bench, cell, **kw)
        assert config["scale"] == {k: ss if k == "served" else so
                                   for k in full}
        assert traffic["pool"] == (6 if given["driver"] == "service_loop"
                                   else min(int(given["pool"]), 2))
        if "batch" in given:
            cut = 2.0 ** (config["scale"][rs] - full[rs])
            assert traffic["batch"] == dict(given["batch"], **{
                k: max(1, round(int(given["batch"][k]) * cut))
                for k in ("inserts", "deletes")})


# --------------------------------------------------------------------------
# small runs
# --------------------------------------------------------------------------
def run_small(bench, cell, seed, traced, seconds=0.4, device=CPU, **sizes):
    """One run of ``cell`` at ``conftest.small()``'s sizes (``sizes`` its
    keywords) on ``device``: its result line and the span log's summary of
    its window."""
    from repro_torch.kernels import ops
    ops.reset()   # the log holds this run's window only
    config, traffic = small(bench, cell, **sizes)
    out = harness.run_cell(cell, seed, seconds, traced, device, bench=bench,
                           config=config, traffic=traffic)
    return out, ops.summary()


def result_line(bench, cell, out, traced):
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    kind = "per_layer" if traced else "end_to_end"
    named = {m["name"]: m["unit"] for m in harness.metrics_of(bench, kind,
                                                              cell)}
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert named[name] == m["unit"] and isinstance(m["value"], float)
    if not traced:
        assert set(line["metrics"]) == set(named)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    for name, c in line["checks"].items():
        assert NAME.match(name) and c == {"value": 0, "limit": 0}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def span_metrics(bench, cell, out):
    """A traced run reports every span metric the cell lists, each a
    positive float; without a queue, layout and sync waits fit in the
    window's time per graph."""
    assert out["correct"] is True
    want = [m["name"] for m in harness.metrics_of(bench, "per_layer", cell)
            if m["source"] == "program_span"]
    assert want
    got = {k: v["value"] for k, v in out["metrics"].items() if k in want}
    assert sorted(got) == sorted(want)
    assert all(isinstance(v, float) and v > 0 for v in got.values())
    if not queued(bench, cell):
        s = stem(bench, cell)
        per_graph_ms = 1e3 * out["device"]["window_s"] / out["attempted"]
        assert (got[f"layout_ms_per_graph.{s}"]
                + got[f"sync_wait_ms_per_graph.{s}"]) <= per_graph_ms


def span_table(bench, cell, out, summary):
    """``span_table.per_graph``: each span's count and times per graph
    served, and the checks that tie the span metrics to what the same run
    measured from outside: within the window without a queue, against the
    tail with one."""
    from portbench import span_table as tool
    table = tool.per_graph(out, summary)
    requests = out["attempted"] - out["failed"]
    assert table["requests"] == requests > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    s = stem(bench, cell)
    rows = table["spans"]
    assert rows["plan.layout"]["total_ms"] == pytest.approx(
        m[f"layout_ms_per_graph.{s}"])
    syncs = sum(r["total_ms"] for k, r in rows.items()
                if k.startswith("sync."))
    assert syncs == pytest.approx(m[f"sync_wait_ms_per_graph.{s}"])
    assert table["spans_per_graph"] == pytest.approx(
        sum(x["count"] for x in summary.values()) / requests)
    selfs = [r["self_ms"] for r in rows.values()]
    assert selfs == sorted(selfs, reverse=True)
    assert all(0 <= r["self_ms"] <= r["total_ms"] + 1e-9
               for r in rows.values())
    checks = table["checks"]
    frames = checks["layout_vs_layout_frames_idle"]
    assert frames["layout_ms_per_graph"] == m[f"layout_ms_per_graph.{s}"]
    assert frames["frames_idle_ms_per_graph"] >= 0
    if not queued(bench, cell):
        within = checks["layout_plus_sync_within_window"]
        assert within["sum_ms"] <= within["window_ms_per_graph"]
        assert "queue_wait_within_p95" not in checks
    else:
        queue = checks["queue_wait_within_p95"]
        assert queue["queue_wait_ms"] == m["queue_wait_ms"]
        assert queue["served_p95_ms"] == m["served_p95_ms"]
        assert "layout_plus_sync_within_window" not in checks


def readers_without_spans(bench, cell, monkeypatch):
    """Each span reader the cell lists finds nothing, without raising, in a
    program that records no spans, or records but none of its own."""
    for m in harness.metrics_of(bench, "per_layer", cell):
        if m["source"] == "program_span":
            reader_without_spans(m, monkeypatch)


def reader_without_spans(metric, monkeypatch):
    from repro_torch.kernels import ops
    window = harness.Window(seconds=1.0, graphs=1, answers=[
        harness.Answered(0, [1], None, 0.1)], values={})
    ctx = trace.ReadContext(window=window, trace=None, launches=[],
                            window_peak_bytes=None)
    reader = harness.load_module(harness.reader_path(metric["name"]))
    with monkeypatch.context() as mp:
        mp.delattr(ops, "spans")
        assert reader.read(ctx) is None
    ops.reset()
    assert reader.read(ctx) is None   # the program records, but no span
    assert reader.read(types.SimpleNamespace(window=types.SimpleNamespace(
        requests=0))) is None


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def card_run(bench, cell, out):
    """A small traced run on the card: correct, the device busy, and every
    roofline share the cell lists read and at most 105 %."""
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    for name in _per_layer_names(bench, cell):
        if name.split(".")[0].endswith("_roofline"):
            assert 0 < out["metrics"][name]["value"] <= 105
    assert np.isfinite(out["device"]["window_s"])
