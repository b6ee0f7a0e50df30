"""The readers of the program's spans (``source: program_span``) on the CPU
at small sizes: each traced cell reports its span metrics as floats, inside
what the window allows, and a reader finds nothing, without raising, in a
program that records no spans."""
import types

import pytest
import torch

from portbench import harness, trace
from portbench.conftest import small

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["source"] == "program_span"]
SEED = 2**31 + 29
_TRACED = {}


def _traced(cell):
    """One small traced run of ``cell`` (made once per test process): its
    result line and the span log's summary of its window."""
    if cell not in _TRACED:
        from repro_torch.kernels import ops
        ops.reset()   # the log holds this run's window only
        config, traffic = small(BENCH, cell)
        out = harness.run_cell(cell, SEED, 0.4, True, torch.device("cpu"),
                               bench=BENCH, config=config, traffic=traffic)
        _TRACED[cell] = out, ops.summary()
    return _TRACED[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_are_read_in_each_traced_cell(cell):
    out, _ = _traced(cell)
    assert out["correct"] is True
    want = [m["name"] for m in SPAN_METRICS if cell in m["workloads"]]
    assert want
    got = {k: v["value"] for k, v in out["metrics"].items() if k in want}
    assert sorted(got) == sorted(want)
    assert all(isinstance(v, float) and v > 0 for v in got.values())
    if cell.endswith(".oneshot"):
        per_graph_ms = 1e3 * out["device"]["window_s"] / out["attempted"]
        assert (got["layout_ms_per_graph.oneshot"]
                + got["sync_wait_ms_per_graph.oneshot"]) <= per_graph_ms


@pytest.mark.parametrize("cell", CELLS)
def test_span_table_lays_the_log_out_per_graph(cell):
    """``span_table.per_graph``: each span's count and times per graph
    served, and the checks that tie the span metrics to what the same run
    measured from outside."""
    from portbench import span_table
    out, summary = _traced(cell)
    table = span_table.per_graph(out, summary)
    requests = out["attempted"] - out["failed"]
    assert table["requests"] == requests > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    stem = cell.split(".")[1]
    rows = table["spans"]
    assert rows["plan.layout"]["total_ms"] == pytest.approx(
        m[f"layout_ms_per_graph.{stem}"])
    syncs = sum(r["total_ms"] for k, r in rows.items()
                if k.startswith("sync."))
    assert syncs == pytest.approx(m[f"sync_wait_ms_per_graph.{stem}"])
    assert table["spans_per_graph"] == pytest.approx(
        sum(s["count"] for s in summary.values()) / requests)
    selfs = [r["self_ms"] for r in rows.values()]
    assert selfs == sorted(selfs, reverse=True)
    assert all(0 <= r["self_ms"] <= r["total_ms"] + 1e-9
               for r in rows.values())
    checks = table["checks"]
    frames = checks["layout_vs_layout_frames_idle"]
    assert frames["layout_ms_per_graph"] == m[f"layout_ms_per_graph.{stem}"]
    assert frames["frames_idle_ms_per_graph"] >= 0
    if stem == "oneshot":
        within = checks["layout_plus_sync_within_window"]
        assert within["sum_ms"] <= within["window_ms_per_graph"]
        assert "queue_wait_within_p95" not in checks
    else:
        queue = checks["queue_wait_within_p95"]
        assert queue["queue_wait_ms"] == m["queue_wait_ms"]
        assert queue["served_p95_ms"] == m["served_p95_ms"]
        assert "layout_plus_sync_within_window" not in checks


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_a_program_without_spans_gives_nothing(metric, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.delattr(ops, "spans")
    window = harness.Window(seconds=1.0, graphs=1, answers=[
        harness.Answered(0, [1], None, 0.1)], values={})
    ctx = trace.ReadContext(window=window, trace=None, launches=[],
                            window_peak_bytes=None)
    reader = harness.load_module(harness.reader_path(metric["name"]))
    assert reader.read(ctx) is None
    monkeypatch.undo()
    ops.reset()
    assert reader.read(ctx) is None   # the program records, but no span
    assert reader.read(types.SimpleNamespace(window=types.SimpleNamespace(
        requests=0))) is None
