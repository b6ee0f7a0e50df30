"""The readers of the program's spans (``source: program_span``) on the CPU
at small sizes: each traced cell reports its span metrics as floats, inside
what the window allows, and a reader finds nothing, without raising, in a
program that records no spans."""
import pytest

from portbench import cell_checks, harness

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
        _TRACED[cell] = cell_checks.run_small(BENCH, cell, SEED, True)
    return _TRACED[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_are_read_in_each_traced_cell(cell):
    out, _ = _traced(cell)
    cell_checks.span_metrics(BENCH, cell, out)


@pytest.mark.parametrize("cell", CELLS)
def test_span_table_lays_the_log_out_per_graph(cell):
    """``span_table.per_graph``: each span's count and times per graph
    served, and the checks that tie the span metrics to what the same run
    measured from outside."""
    out, summary = _traced(cell)
    cell_checks.span_table(BENCH, cell, out, summary)


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_a_program_without_spans_gives_nothing(metric, monkeypatch):
    cell_checks.reader_without_spans(metric, monkeypatch)
