"""Whole runs of each cell but the look for a card, on the CPU at small
sizes: the result line carries the contract's keys with names and units of
the allowed characters, and a run whose timed path is broken underneath
comes out not correct."""
import json
import re

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.conftest import small

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 17


def _run(cell, traced, seconds=0.4):
    config, traffic = small(BENCH, cell)
    return harness.run_cell(cell, SEED, seconds, traced, CPU, bench=BENCH,
                            config=config, traffic=traffic)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, traced):
    out = _run(cell, traced)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    kind = "per_layer" if traced else "end_to_end"
    named = {m["name"]: m["unit"] for m in harness.metrics_of(BENCH, kind,
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


def _state_unchanged(monkeypatch):
    # the sweep's kernel hands back each row's own color: no step moves
    from repro_torch.core import engine

    def stuck(entries, own_colors, *, words=16):
        return own_colors.clone(), torch.zeros_like(own_colors)

    monkeypatch.setattr(engine, "round_fused", stuck)


def _half_batch(monkeypatch):
    # the batched program colors the first half of a flush, and its reports
    # stand in for the rest
    from repro_torch.core.api import ColoringPlan
    real = ColoringPlan.map

    def half(self, graphs):
        graphs = list(graphs)
        h = max(1, len(graphs) // 2)
        reps = real(self, graphs[:h])
        return (reps * len(graphs))[:len(graphs)]

    monkeypatch.setattr(ColoringPlan, "map", half)


def _answer_altered(monkeypatch):
    # one vertex's color changes where the report is made
    from repro_torch.core import api
    real = api._build_report

    def altered(*args, **kwargs):
        rep = real(*args, **kwargs)
        rep.colors[len(rep.colors) // 2] += 1
        return rep

    monkeypatch.setattr(api, "_build_report", altered)


FAULTS = [("er22.oneshot", _state_unchanged), ("g22.oneshot", _state_unchanged),
          ("er19.served", _state_unchanged), ("er22.oneshot", _answer_altered),
          ("g18.served", _answer_altered), ("er19.served", _half_batch),
          ("g18.served", _half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell, False)
    assert out["correct"] is False
    assert out["checks"]["wrong_colors"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_the_card(card, cell):
    config, traffic = small(BENCH, cell, scale_oneshot=14, scale_served=12)
    out = harness.run_cell(cell, SEED, 1.0, True, card, bench=BENCH,
                           config=config, traffic=traffic)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    # a roofline share only of cells that list one (b21.oneshot launches no
    # round_fused)
    listed = [m["name"] for m in harness.metrics_of(BENCH, "per_layer", cell)
              if m["name"].startswith("round_fused_roofline")]
    for name in listed:
        assert 0 < out["metrics"][name]["value"] <= 105
    assert np.isfinite(out["device"]["window_s"])


def test_a_flush_that_raises_is_unanswered(monkeypatch):
    # the warm-up flush goes through; every flush of the window raises
    from repro_torch.core.api import ColoringPlan
    real, calls = ColoringPlan.map, []

    def boom(self, graphs):
        calls.append(1)
        if len(calls) == 1:
            return real(self, graphs)
        raise RuntimeError("flush failed")

    monkeypatch.setattr(ColoringPlan, "map", boom)
    monkeypatch.setattr(ColoringPlan, "__call__", boom)
    out = _run("er19.served", False)
    assert out["correct"] is False and out["failed"] > 0
    assert out["checks"]["unanswered"]["value"] == out["failed"]
