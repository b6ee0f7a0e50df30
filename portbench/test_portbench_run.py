"""Whole runs of each cell but the look for a card, on the CPU at small
sizes: the result line carries the contract's keys with names and units of
the allowed characters, and a run whose timed path is broken underneath
comes out not correct."""
import pytest
import torch

from portbench import cell_checks, harness

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 17


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, traced):
    out, _ = cell_checks.run_small(BENCH, cell, SEED, traced)
    cell_checks.result_line(BENCH, cell, out, traced)


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
    out, _ = cell_checks.run_small(BENCH, cell, SEED, False)
    assert out["correct"] is False
    assert out["checks"]["wrong_colors"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_the_card(card, cell):
    out, _ = cell_checks.run_small(BENCH, cell, SEED, True, 1.0, card,
                                   scale_oneshot=14, scale_served=12)
    cell_checks.card_run(BENCH, cell, out)


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
    out, _ = cell_checks.run_small(BENCH, "er19.served", SEED, False)
    assert out["correct"] is False and out["failed"] > 0
    assert out["checks"]["unanswered"]["value"] == out["failed"]
