"""One caller in a closed loop through one built plan.

Set-up builds ``compile_plan(spec, PlanShape)`` whose envelope covers the
pool (every graph's vertex count, the edge bucket of the largest, the
largest max degree) and warms it with one request. The window hands the
pool's host graphs to ``plan(g)`` in turn, each request starting when the
previous report is back, until ``seconds`` have passed; the window spans
whole requests, and ``color_s`` is its length over the graphs colored.
"""
from __future__ import annotations

import time

from portbench.harness import Answered, Window


def setup(cell):
    from repro_torch.core import ColoringSpec, PlanShape, compile_plan
    from repro_torch.core.graph import pad_bucket
    graphs = cell.program_graphs
    shape = PlanShape(
        num_vertices=graphs[0].num_vertices,
        padded_edges=pad_bucket(max(g.num_directed_edges for g in graphs)),
        max_degree=max(g.max_degree() for g in graphs))
    plan = compile_plan(ColoringSpec(**cell.config["spec"]), shape,
                        device=cell.device)
    plan(graphs[0])
    cell.sync()
    return plan


def window(cell, plan, seconds: float) -> Window:
    graphs = cell.program_graphs
    answers = []
    t0 = time.perf_counter()
    while True:
        i = len(answers) % len(graphs)
        t = time.perf_counter()
        rep = plan(graphs[i])
        answers.append(Answered(i, rep.colors, rep.conflicts_per_round,
                                time.perf_counter() - t))
        if time.perf_counter() - t0 >= seconds:
            break
    span = time.perf_counter() - t0
    return Window(seconds=span, graphs=len(answers), answers=answers,
                  values={"color_s": span / len(answers)})


def close(cell, plan) -> None:
    """Nothing runs after the window: the plan is freed with the cell."""
