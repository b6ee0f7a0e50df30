"""The plain references against the port itself on the CPU: the same colors
(and, for ITERATIVE, the same per-round conflict counts) as a plan's call
and as the coloring service, on both configurations; and each control, put
in the program's place, judged not correct."""
import numpy as np
import pytest
import torch

from portbench import gen, harness, plain

CPU = torch.device("cpu")
CONFIGS = ["rmat-er.iterative", "rmat-g.dataflow"]


def _setup(name, scale, count, seed):
    config = harness.load_json("configs", name)
    ref = harness.load_module(harness.HERE / "configs" / f"{name}.py")
    csrs = gen.make_pool(config["graph"], scale, count, seed, CPU)
    return config, ref, csrs


def _graph(c):
    from repro_torch.core import Graph
    return Graph(c.num_vertices, c.row_ptr, c.col_idx)


def _same(want, rep):
    assert np.array_equal(rep.colors, want.colors)
    if want.conflicts_per_round is not None:
        assert np.array_equal(rep.conflicts_per_round,
                              want.conflicts_per_round)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("scale", [6, 10])
def test_reference_equals_a_plan_call(name, scale):
    from repro_torch.core import ColoringSpec, compile_plan
    config, ref, csrs = _setup(name, scale, 2, 1000 + scale)
    spec = dict(config["spec"])
    if scale == 6 and "concurrency" in spec:
        spec["concurrency"] = 8   # several lockstep offsets at this size
        config = dict(config, spec=spec)
    for c in csrs:
        g = _graph(c)
        rep = compile_plan(ColoringSpec(**spec), g, device="cpu")(g)
        want = ref.reference(plain.to_device(c, CPU), config)
        _same(want, rep)
        assert plain.bad_edges(plain.to_device(c, CPU), rep.colors) == 0
        if want.conflicts_per_round is not None:
            assert rep.rounds == len(want.conflicts_per_round)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_service(name):
    from repro_torch.core import ColoringSpec
    from repro_torch.serve.coloring import AsyncColoringService
    config, ref, csrs = _setup(name, 9, 4, 42)
    svc = AsyncColoringService(default_spec=ColoringSpec(**config["spec"]),
                               max_batch=4, device="cpu")
    handles = [svc.submit(_graph(c), tenant=f"t{i % 2}")
               for i, c in enumerate(csrs)]
    svc.drain()
    outs = [h.result() for h in handles]
    assert any(o.batched for o in outs)
    for c, out in zip(csrs, outs):
        _same(ref.reference(plain.to_device(c, CPU), config), out.report)


@pytest.mark.parametrize("name", CONFIGS)
def test_control_is_judged_not_correct(name):
    config, ref, csrs = _setup(name, 10, 3, 7)
    answers = []
    for i, c in enumerate(csrs):
        got = ref.control(plain.to_device(c, CPU), config)
        answers.append(harness.Answered(i, got.colors,
                                        got.conflicts_per_round, 0.0))
    checks = harness.judge(ref, config, csrs, answers, CPU)
    assert not harness.passed(checks)
    assert checks["wrong_colors"]["value"] > 0


def test_mex_rows_in_blocks(monkeypatch):
    # a table cut into many row blocks gives the mex of one whole table
    fsrc = torch.tensor([0, 0, 0, 2, 2, 5, 5, 5, 5])
    fcol = torch.tensor([1, 2, 4, 2, 3, 1, 2, 3, 9])
    whole = plain.mex_rows(7, fsrc, fcol, 5)
    monkeypatch.setattr(plain, "TABLE_CELLS", 12)
    assert torch.equal(plain.mex_rows(7, fsrc, fcol, 5), whole)
    assert whole.tolist() == [3, 1, 1, 1, 1, 4, 1]
