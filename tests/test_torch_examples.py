"""The port's examples (``examples/*_torch.py``) held to the reference's
(``examples/*.py``) on the CPU.

Both run in this process: the reference's ``main()`` with ``sys.argv``
patched (its Pallas kernels in interpret mode), the port's ``main(argv)``
with ``--device cpu``. The quickstart's printed per-family lines must be
equal line for line, the wall time cut off; the comm-schedule example's
lines (round count, lower bound, the first rounds) must equal those of the
reference's example on its ITERATIVE path (``use_device=True``). The LM
wrappers run at the smoke configs, and the training one checks that the
loss decreases. None of the four files may import ``jax`` or ``repro``.
"""
import ast
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
PORTED = ("quickstart", "color_comm_schedule", "serve_lm", "train_lm")
SCALE = 8

# the reference's distributed strategy runs only with the frontier off
# under this jax (ROADMAP C1)
QUICKSTART = {
    "iterative-sort": ["--engine", "sort"],
    "iterative-bitmap": ["--engine", "bitmap"],
    "iterative-ell_pallas": ["--engine", "ell_pallas"],
    "iterative-fused_pallas": ["--engine", "fused_pallas"],
    "dataflow-largest_first": ["--strategy", "dataflow", "--ordering",
                               "largest_first"],
    "dataflow-natural": ["--strategy", "dataflow"],
    "d2": ["--model", "d2", "--scale", "7"],
    "frontier-on": ["--frontier", "on"],
    "frontier-off": ["--frontier", "off"],
    "stream-2": ["--stream", "2"],
    "distributed-frontier-off": ["--strategy", "distributed", "--frontier",
                                 "off", "--engine", "bitmap"],
}


def _module(name):
    path = os.path.join(EXAMPLES, name + ".py")
    spec = importlib.util.spec_from_file_location("example_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    """``(return value, printed lines)`` of ``fn(*args)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def _reference(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    return _printed(_module(name).main)


def _without_wall_time(lines):
    return [re.sub(r", [0-9.]+s$", "", ln) for ln in lines]


@pytest.mark.parametrize("case", list(QUICKSTART))
def test_quickstart_prints_the_references_lines(case, monkeypatch):
    argv = ["--scale", str(SCALE)] + QUICKSTART[case]
    _, want = _reference("quickstart", argv, monkeypatch)
    _, got = _printed(_module("quickstart_torch").main,
                      argv + ["--device", "cpu"])
    assert len(want) >= 9
    assert _without_wall_time(got) == _without_wall_time(want)


def _reference_on_the_device_path(argv, monkeypatch):
    """The reference example's lines with its ``schedule_transfers`` on
    the ITERATIVE path (``use_device=True``), the port example's only
    path."""
    import functools
    monkeypatch.setattr(sys, "argv", ["color_comm_schedule.py"] + argv)
    mod = _module("color_comm_schedule")
    mod.schedule_transfers = functools.partial(mod.schedule_transfers,
                                               use_device=True)
    return _printed(mod.main)


@pytest.mark.parametrize("devices", [16, 64])
def test_comm_schedule_prints_the_references_lines(devices, monkeypatch):
    argv = ["--devices", str(devices)]
    _, want = _reference_on_the_device_path(argv, monkeypatch)
    sch, got = _printed(_module("color_comm_schedule_torch").main,
                        argv + ["--device", "cpu"])
    assert got == want
    assert sch.num_rounds >= sch.lower_bound > 0


def test_comm_schedule_on_the_device_path_is_the_references():
    """The example colors the conflict graph with ITERATIVE, as the
    reference's ``schedule_transfers(use_device=True)`` does: the same
    rounds, transfer for transfer."""
    import numpy as np
    from repro.core import schedule_transfers
    from repro.core.comm_schedule import moe_all_to_all_transfers
    sch, _ = _printed(_module("color_comm_schedule_torch").main,
                      ["--devices", "64", "--device", "cpu"])
    rng = np.random.default_rng(0)
    counts = (rng.random((64, 64)) < 0.3).astype(int)
    ref = schedule_transfers(moe_all_to_all_transfers(counts),
                             use_device=True)
    assert (sch.num_rounds, sch.lower_bound) == (ref.num_rounds,
                                                 ref.lower_bound)
    assert [list(map(int, r)) for r in sch.rounds] == \
        [list(map(int, r)) for r in ref.rounds]


def test_serve_wrapper_runs_the_smoke_config():
    res, lines = _printed(_module("serve_lm_torch").main,
                          ["--arch", "qwen3-4b", "--device", "cpu"])
    assert res["tokens"].shape == (8, 32)
    assert lines[0].startswith("[serve] arch=qwen3-smoke device=cpu batch=8")


def test_train_wrapper_lowers_the_loss(tmp_path):
    losses, lines = _printed(_module("train_lm_torch").main,
                             ["--smoke", "--steps", "8", "--seq", "32",
                              "--device", "cpu", "--ckpt-dir",
                              str(tmp_path / "ckpt")])
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert lines[-1] == f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}"
    assert os.path.exists(tmp_path / "ckpt" / "LATEST")


def test_train_wrapper_run_twice_into_one_directory(tmp_path):
    """A second run of the same command resumes at its last step, trains
    nothing and says so; the smoke and full configs keep their default
    checkpoints apart."""
    mod = _module("train_lm_torch")
    argv = ["--smoke", "--steps", "4", "--seq", "32", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    first, _ = _printed(mod.main, argv)
    second, lines = _printed(mod.main, argv)
    assert len(first) == 4 and second == []
    assert lines[-1] == f"nothing to train: {tmp_path / 'ckpt'} is at " \
                        f"step 4 of 4"
    assert mod.default_ckpt_dir(True) != mod.default_ckpt_dir(False)


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_neither_jax_nor_repro(name):
    """Statically: no import of ``jax`` or ``repro`` in the file; and when
    imported with both blocked, it loads and pulls in neither."""
    path = os.path.join(EXAMPLES, name + "_torch.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    code = textwrap.dedent(f"""
        import importlib.util, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        spec = importlib.util.spec_from_file_location("ex", {path!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]
