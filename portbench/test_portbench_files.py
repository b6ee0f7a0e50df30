"""BENCHMARK.json against the benchmark's contract, every file it names found
by name, and the run command's refusals: no card, no JAX."""
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import cell_checks, harness

PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    cell_checks.config_entry(BENCH, entry)


@pytest.mark.parametrize("cell", CELLS)
def test_workload_entry(cell):
    cell_checks.workload_entry(BENCH, cell)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    cell_checks.metric_entry(BENCH, metric)


def test_layers_share_one_spelling():
    cell_checks.layers(BENCH)


LATER_LAYERS = {
    "none": ([], True),
    "new": (["delta step"], True),
    "two-new": (["delta-step", "stream delta"], True),
    "upper-case": (["Delta step"], False),
    "two-spellings": (["delta step", "delta-step"], False),
    "six-respelled": (["plan and host-layout"], False),
    "six-capitalised": (["Round loop"], False),
    "double-space": (["round  loop"], False),
    "trailing-space": (["delta step "], False),
}


@pytest.mark.parametrize("case", LATER_LAYERS)
def test_a_later_layer_is_spelled_one_way(case):
    # a layer beside the six of PERF.md is a lower-case phrase that no other
    # name equals once case, spaces and hyphens are dropped
    names, ok = LATER_LAYERS[case]
    six = [m for m in BENCH["per_layer"] if m["layer"] in cell_checks.LAYERS]
    bench = dict(BENCH, per_layer=six + [dict(six[0], name=f"x{i}", layer=n)
                                         for i, n in enumerate(names)])
    if ok:
        cell_checks.layers(bench)
    else:
        with pytest.raises(AssertionError):
            cell_checks.layers(bench)


def test_the_six_layers_stay():
    for layer in cell_checks.LAYERS:
        bench = dict(BENCH, per_layer=[m for m in BENCH["per_layer"]
                                       if m["layer"] != layer])
        with pytest.raises(AssertionError):
            cell_checks.layers(bench)


def test_every_traffic_and_reader_file_loads():
    for path in sorted((harness.HERE / "traffic").glob("*.json")):
        assert json.loads(path.read_text())["name"] == path.stem
    for path in sorted((harness.HERE / "metrics").glob("*.py")):
        assert callable(harness.load_module(path).read)
    for path in sorted((harness.HERE / "drivers").glob("*.py")):
        mod = harness.load_module(path)
        assert all(callable(getattr(mod, f)) for f in ("setup", "window",
                                                       "close"))


def _run(code_or_args, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *code_or_args], cwd=harness.REPO,
                          env=env, capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card():
    r = _run(["portbench/run.py", "--workload", CELLS[0], "--seed",
              str(2**31 + 11), "--seconds", "1", "--trace", "0"],
             {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
    assert "needs 1 NVIDIA card" in r.stderr


def test_nothing_loaded_is_jax_or_the_jax_package():
    # every module a run loads: the harness, the program's entry points,
    # each driver, reader and reference
    code = (
        "import sys\n"
        "sys.path[:0] = ['.', 'src']\n"
        "from portbench import harness, trace, roofline, gen, plain\n"
        "import repro_torch.core, repro_torch.serve.coloring\n"
        "import repro_torch.kernels.ops\n"
        "for d in ('drivers', 'metrics', 'configs'):\n"
        "    for p in sorted((harness.HERE / d).glob('*.py')):\n"
        "        harness.load_module(p)\n"
        "print(harness.loaded_banned())\n")
    r = _run(["-c", code], {})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
    assert "repro_torch" not in harness.BANNED_MODULES
