"""BENCHMARK.json against the benchmark's contract, every file it names found
by name, and the run command's refusals: no card, no JAX."""
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


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
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_workload_entry(cell):
    w = harness.workload(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _line(w["why"])
    assert w["config"] in [c["name"] for c in BENCH["configs"]]
    traffic = harness.load_json("traffic", w["traffic"])
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    config = harness.load_json("configs", w["config"])
    assert traffic["request_scale"] in config["scale"]
    e2e = [m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, "per_layer", cell)
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = ({"name", "unit", "better", "source", "layer", "moves"} if per_layer
            else {"name", "unit", "better", "bound", "source"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert all(c in CELLS for c in metric.get("workloads", []))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert names.count(metric["name"]) == 1
    if per_layer:
        assert _line(metric["layer"])
        moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
        assert moved, metric["moves"]
        # every cell that reads this metric reports the metric it moves
        for cell in metric["workloads"]:
            assert cell in moved[0].get("workloads", CELLS)
        reader = harness.load_module(harness.reader_path(metric["name"]))
        assert callable(reader.read)
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_layers_share_one_spelling():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"service", "plan and host layout", "round loop",
                      "engine sweep", "kernels", "device"}


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
