"""The port's LM serving lane: the batched server
(``python -m repro_torch.launch.serve``) against the reference's
(``repro.launch.serve``), the lazy LM re-exports of ``repro_torch.serve``,
and the ``repro_torch.launch`` package around it.

The greedy tokens are integers and are held exactly. Both servers run a
float32 copy of the smoke config (``get_smoke_config`` patched alike on
both sides) with the reference's seed-0 weights carried across by
``convert.lm_params_from_arrays``: in float32 the logits agree to ~1e-6
(``test_torch_lm_models.py``), far inside the gap between the two largest
logits, so the argmax cannot flip. Sampled tokens are never compared:
``jax.random`` and ``torch`` draws differ.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro import models as RM
import repro.launch.serve as RS
from repro.configs import get_smoke_config as r_smoke
from repro_torch.configs import get_smoke_config as p_smoke
from repro_torch.convert import lm_params_from_arrays
import repro_torch.launch.serve as PS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-2b", "whisper-medium"])
def test_greedy_tokens_equal_the_reference_server(arch, monkeypatch):
    argv = ["--arch", arch, "--smoke", "--batch", "3", "--prompt-len", "12",
            "--gen", "6"]
    monkeypatch.setattr(RS, "get_smoke_config", lambda a: _f32(r_smoke(a)))
    want = RS.main(argv)
    rc, pc = _f32(r_smoke(arch)), _f32(p_smoke(arch))
    tree = jax.tree.map(np.asarray, RM.init_params(rc, jax.random.PRNGKey(0))[0])
    params = lm_params_from_arrays(pc, tree, device="cpu")
    got = PS.serve(pc, params=params, batch=3, prompt_len=12, gen=6,
                   device="cpu")
    assert got["tokens"].dtype == np.int32
    assert np.array_equal(got["tokens"], np.asarray(want))


def test_cli_reports_the_serving_metrics(capsys):
    res = PS.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    out = capsys.readouterr().out
    for line in ("[serve] prefill:", "[serve] decode:",
                 "[serve] decode step latency: p50=", "[serve] sample row:"):
        assert line in out
    assert res["tokens"].shape == (2, 5)
    assert res["prefill_tok_s"] > 0 and res["decode_tok_s"] > 0
    assert 0 < res["step_p50_ms"] <= res["step_p99_ms"] <= res["step_max_ms"]
    assert res["peak_bytes"] is None          # a CPU run reports no card memory


def test_temperature_sampling_follows_the_generator():
    """Temperature draws come from a generator seeded alike on every run, so
    two runs repeat exactly, and they are not the greedy tokens."""
    cfg = p_smoke("mamba2-130m")
    kw = dict(batch=2, prompt_len=8, gen=6, device="cpu")
    a = PS.serve(cfg, temperature=1.0, **kw)["tokens"]
    b = PS.serve(cfg, temperature=1.0, **kw)["tokens"]
    greedy = PS.serve(cfg, temperature=0.0, **kw)["tokens"]
    assert np.array_equal(a, b) and not np.array_equal(a, greedy)
    assert a.min() >= 0 and a.max() < cfg.vocab_size
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    assert PS.sample(logits, g, 0.0).tolist() == [1]


def test_server_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.main(["--arch", "qwen3-4b", "--smoke"])


def test_serve_command_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-4b", "--smoke", "--device", "cpu", "--gen", "4"],
        env=ENV, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve] arch=qwen3-smoke device=cpu batch=8 prompt=64 gen=4" in out.stdout


def test_serve_package_reexports_the_lm_api_lazily():
    """``repro_torch.serve`` names the LM primitives beside the coloring
    lane, and importing it loads neither lane."""
    code = ("import sys, repro_torch.serve as s; "
            "before = 'repro_torch.models' in sys.modules; "
            "from repro_torch import models; "
            "print(before, all(getattr(s, n) is getattr(models, n) for n in "
            "('cache_spec', 'init_cache', 'decode_step', 'forward')), "
            "'repro_torch.serve.coloring' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True", "False"]
    import repro_torch.serve as s
    assert {"cache_spec", "init_cache", "decode_step", "forward",
            "ColoringService"} <= set(s.__all__)


def test_launch_package_keeps_its_ranks_command():
    """``repro_torch.launch`` is a package now: ``run_ranks`` and its
    ``"module:function"`` targets import as before, and ``python -m
    repro_torch.launch`` (also each rank's entry) colors validly."""
    from repro_torch.launch import color_rmat, run_ranks
    assert callable(run_ranks) and callable(color_rmat)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "--ranks", "2",
         "--device", "cpu", "--scale", "8"],
        env=ENV, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    ranks = [json.loads(line) for line in lines[:2]]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["valid"] is True and "valid=True" in lines[-1]
