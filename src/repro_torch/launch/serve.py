"""Batched serving of the LM lane: prefill a batch of prompts, then
decode N tokens (the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --smoke \\
        --device cpu --batch 8 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b  # on the card

Prefill-then-decode on the cache contract of ``repro_torch.models`` (caches
written in place), greedy or temperature sampling (temperature draws come
from an explicit ``torch.Generator``), per-sequence ``cur_len``; it
reports prefill and decode tokens/s and per-step decode latency p50/p99
through :class:`repro_torch.serve.metrics.WindowedMetrics`, synchronizing
the card before each clock reading. Weights are random, drawn on the device
from seed 0, and temperature draws from seed 1, as the reference fixes
``PRNGKey(0)`` and ``PRNGKey(1)``; prompts come from
``numpy.random.default_rng(0)``, as in the reference, so the reference's weights
(``repro_torch.convert.lm_params_from_arrays``) give its greedy tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.graph import DeviceSpec, resolve_device
from .. import models


def sample(logits, generator: torch.Generator, temperature: float):
    """Greedy (``temperature <= 0``) or temperature sampling, int32."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, *, params=None, batch: int = 8, prompt_len: int = 64,
          gen: int = 32, temperature: float = 0.0,
          device: DeviceSpec = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens per row. ``params`` (a module from ``models.init_params``
    or ``convert.lm_params_from_arrays``) defaults to weights drawn from
    seed 0. Returns the timings, the decode latency window, the peak
    device memory (on the card) and ``tokens`` [batch, gen]."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        params, _ = models.init_params(
            cfg, torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    b, t = batch, prompt_len
    inputs = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)).to(dev)}
    if cfg.family == "vlm":
        inputs["image_embeds"] = torch.from_numpy(rng.normal(
            size=(b, cfg.vlm.num_image_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.family == "encdec":
        inputs["frames"] = torch.from_numpy(rng.normal(
            size=(b, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)).to(dev)
    draws = torch.Generator(dev).manual_seed(1)

    from ..serve.metrics import WindowedMetrics
    metrics = WindowedMetrics()
    with torch.inference_mode():
        caches = models.init_cache(cfg, b, t + gen, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, _, caches = models.forward(cfg, params, inputs, caches=caches)
        tok = sample(logits[:, -1], draws, temperature)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            ts = time.perf_counter()
            logits_i, caches = models.decode_step(cfg, params, caches, tok)
            tok = sample(logits_i, draws, temperature)
            _sync(dev)
            dt = time.perf_counter() - ts
            # one decode step == one size-1 "batch" flush
            metrics.record_flush("size", latencies=[dt], queue_ages=[0.0],
                                 exec_s=dt, batched=True)
            out.append(tok)
        decode_s = time.perf_counter() - t0
    win = metrics.snapshot()["window"]
    return {
        "arch": cfg.name, "device": str(dev), "batch": b, "prompt": t,
        "gen": gen, "prefill_s": prefill_s,
        "prefill_tok_s": b * t / max(prefill_s, 1e-9),
        "decode_s": decode_s,
        "decode_tok_s": b * (gen - 1) / max(decode_s, 1e-9),
        "step_p50_ms": win["p50_ms"] if win["count"] else None,
        "step_p99_ms": win["p99_ms"] if win["count"] else None,
        "step_max_ms": win["max_ms"] if win["count"] else None,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "tokens": torch.stack(out, dim=1).cpu().numpy(),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Prefill a batch of prompts and decode tokens.")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, temperature=args.temperature,
                device=args.device)
    b, t, g = res["batch"], res["prompt"], res["gen"]
    print(f"[serve] arch={res['arch']} device={res['device']} batch={b} "
          f"prompt={t} gen={g}")
    print(f"[serve] prefill: {res['prefill_s']:.3f}s "
          f"({res['prefill_tok_s']:.0f} tok/s)")
    print(f"[serve] decode:  {res['decode_s']:.3f}s "
          f"({res['decode_tok_s']:.1f} tok/s)")
    if res["step_p50_ms"] is not None:
        print(f"[serve] decode step latency: p50={res['step_p50_ms']:.2f}ms "
              f"p99={res['step_p99_ms']:.2f}ms max={res['step_max_ms']:.2f}ms")
    if res["peak_bytes"] is not None:
        print(f"[serve] peak device memory: {res['peak_bytes'] / 2**30:.2f} GiB")
    print(f"[serve] sample row: {res['tokens'][0][:16].tolist()}")
    return res


if __name__ == "__main__":
    main()
