"""End-to-end training driver on one device (the port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --smoke --steps 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 300 --batch 8 --seq 512 --ckpt-dir build/ckpt   # on the card

Features exercised: the deterministic data pipeline (skip-to-step on
resume), the train step, NaN-step rejection, atomic + asynchronous
checkpoints and restart from ``LATEST``. Weights are random, drawn on the
device from seed 0, as the reference fixes ``PRNGKey(0)``. The checkpoint
tree is ``{"params": {name: tensor}, "opt": optimizer state}`` under the
port's parameter names; ``repro_torch.convert`` maps it onto the
reference's layout and back.

:func:`build` is the one-device path. The reference's mesh branch (a
sharded step over a device mesh) comes with the sharded trainer.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..core.graph import DeviceSpec, resolve_device
from .. import models
from ..models.config import ShapeConfig
from ..train import (AdamWConfig, TrainStepConfig, checkpoint, data,
                     init_opt_state, make_train_step)


def build(cfg, opt_cfg: AdamWConfig, ts_cfg: TrainStepConfig,
          device: DeviceSpec = None):
    """``(params, opt_state, step_fn, None)`` on ``device`` (``None`` = the
    card): params drawn from seed 0, zero optimizer state, the train step.
    The last slot is the reference's mesh, which a one-device run has not."""
    dev = resolve_device(device)
    params, _ = models.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                   device=dev)
    return (params, init_opt_state(params, opt_cfg),
            make_train_step(cfg, opt_cfg, ts_cfg), None)


def state_tree(params, opt_state) -> dict:
    """The checkpoint tree of a run: ``{"params": {name: tensor}, "opt"}``."""
    return {"params": dict(params.named_parameters()), "opt": opt_state}


@torch.no_grad()
def restore_into(root: str, params, opt_state, step=None):
    """Restore a run's checkpoint (``step=None`` takes ``LATEST``) into
    ``params`` (copied in place) and return ``(opt_state, step)``."""
    tree, step = checkpoint.restore(root, state_tree(params, opt_state),
                                    step=step)
    for name, p in params.named_parameters():
        p.copy_(tree["params"][name])
    return tree["opt"], step


def batch_on(dcfg, step: int, dev: torch.device) -> dict:
    """The data pipeline's batch for ``step`` as tensors on ``dev``."""
    return {k: torch.from_numpy(v).to(dev)
            for k, v in data.batch_for_step(dcfg, step).items()}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train an LM config on synthetic data on one device.")
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def configs(args: argparse.Namespace):
    """``(model cfg, AdamWConfig, TrainStepConfig, DataConfig)`` of a run."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    ts_cfg = TrainStepConfig(microbatches=args.microbatches)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    return cfg, opt_cfg, ts_cfg, data.data_config_for(cfg, shape)


def main(argv=None):
    """Train (resuming from ``LATEST`` under ``--ckpt-dir``) and return the
    losses of the steps this run took."""
    args = parse_args(argv)
    cfg, opt_cfg, ts_cfg, dcfg = configs(args)
    dev = resolve_device(args.device)

    params, opt_state, step_fn, _ = build(cfg, opt_cfg, ts_cfg, device=dev)

    start = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        opt_state, start = restore_into(args.ckpt_dir, params, opt_state)
        print(f"[train] resumed from step {start}")

    losses = []
    t0 = time.time()
    pending_ckpt = None
    for s in range(start, args.steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_on(dcfg, s, dev))
        losses.append(float(m["loss"]))
        if (s + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            print(f"[train] step {s+1}/{args.steps} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} lr={float(m['lr']):.2e} "
                  f"skipped={int(m['skipped'])} {dt:.2f}s/step")
            t0 = time.time()
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            if pending_ckpt is not None:
                pending_ckpt.join()
            pending_ckpt = checkpoint.save(
                args.ckpt_dir, s + 1, state_tree(params, opt_state),
                async_write=True)
    if pending_ckpt is not None:
        pending_ckpt.join()
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps,
                        state_tree(params, opt_state))
    if losses:
        print(f"[train] done. first loss {losses[0]:.4f} -> "
              f"last {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
