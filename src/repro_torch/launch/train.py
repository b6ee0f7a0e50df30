"""End-to-end training driver (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --smoke --steps 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 300 --batch 8 --seq 512 --ckpt-dir build/ckpt   # on the card

and on a mesh of ranks: 4 gloo ranks on the CPU, as here, or NCCL ranks
on cards, one rank per card (``launch.mesh.make_mesh`` refuses several
gloo ranks on the card: gloo does not carry DTensor's collectives on CUDA
tensors)::

    PYTHONPATH=src python -c "from repro_torch.launch import run_ranks; \\
        print(run_ranks('repro_torch.launch.train:train_on_mesh', 4, \\
        dict(mesh_shape=[2, 2], arch='qwen3-4b', smoke=True, steps=4), \\
        device='cpu'))"

Features exercised: the deterministic data pipeline (skip-to-step on
resume), the train step, NaN-step rejection, atomic + asynchronous
checkpoints and restart from ``LATEST``. Weights are random, drawn on the
device from seed 0, as the reference fixes ``PRNGKey(0)``. The checkpoint
tree is ``{"params": {name: tensor}, "opt": optimizer state}`` under the
port's parameter names; ``repro_torch.convert`` maps it onto the
reference's layout and back.

:func:`build` makes the one-device run, or with ``mesh=`` the reference's
sharded step: the same seed-0 params, drawn whole and then split over the
mesh by the logical-axis rules (``parallel.sharding``), DTensor params and
moments that each rank holds only its shards of, the batch split on
``"batch"``, the step under those rules. :func:`train_on_mesh` is the
``run_ranks`` target that runs the driver on a mesh.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..core.graph import DeviceSpec, resolve_device
from .. import models
from ..models.config import ShapeConfig
from ..models.params import param_axes
from ..parallel.sharding import activation_rules, rules_for_mesh
from ..train import (AdamWConfig, TrainStepConfig, checkpoint, data,
                     init_opt_state, make_train_step)
from . import specs as S


def build(cfg, opt_cfg: AdamWConfig, ts_cfg: TrainStepConfig,
          device: DeviceSpec = None, mesh=None):
    """``(params, opt_state, step_fn, mesh)`` on ``device`` (``None`` = the
    card): params drawn from seed 0, zero optimizer state, the train step.
    Without a mesh the last slot is ``None``; with one (a ``DeviceMesh`` of
    ``device``'s type) the params are split over it (see
    :func:`shard_for_mesh`)."""
    dev = resolve_device(device)
    params, axes = models.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                      device=dev)
    if mesh is None:
        return (params, init_opt_state(params, opt_cfg),
                make_train_step(cfg, opt_cfg, ts_cfg), None)
    return shard_for_mesh(cfg, params, axes, opt_cfg, ts_cfg, mesh) + (mesh,)


def shard_for_mesh(cfg, params, axes, opt_cfg: AdamWConfig,
                   ts_cfg: TrainStepConfig, mesh):
    """``(params, opt_state, step_fn)`` of the sharded step on ``mesh``:
    ``params`` (the whole params module, the same on every rank, with its
    logical-axes tree ``axes``) split over the mesh in place by
    ``rules_for_mesh(mesh)``; zero moments placed as the params are;
    ``step_fn(params, opt_state, batch)`` takes the global batch (the same
    on every rank), splits it on ``"batch"`` and runs the train step under
    the rules, plain tensors made inside the models entering replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules = rules_for_mesh(mesh)
    named = dict(params.named_parameters())
    S.device_put(params, S.tree_shardings(named, param_axes(params, axes),
                                          rules, mesh), mesh)
    step = make_train_step(cfg, opt_cfg, ts_cfg)

    def step_fn(p, o, batch):
        b = S.batch_put(batch, cfg, rules, mesh)
        with activation_rules(rules), implicit_replication():
            return step(p, o, b)

    return params, init_opt_state(params, opt_cfg), step_fn


def state_tree(params, opt_state) -> dict:
    """The checkpoint tree of a run: ``{"params": {name: tensor}, "opt"}``."""
    return {"params": dict(params.named_parameters()), "opt": opt_state}


@torch.no_grad()
def restore_into(root: str, params, opt_state, step=None, mesh=None):
    """Restore a run's checkpoint (``step=None`` takes ``LATEST``) into
    ``params`` (copied in place) and return ``(opt_state, step)``. On a
    ``mesh`` each leaf lands on the placements the run's own leaf has."""
    proto = state_tree(params, opt_state)
    tree, step = checkpoint.restore(
        root, proto, step=step, mesh=mesh,
        shardings=None if mesh is None else S.placements_of(proto))
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
    return run(args, resolve_device(args.device))


def run(args: argparse.Namespace, dev: torch.device, mesh=None):
    """The driver's loop on ``dev``, or on ``mesh`` (every rank runs it;
    rank 0 prints and writes the checkpoints). Returns the losses."""
    cfg, opt_cfg, ts_cfg, dcfg = configs(args)
    params, opt_state, step_fn, _ = build(cfg, opt_cfg, ts_cfg, device=dev,
                                          mesh=mesh)
    quiet = mesh is not None and mesh.get_rank() != 0

    def say(text):
        if not quiet:
            print(text, flush=True)

    start = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        opt_state, start = restore_into(args.ckpt_dir, params, opt_state,
                                        mesh=mesh)
        say(f"[train] resumed from step {start}")

    losses = []
    t0 = time.time()
    pending_ckpt = None
    for s in range(start, args.steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_on(dcfg, s, dev))
        losses.append(float(m["loss"]))
        if (s + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            say(f"[train] step {s+1}/{args.steps} loss={losses[-1]:.4f} "
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
        say(f"[train] done. first loss {losses[0]:.4f} -> "
            f"last {losses[-1]:.4f}")
    return losses


def train_on_mesh(pmesh, mesh_shape=(2, 2), **flags) -> dict:
    """A :func:`repro_torch.launch.run_ranks` target: the driver on a mesh
    of ``mesh_shape`` (axes ``("data", "model")``, with ``"pod"`` leading
    a 3-d shape) over the launch's ranks, on their device. ``flags`` are
    the CLI's flags by their argument names (``arch="qwen3-4b"``,
    ``smoke=True``, ``steps=4``, ...). Returns this rank's losses."""
    from .mesh import make_mesh
    args = parse_args([])
    unknown = set(flags) - set(vars(args))
    if unknown:
        raise TypeError(f"train_on_mesh: unknown flags {sorted(unknown)}")
    vars(args).update(flags, device=pmesh.device.type)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = make_mesh(mesh_shape, axes, pmesh.device)
    losses = run(args, pmesh.device, mesh)
    return dict(rank=pmesh.rank, losses=losses)


if __name__ == "__main__":
    main()
