"""Launchers of the port.

This package starts the ranks of a process mesh: one process per rank, each
running one importable function, joined into a ``torch.distributed`` group.
Its submodules :mod:`repro_torch.launch.serve` and
:mod:`repro_torch.launch.train` are the LM lane's batched serving command
and its training driver (one device, or a ``DeviceMesh`` of ranks through
``train_on_mesh``); :mod:`repro_torch.launch.mesh` and
:mod:`repro_torch.launch.specs` build the meshes and the abstract inputs
and placements the sharded trainer uses.

    python -m repro_torch.launch --ranks 4 --device cpu --scale 12
    python -m repro_torch.launch --ranks 4 --device cuda --engine fused_pallas
    python -m repro_torch.launch.serve --arch qwen3-4b --smoke --device cpu
    python -m repro_torch.launch.train --arch mamba2-130m --smoke --device cpu

The ranks command (``__main__``) colors an R-MAT graph with ``strategy="distributed"`` on
``--ranks`` ranks and prints one line per rank (the ranks must agree, and
rank 0 validates the coloring). From Python, :func:`run_ranks` runs any
``"module:function"`` target: each rank calls ``target(mesh, **kwargs)``
with its :class:`repro_torch.core.distributed.ProcessMesh` and returns a
JSON value; ``run_ranks`` returns them in rank order.

Each rank is a subprocess with ``RANK``/``WORLD_SIZE`` in its environment
that joins the group through a file store in a fresh directory
(``init_method="file://..."``), so concurrent launches never share a port.
Backend and device: ``gloo`` on the CPU; ``gloo`` with ``device="cuda"``
for ranks sharing a card (rank r takes card ``r % count``); ``nccl`` with
one card per rank (rank r takes card r). A rank that fails, or a launch
that outlives ``timeout``, kills every rank and raises with the failing
rank's error output.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Any, List, Optional

from repro_torch.core.graph import DeviceSpec, resolve_device


def rank_device(backend: str, device: str, rank: int, world_size: int) -> str:
    """The device rank ``rank`` runs on (see the module docstring)."""
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs device='cuda'")
        return "cpu"
    import torch
    count = torch.cuda.device_count()
    if backend == "nccl":
        if world_size > count:
            raise ValueError(f"NCCL takes one card per rank: {world_size} "
                             f"ranks, {count} cards (use gloo to share)")
        return f"cuda:{rank}"
    return f"cuda:{rank % max(1, count)}"


def run_ranks(target: str, world_size: int, kwargs: Optional[dict] = None,
              *, backend: str = "gloo", device: DeviceSpec = None,
              timeout: float = 600.0,
              workdir: Optional[str] = None) -> List[Any]:
    """Run ``target(mesh, **kwargs)`` on ``world_size`` ranks and return
    the ranks' results in rank order. ``target`` is ``"module:function"``,
    importable from this process's ``sys.path``; ``workdir`` holds the
    store and the rank outputs (a fresh temporary directory by default).
    ``device`` is ``"cpu"`` or ``"cuda"``; ``None`` means ``"cuda"``, and
    raises without a card, as every entry point of the port does."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; use gloo or nccl")
    device = resolve_device(device).type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"ranks run on 'cpu' or 'cuda', got {device!r}")
    workdir = workdir or tempfile.mkdtemp(prefix="ranks-")
    os.makedirs(workdir, exist_ok=True)
    job = dict(target=target, kwargs=kwargs or {}, backend=backend,
               device=device, timeout=timeout,
               store=os.path.join(workdir, "store"))
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump(job, f)
    env = dict(os.environ, WORLD_SIZE=str(world_size),
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    procs, logs = [], []
    try:
        for r in range(world_size):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch",
                 "--rank-of", workdir],
                env=dict(env, RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > deadline:
                r = bad[0] if bad else None
                for p in procs:
                    p.kill()
                for p in procs:
                    p.wait()
                what = (f"rank {r} exited with code {codes[r]}" if bad else
                        f"the ranks did not finish within {timeout:.0f} s")
                tail = ""
                for i in ([r] if bad else range(world_size)):
                    with open(os.path.join(workdir, f"rank{i}.log")) as f:
                        tail += f"\n--- rank {i} ---\n" + f.read()[-4000:]
                raise RuntimeError(f"run_ranks({target}): {what}{tail}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for r in range(world_size):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _rank_main(workdir: str) -> None:
    """One rank: join the group, build the mesh, run the target, write
    its result."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import ProcessMesh
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = rank_device(job["backend"], job["device"], rank, world)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    extra = {}
    if job["backend"] == "nccl":
        extra["device_id"] = torch.device(device)
    dist.init_process_group(job["backend"],
                            init_method="file://" + job["store"],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=job["timeout"]),
                            **extra)
    try:
        mesh = ProcessMesh(dist.group.WORLD, device)
        module, name = job["target"].split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(mesh, **job["kwargs"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def color_rmat(mesh, scale: int = 10, **spec) -> dict:
    """The command's target: color the seed-0 RMAT-ER graph of ``scale``
    on this rank's mesh."""
    import hashlib
    from repro_torch.core import ColoringSpec, color, rmat, validate_coloring
    g = rmat.paper_graph("RMAT-ER", scale, seed=0)
    rep = color(g, ColoringSpec(strategy="distributed", mesh=mesh, **spec))
    return dict(rank=mesh.rank, route=mesh.route, device=str(mesh.device),
                rounds=rep.rounds, colors=rep.num_colors,
                sweeps=rep.sweeps_per_round.tolist(),
                conflicts=rep.conflicts_per_round.tolist(),
                frontier=rep.frontier_sizes_per_round.tolist(),
                wall_s=rep.wall_time_s,
                sha256=hashlib.sha256(rep.colors.tobytes()).hexdigest(),
                valid=bool(validate_coloring(g, rep.colors))
                if mesh.rank == 0 else None)
