"""AdamW (the port of ``repro.train.optimizer``): linear warmup + cosine
decay, global-norm clipping, NaN-step rejection, moments stored in
``moment_dtype`` (``"bfloat16"`` halves the optimizer's memory). All update
math is in fp32 whatever the storage dtype.

``params`` is the params module (``models.init_params``) or a mapping of
name -> tensor; the state is ``{"m": {name: tensor}, "v": {name: tensor},
"step": int32 0-d tensor}``, keyed by the port's parameter names
(``convert.opt_state_from_arrays`` maps the reference's stacked trees onto
them). :func:`adamw_update` updates the params and the state **in place**,
leaf by leaf, so its temporaries never exceed a few copies of one leaf; a
parameter with no gradient (``None``) counts as a zero gradient, so it
still decays.

On a mesh the params are DTensors (``launch.specs.device_put``), the
moments are placed as their params are, and ``step`` stays a plain tensor
that every rank holds alike (as do ``lr`` and ``skip``): a gradient is
first brought to its param's placements (a ``Partial`` one is
reduce-scattered, FSDP's reduction), the norm is taken over all shards,
and the update runs on each rank's local shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..models.params import dtype_of
from ..parallel.sharding import local, redistribute, whole


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


def named_params(params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a params module or mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _state(params, cfg: AdamWConfig, moment, make):
    mdt = dtype_of(cfg.moment_dtype)
    named = named_params(params)
    dev = next(iter(named.values())).device if named else torch.device("cpu")
    return {
        "m": {n: moment(p, mdt) for n, p in named.items()},
        "v": {n: moment(p, mdt) for n, p in named.items()},
        "step": make((), torch.int32, dev),
    }


def init_opt_state(params, cfg: AdamWConfig):
    """Zero moments in ``moment_dtype``, each placed as its parameter is
    (its device; on a mesh, its DTensor placements)."""
    return _state(params, cfg,
                  lambda p, dt: torch.zeros_like(p, dtype=dt,
                                                 requires_grad=False),
                  lambda s, dt, dev: torch.zeros(s, dtype=dt, device=dev))


def abstract_opt_state(params, cfg: AdamWConfig):
    """The state's shapes and dtypes as meta tensors (no allocation);
    ``params`` may itself live on the meta device."""
    def make(s, dt, dev):
        return torch.empty(s, dtype=dt, device="meta")
    return _state(params, cfg, lambda p, dt: make(p.shape, dt, None), make)


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a tensor or an int), an fp32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tensors) -> torch.Tensor:
    """fp32 L2 norm over the tensors (``None`` entries count as zeros); a
    plain 0-d tensor, over every shard of DTensor entries."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors if t is not None]
    if not sq:
        return torch.zeros(())
    return whole(torch.sqrt(sum(sq)))


def _placed_as(g, p):
    """Gradient ``g`` on its param's placements (``None`` stays)."""
    from torch.distributed.tensor import DTensor
    if g is None or not isinstance(p, DTensor):
        return g
    return redistribute(g, p.placements)



@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, Optional[torch.Tensor]],
                 params, state, *, skip=None):
    """One AdamW step, in place. ``grads`` maps parameter names to
    gradients (a missing name or ``None`` is a zero gradient). ``skip`` (a
    bool 0-d tensor) freezes params and state (NaN-step rejection), as does
    a non-finite gradient norm. Returns ``(params, state, metrics)``: the
    same objects, updated, and ``{"lr", "grad_norm", "skipped"}`` as 0-d
    device tensors."""
    named = named_params(params)
    grads = {n: _placed_as(grads.get(n), p) for n, p in named.items()}
    step = state["step"]
    dev = step.device
    lr = schedule(cfg, step)
    gnorm = global_norm(grads[n] for n in named).to(dev)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else torch.ones((), device=dev))
    skip = (torch.zeros((), dtype=torch.bool, device=dev) if skip is None
            else torch.as_tensor(skip, device=dev))
    skip = skip | ~torch.isfinite(gnorm)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for name, p in named.items():
        p, g, m, v = (local(t) for t in (p, grads[name], state["m"][name],
                                          state["v"][name]))
        # jnp.where-style selects (never an arithmetic blend: 0 * NaN would
        # poison the params); fresh fp32 temporaries, updated in place
        g32 = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               if g is None else g.float() * scale)
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        del g32
        den = torch.sqrt(v32 / bc2).add_(cfg.eps)
        u = (m32 / bc1).div_(den)
        del den
        u.add_(cfg.weight_decay * p.float())
        p_new = p.float() - lr * u
        del u
        p.copy_(torch.where(skip, p.float(), p_new))
        del p_new
        m.copy_(torch.where(skip, m.float(), m32))
        v.copy_(torch.where(skip, v.float(), v32))
    step.add_((~skip).to(step.dtype))
    return params, state, {"lr": lr, "grad_norm": gnorm,
                           "skipped": skip.to(torch.int32)}
