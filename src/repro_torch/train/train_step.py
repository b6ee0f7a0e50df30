"""The train step (the port of ``repro.train.train_step``): loss ->
backward -> clip -> AdamW, with optional microbatch gradient accumulation
and NaN-step rejection.

The same step runs on one device (plain tensors) and on a mesh, where the
params and the batch are DTensors (``launch.train.build(mesh=)`` sets up
the rules context and the batch's split); there microbatch ``i`` is the
``i``-th block of the global rows, split on ``"batch"`` as the whole batch
was (the reference's reshape of the global batch), and the metrics come
back as plain tensors that every rank holds alike.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import models
from ..models.counting import trips
from ..models.params import cast_params
from ..parallel.sharding import fit_placements, whole
from .optimizer import AdamWConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1           # gradient accumulation steps
    # the reference donates the params and state buffers to its jitted
    # step; the port's step updates them in place, so the flag has no
    # meaning here and is kept for the reference's signature
    donate: bool = True
    # mixed precision: the forward reads bf16 copies of the fp32 params,
    # cast inside the autograd graph, so the gradients land on the fp32
    # masters the optimizer updates
    bf16_compute_params: bool = False


def make_train_step(model_cfg, opt_cfg: AdamWConfig,
                    ts_cfg: TrainStepConfig = TrainStepConfig()):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``. ``params`` is the params module (its parameters
    are switched to ``requires_grad``), ``opt_state`` the optimizer's
    state; both are updated in place and returned. ``batch`` maps names to
    tensors on the params' device. ``metrics`` holds 0-d tensors: ``loss``,
    the loss function's own metrics (``nll``, ``aux``; the last
    microbatch's), ``lr``, ``grad_norm`` and ``skipped``."""

    def loss_for(params, mb):
        if ts_cfg.bf16_compute_params:
            params = cast_params(params, torch.bfloat16)
        return models.loss_fn(model_cfg, params, mb)

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        n = max(1, ts_cfg.microbatches)
        if n == 1:
            mbs = [batch]
        else:
            mbs = _microbatches(batch, n)
        loss_sum = None
        for mb in trips(mbs, n, backward_inside=True):
            loss, metrics = loss_for(params, mb)
            # fp32 gradients accumulate in .grad across microbatches
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        if n > 1:
            with torch.no_grad():
                for p in named.values():
                    if p.grad is not None:
                        p.grad.div_(n)
        loss = whole(loss_sum / n if n > 1 else loss_sum)
        grads = {k: p.grad for k, p in named.items()}
        _, _, opt_metrics = adamw_update(opt_cfg, grads, params, opt_state,
                                         skip=~torch.isfinite(loss))
        for p in named.values():
            p.grad = None
        out = {"loss": loss,
               **{k: whole(v.detach()) for k, v in metrics.items()},
               **opt_metrics}
        return params, opt_state, out

    return train_step


def _microbatches(batch, n: int) -> list:
    """The ``n`` microbatches of a batch: microbatch ``i`` holds the
    ``i``-th of ``n`` equal blocks of the global rows (the reference's
    ``reshape_mb``). A DTensor leaf is gathered whole once (the batch is
    token ids and inputs, small beside the step's other traffic) and each
    block is split again on the leaf's own placements, so every rank keeps
    its share of every microbatch. A block whose rows do not split evenly
    over the ranks its rows are split over is replicated on them instead
    (``fit_placements``, the rule by which the models' ``constrain`` drops
    a ``"batch"`` split): every such rank runs the whole block, and
    DTensor's gradient reduction counts it once."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"batch {k} of {rows} rows does not split into "
                             f"{n} microbatches: {(rows, n)}")
        full = whole(x)
        blocks = full.reshape(n, rows // n, *full.shape[1:])
        if isinstance(x, DTensor):
            where = fit_placements(blocks.shape[1:], x.placements,
                                   x.device_mesh)
        for i in range(n):
            out[i][k] = (blocks[i] if not isinstance(x, DTensor) else
                         distribute_tensor(blocks[i], x.device_mesh, where,
                                           src_data_rank=None))
    return out
