"""Parameter counting from the abstract (never-allocated) params tree — the
port of ``repro.models.counting``.

The tree is built on the ``meta`` device, and every leaf is counted at its
shape in the reference's layout (``params.reference_leaves``: a stacked
leaf carries its leading layers dim), so the routed-expert test below
reads the same shapes as the reference's.

MODEL_FLOPS accounting: 6·N·D for dense training steps, 6·N_active·D for
MoE (N_active = non-expert params + top_k/E of routed expert params +
shared experts).
"""
from __future__ import annotations

import math

from .params import reference_leaves, reference_shape


def _leaves(cfg):
    from . import init_params
    params, _ = init_params(cfg, device="meta")
    for path, parts, stacked in reference_leaves(params):
        yield path, reference_shape(parts, stacked)


def param_count(cfg) -> int:
    return int(sum(math.prod(shape) for _, shape in _leaves(cfg)))


def expert_param_count(cfg) -> int:
    """Routed-expert params only (w_gate/w_up/w_down with an experts dim)."""
    if cfg.moe is None:
        return 0
    total = 0
    for path, shape in _leaves(cfg):
        # routed experts have a num_experts dim
        if path[-1] in ("w_gate", "w_up", "w_down") \
                and cfg.moe.num_experts in shape:
            total += math.prod(shape)
    return total


def active_param_count(cfg) -> int:
    n = param_count(cfg)
    if cfg.moe is None:
        return n
    routed = expert_param_count(cfg)
    active_routed = routed * cfg.moe.top_k / cfg.moe.num_experts
    return int(n - routed + active_routed)


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (forward-only prefill) / 2·N per token (decode),
    using active params for MoE."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
