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

import contextlib
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


# ---------------------------------------------------------------- folding
# one trace at a time folds loops; the weight is read from autograd's
# threads as well, so it is process state, not thread-local
class _Fold:
    on = False
    weight = 1


_FOLD = _Fold()


@contextlib.contextmanager
def folded_loops():
    """While active (the dry run's traces), a loop written over
    :func:`trips` runs only its first two trips, and :func:`trip_weight` is
    ``n - 1`` while the second runs: the reference's HLO walk counts a
    while body once times its trip count, and an op counter multiplies the
    second trip's ops by the weight. Trips 2..n must do the same work on
    the same shapes; :func:`trips` refuses a loop whose trips' operand
    shapes differ."""
    prev = _FOLD.on
    _FOLD.on = True
    try:
        yield
    finally:
        _FOLD.on = prev


def trips(items, n: int, *, backward_inside: bool = False):
    """The items of a loop of ``n`` trips that do the same work on the same
    shapes: all of them, or the first two under :func:`folded_loops`. A loop
    that autograd records folds only if each trip runs its own backward
    (``backward_inside``: a train step's microbatches), else one trip's
    graph would stand for all."""
    import torch
    if not _FOLD.on or n <= 1 or (torch.is_grad_enabled()
                                  and not backward_inside):
        yield from items
        return
    items = list(items)
    shapes = [_trip_shapes(x) for x in items]
    if len(items) != n or any(s != shapes[0] for s in shapes):
        raise ValueError(
            f"a folded loop needs {n} trips on the same shapes; got "
            f"{len(items)}: {sorted(set(shapes), key=str)[:3]}")
    weight = _FOLD.weight
    try:
        # the first trip, then one that stands for the other n - 1 (a first
        # trip may differ: the first microbatch writes the gradients the
        # others add into)
        yield items[0]
        _FOLD.weight = weight * (n - 1)
        yield items[1]
    finally:
        _FOLD.weight = weight


def _trip_shapes(item) -> tuple:
    """The shapes, dtypes and placements (of a DTensor) of the tensors in
    one trip's operands."""
    import torch
    from torch.utils._pytree import tree_flatten
    return tuple((tuple(t.shape), t.dtype, getattr(t, "placements", None))
                 for t in tree_flatten(item)[0]
                 if isinstance(t, torch.Tensor))


def trip_weight() -> int:
    """How many trips the op being run stands for (1 unless a folded loop
    runs: see :func:`folded_loops`)."""
    return _FOLD.weight
