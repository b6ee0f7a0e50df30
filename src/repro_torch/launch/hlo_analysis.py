"""Per-rank op counts for the dry run's roofline terms (the port of
``repro.launch.hlo_analysis``; the name is kept so a reader finds it).

The reference walks the optimized per-device HLO text of a compiled SPMD
module. The port has no HLO: it counts a *recorded eager program*.
:func:`count_ops` is a ``TorchDispatchMode`` that sees every ATen op run
inside it, forward, backward and optimizer alike, and yields an
:class:`HloStats` with the reference's fields:

  * ``dot_flops``       — the FLOPs of every matmul-like op (``mm``,
                          ``bmm``, ``addmm``, ``baddbmm``, the convolution
                          and attention ops) by ``torch.utils.flop_counter``'s
                          registry, on the op's own shapes (2 x prod(result)
                          x prod(contracting), as the reference counts a
                          ``dot``);
  * ``boundary_bytes``  — operand + result bytes of every op. The reference
                          counts only fusion boundaries; eager torch fuses
                          nothing, so every op is a boundary and this is an
                          upper bound on the traffic a fused program would
                          need. The reference's rules for slice-like ops are
                          kept: a gather/index/embedding op costs 2 x its
                          result, a scatter/``index_put``/``slice_scatter``
                          2 x its update. Views, ``empty`` and ``detach``
                          move nothing and are skipped, as the reference
                          skips parameters, constants, tuples and bitcasts;
  * collective bytes by kind — the ``_c10d_functional``/``c10d`` ops mapped
                          onto the reference's five kinds, each call's bytes
                          counted as its *result* shape (the reference's
                          convention: an all-gather counts the gathered
                          tensor, a reduce-scatter the scattered shard).
                          ``collective_sent_bytes_by_kind`` (the port's
                          addition) counts each call's input instead;
  * ``while_trip_counts`` — eager code unrolls the loops the reference scans
                          (microbatches, layer groups), so every op above is
                          already counted once per trip; the dry run records
                          those loops' trip counts here for the reader. A
                          loop that runs folded (``models.counting.trips``
                          under ``folded_loops``: a train step's
                          microbatches, flash attention's kv-chunk loop
                          outside autograd) runs two trips, the second's ops
                          counted for the other n - 1, as the reference
                          counts a while body times its trip count.

**Local ops.** When a ``DTensor`` is among an op's types the mode returns
``NotImplemented`` (as ``CommDebugMode`` does), so DTensor runs the op on
this rank's shards and the mode counts the local ops and the collectives
they issue: every number is per rank, as the reference's SPMD module is per
device. The ops DTensor runs on global-shape fake tensors while it
propagates shardings (the first time it meets an op schema) are not this
rank's work and are not counted (:func:`in_sharding_propagation`). Under
``FakeTensorMode`` the counts come from shapes alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict, List

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# op name (``func.overloadpacket.__name__``) -> the reference's kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute", "isend": "collective-permute",
    "irecv": "collective-permute", "batch_p2p_ops": "collective-permute",
}
# ops of the collective namespaces that move nothing themselves
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
# c10d ops that write their result into args[0] and read args[0] too
_C10D_IN_PLACE = ("allreduce_", "allreduce_coalesced_", "send")

# gather-like ops touch only what they read: 2 x the result
_GATHER_OPS = {"index", "gather", "index_select", "embedding",
               "take_along_dim", "take"}
# scatter-like ops: 2 x the update (position of the update argument)
_SCATTER_UPDATE_ARG = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
                       "scatter": 3, "scatter_": 3, "scatter_add": 3,
                       "scatter_add_": 3, "scatter_reduce": 3,
                       "scatter_reduce_": 3, "index_add": 3, "index_add_": 3,
                       "slice_scatter": 1, "select_scatter": 1,
                       "diagonal_scatter": 1, "index_copy": 3,
                       "index_copy_": 3}
# ops that move no bytes
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "detach_", "lift_fresh",
             "wait_tensor", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "_local_scalar_dense", "set_", "resize_",
             "record_stream"}


@dataclasses.dataclass
class HloStats:
    dot_flops: float
    boundary_bytes: float
    collective_bytes_by_kind: Dict[str, float]
    collective_counts: Dict[str, int]
    while_trip_counts: List[int]
    # the port's addition: each collective call's input bytes by kind
    collective_sent_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective_bytes_by_kind.values())


def empty_stats() -> HloStats:
    return HloStats(0.0, 0.0, {k: 0.0 for k in KINDS}, {k: 0 for k in KINDS},
                    [], {k: 0.0 for k in KINDS})


def nbytes(x) -> int:
    """Bytes of a tensor, or of the tensors in a (nested) list or tuple;
    anything else is 0."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(nbytes(y) for y in x)
    return 0


def _counter(stats: HloStats):
    """The dispatch mode behind :func:`count_ops` (built at call time:
    importing this module imports no torch)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry as registry

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not in_sharding_propagation():
                _count(stats, registry, func, args, kwargs, out)
            return out

    return Counter()


# torch-internal names the per-rank counts rely on: the frame of
# DTensor's sharding propagation on global shapes, and the modules whose
# host-side index arithmetic the dry run's fake mode runs on real tensors.
# A torch that renames one would have the counters take global-shape ops
# for this rank's, silently: :func:`check_torch_internals` refuses it
PROPAGATION_FRAME = "_propagate_tensor_meta_non_cached"
INDEX_MATH_FILES = ("distributed/tensor/placement_types.py",
                    "distributed/tensor/_utils.py")


def check_torch_internals() -> None:
    """Raise ``RuntimeError`` if the installed torch lacks a name above."""
    import os
    import torch
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    root = os.path.dirname(torch.__file__)
    missing = [f"ShardingPropagator.{PROPAGATION_FRAME}"] if not hasattr(
        ShardingPropagator, PROPAGATION_FRAME) else []
    missing += [f"torch/{f}" for f in INDEX_MATH_FILES
                if not os.path.isfile(os.path.join(root, f))]
    if missing:
        raise RuntimeError(
            f"torch {torch.__version__} lacks {', '.join(missing)}: the "
            "per-rank op counts cannot tell DTensor's sharding propagation "
            "from this rank's work (launch.hlo_analysis)")


def in_sharding_propagation() -> bool:
    """Whether the op being dispatched is one DTensor runs on global-shape
    fake tensors to learn an output's shape (``ShardingPropagator``'s
    tensor-meta propagation, the first time it meets an op schema): not
    this rank's work. Under an outer ``FakeTensorMode`` it runs in that
    same mode, so only the call stack tells it apart."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == PROPAGATION_FRAME:
            return True
        f = f.f_back
    return False


def _count(stats: HloStats, registry, func, args, kwargs, out):
    from ..models.counting import trip_weight
    n = trip_weight()
    if n == 1:
        _count_once(stats, registry, func, args, kwargs, out)
        return
    # an op of a folded loop's second trip stands for n - 1 trips
    one = empty_stats()
    _count_once(one, registry, func, args, kwargs, out)
    stats.dot_flops += n * one.dot_flops
    stats.boundary_bytes += n * one.boundary_bytes
    for kind, c in one.collective_counts.items():
        if c:
            for d, o in ((stats.collective_bytes_by_kind,
                          one.collective_bytes_by_kind),
                         (stats.collective_sent_bytes_by_kind,
                          one.collective_sent_bytes_by_kind)):
                d[kind] = d.get(kind, 0.0) + n * o[kind]
            stats.collective_counts[kind] = \
                stats.collective_counts.get(kind, 0) + n * c


def _count_once(stats: HloStats, registry, func, args, kwargs, out):
    name = func.overloadpacket.__name__
    ns = func.namespace
    if ns in ("_c10d_functional", "c10d", "c10d_functional"):
        if name in _NOT_COLLECTIVES:
            return
        kind = _COLLECTIVE_KIND.get(name, name)
        if ns == "c10d":
            # the legacy ops write their result into args[0]
            result = nbytes(args[0])
            sent = nbytes(args[0] if name in _C10D_IN_PLACE else args[1])
        else:
            result = nbytes(out)
            sent = nbytes(args[0])
        for d in (stats.collective_bytes_by_kind,
                  stats.collective_sent_bytes_by_kind):
            d.setdefault(kind, 0.0)
        stats.collective_counts.setdefault(kind, 0)
        stats.collective_bytes_by_kind[kind] += result
        stats.collective_sent_bytes_by_kind[kind] += sent
        stats.collective_counts[kind] += 1
        stats.boundary_bytes += result + sent
        return
    packet = func.overloadpacket
    if packet in registry:
        stats.dot_flops += float(registry[packet](*args, **kwargs,
                                                  out_val=out))
    if func.is_view or name in _NO_BYTES:
        return
    result = nbytes(out)
    if name in _GATHER_OPS:
        stats.boundary_bytes += 2 * result
        return
    at = _SCATTER_UPDATE_ARG.get(name)
    if at is not None:
        upd = nbytes(args[at]) if len(args) > at else 0
        upd = upd or result
        stats.boundary_bytes += 2 * min(upd, result or upd)
        return
    stats.boundary_bytes += result + nbytes(list(args)) \
        + nbytes(list(kwargs.values()))


@contextlib.contextmanager
def count_ops():
    """Count every op run inside the block on this rank; yields the
    :class:`HloStats` it fills in (read it after the block)."""
    check_torch_internals()
    stats = empty_stats()
    with _counter(stats):
        yield stats
