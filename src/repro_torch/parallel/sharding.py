"""Logical-axis sharding rules (FSDP x TP x SP x EP), MaxText-style (the
port of ``repro.parallel.sharding``).

Params and activations are annotated with *logical* axis names; a ``Rules``
table maps each logical name to mesh axes. The defaults implement:

  batch       -> ("pod", "data")   data parallel (pod axis = DP by default)
  seq         -> "model"           sequence parallelism between blocks
  embed       -> "data"            ZeRO-3/FSDP shard of the non-TP param dim
  heads/mlp/vocab -> "model"       tensor parallelism
  experts     -> "model"           expert parallelism (deepseek; grok opts out
                                   via MoEConfig.partition="tensor")

A mapping whose mesh-axis product does not divide the dim is dropped for
that dim (replicated): 8 kv heads on ``model=16`` stay whole.

A :class:`Spec` is the port's ``PartitionSpec``: one entry per tensor dim,
each ``None``, a mesh axis name or a tuple of them. :func:`placements`
turns it into the ``Shard``/``Replicate`` placements of a
``torch.distributed.tensor.DeviceMesh``, one per mesh dim. A mesh here is a
``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``) or any object with
``axis_names`` and a ``shape`` (or ``devices.shape``, as the reference's
meshes have), so the production meshes' specs need no process group.

``constrain`` redistributes a ``DTensor`` activation only when a rules
context is active, so the same model code runs on plain tensors on one
device (the identity) and sharded over a mesh under
:func:`activation_rules`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """A partition spec: a tuple of per-dim mesh axes (``None``, a name, or
    a tuple of names), equal entry for entry to the reference's
    ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    table: Dict[str, MeshAxes]

    def resolve(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.table.get(logical, None)

    def override(self, **kw) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t)

    def pruned(self, mesh_axis_names) -> "Rules":
        """Drop mesh axes absent from the target mesh (e.g. "pod" on the
        single-pod mesh)."""
        known = set(mesh_axis_names)

        def prune(v):
            if v is None:
                return None
            parts = (v,) if isinstance(v, str) else tuple(v)
            kept = tuple(p for p in parts if p in known)
            if not kept:
                return None
            return kept[0] if len(kept) == 1 else kept

        return Rules({k: prune(v) for k, v in self.table.items()})


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh, in mesh-dim order (see the module
    docstring for what a mesh may be)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = getattr(mesh, "shape", None)
    if shape is None:
        shape = mesh.devices.shape
    return dict(zip(names, tuple(shape)))


def rules_for_mesh(mesh, base: "Rules" = None) -> "Rules":
    return (base or DEFAULT_RULES).pruned(mesh_axes(mesh))


DEFAULT_RULES = Rules({
    "batch": ("pod", "data"),
    "seq": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_lora": None,
    "layers": None,
    "cache_seq": "model",   # decode KV caches: sequence-sharded (LSE combine)
    "cache_batch": ("pod", "data"),
    "rnn": "model",
    "state": None,
})


def _dedup(axes_tuple):
    """Drop mesh axes already used by an earlier dim (a spec must not
    repeat a mesh axis); later dims lose."""
    used = set()
    out = []
    for a in axes_tuple:
        if a is None:
            out.append(None)
            continue
        parts = (a,) if isinstance(a, str) else tuple(a)
        kept = tuple(p for p in parts if p not in used)
        used.update(kept)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(kept)
    return tuple(out)


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: Rules,
                    mesh=None) -> Spec:
    """Map a tuple of logical axis names to a :class:`Spec` (no
    divisibility check: :func:`spec_for_array` has the dims)."""
    resolved = tuple(rules.resolve(a) for a in logical_axes)
    return Spec(*_dedup(resolved))


def _splits(size: int, parts: int) -> bool:
    """Whether a dim of ``size`` splits into ``parts`` equal shards: the
    one rule by which a split is kept, or dropped and the dim replicated."""
    return parts != 0 and size % parts == 0


def _divisible(shape, resolved, sizes: Dict[str, int]):
    """``resolved`` with every mapping whose mesh-axis product does not
    divide its dim dropped."""
    out = list(resolved)
    for i, r in enumerate(out):
        if r is None:
            continue
        parts = (r,) if isinstance(r, str) else tuple(r)
        prod = 1
        for pp in parts:
            prod *= sizes.get(pp, 1)
        if not _splits(shape[i], prod):
            out[i] = None
    return tuple(out)


def fit_placements(shape, where, mesh) -> tuple:
    """DTensor placements ``where`` for a tensor of ``shape``, with the
    ``Shard(d)`` entries of every dim ``d`` that their mesh dims do not
    split evenly made ``Replicate()``: :func:`spec_for_array`'s rule, on
    placements."""
    from torch.distributed.tensor import Replicate
    where = tuple(where)
    sizes = tuple(mesh_axes(mesh).values())
    drop = set()
    for d in {p.dim for p in where if p.is_shard()}:
        prod = math.prod(n for n, p in zip(sizes, where) if p.is_shard(d))
        if not _splits(shape[d], prod):
            drop.add(d)
    return tuple(Replicate() if p.is_shard() and p.dim in drop else p
                 for p in where)


def spec_for_array(shape: Tuple[int, ...], logical_axes, rules: Rules,
                   mesh) -> Spec:
    """Like logical_to_spec but drops mappings whose mesh-axis product does
    not divide the dim size (replicate instead of erroring)."""
    resolved = tuple(rules.resolve(a) for a in logical_axes)
    return Spec(*_dedup(_divisible(tuple(shape), resolved, mesh_axes(mesh))))


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a
    mesh axis that shards tensor dim ``i`` is ``Shard(i)``, every other
    mesh dim ``Replicate()``, and so is an axis of size 1 (a split into
    one part is no split, and DTensor's view rules refuse some ops on it).
    A dim split over several mesh axes is split in mesh-dim order, as the
    reference splits it, so the spec must name them in that order."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(p) for p in parts]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {dim} over {parts}, "
                             f"out of the mesh's axis order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


# ---------------------------------------------------------------- context
_ctx = threading.local()


def current_rules():
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def activation_rules(rules: Optional[Rules]):
    """Enable ``constrain`` inside model code. No-op context when None."""
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield
    finally:
        _ctx.rules = prev


def constrain(x, logical_axes):
    """Redistribute a ``DTensor`` activation to the placements the active
    rules give ``logical_axes`` (the reference's
    ``with_sharding_constraint``); the identity when no rules are active or
    ``x`` is a plain tensor. Divisibility-aware: a mapping whose mesh-axis
    product does not divide the dim is dropped (replicated)."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return redistribute(x, placements(
        spec_for_array(tuple(x.shape), logical_axes, rules, mesh), mesh))


def redistribute(x, want: tuple):
    """The ``DTensor`` ``x`` on placements ``want``, its local tensor and
    its global strides both contiguous: DTensor
    runs an op's view decompositions against the global strides, so a
    local shard left as a strided slice (a split of an inner dim), or
    global strides that describe another layout than the local tensor's,
    would fail them."""
    from torch.distributed.tensor import DTensor
    want = tuple(want)
    y = x if tuple(x.placements) == want else x.redistribute(x.device_mesh,
                                                             want)
    local = y.to_local()
    if local.is_contiguous() and y.is_contiguous():
        return y
    return DTensor.from_local(local.contiguous(), y.device_mesh, want,
                              run_check=False, shape=y.shape,
                              stride=_contiguous_strides(y.shape))


def _contiguous_strides(shape) -> tuple:
    out, s = [], 1
    for n in reversed(tuple(shape)):
        out.append(s)
        s *= n
    return tuple(reversed(out))


def unshard(x, *dims):
    """``x`` with tensor dims ``dims`` made whole on every rank (their
    ``Shard`` placements become ``Replicate``); the identity on a plain
    tensor or where those dims are not sharded. The redistribute before an
    op whose DTensor sharding strategy is missing or wrong for a sharded
    operand dim (PERF.md section 6 lists the sites)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    return redistribute(x, tuple(
        Replicate() if isinstance(p, Shard) and p.dim in dims else p
        for p in x.placements))


def on_shards(fn, where: Optional[tuple], n_out: int,
              summed: Tuple[int, ...] = ()):
    """``fn`` run on each rank's local shards (``local_map``): every
    ``DTensor`` argument is redistributed to the placements ``where``, and
    the ``n_out`` outputs come back as DTensors on ``where``; those at
    indices ``summed`` are per-rank partial sums over the split dims
    (``Partial`` where ``where`` shards). ``where=None`` is ``fn`` itself
    (off a mesh). ``fn`` must compute each block of its outputs from the
    same block of its inputs; plain tensor arguments (positions, masks)
    reach every rank whole."""
    if where is None:
        return fn
    where = tuple(where)

    def call(*args):
        from torch.distributed.tensor import DTensor, Partial, Shard
        from torch.distributed.tensor.experimental import local_map
        dts = [a for a in args if isinstance(a, DTensor)]
        mesh = dts[0].device_mesh
        total = tuple(Partial() if isinstance(p, Shard) else p for p in where)
        args = [redistribute(a, where) if isinstance(a, DTensor) else a
                for a in args]
        outs = tuple(total if i in summed else where for i in range(n_out))
        ins = tuple(where if isinstance(a, DTensor) else None for a in args)
        return local_map(fn, out_placements=outs, in_placements=ins,
                         device_mesh=mesh)(*args)

    return call


def row_local(fn, n_out: int, summed: Tuple[int, ...] = ()):
    """``fn`` run on each rank's rows (:func:`on_shards` with dim 0 split
    as ``"batch"`` is and every other dim whole): the reference's
    row-local ops (sorts, searches, scatters and gathers batched over
    sequence rows) for which DTensor has no sharding strategy. Off a mesh
    (no active rules, or no ``DTensor`` argument) this is ``fn`` itself.
    ``fn`` must be row-local: row ``i`` of an output depends on row ``i``
    of the inputs only."""

    def call(*args):
        from torch.distributed.tensor import DTensor
        rules = current_rules()
        dts = [a for a in args if isinstance(a, DTensor)]
        if rules is None or not dts:
            return fn(*args)
        mesh = dts[0].device_mesh
        rows = placements(spec_for_array(
            (dts[0].shape[0],), ("batch",), rules, mesh), mesh)
        return on_shards(fn, rows, n_out, summed)(*args)

    return call


def split_last(x, n: int, e: int):
    """``x`` ``[..., n*e]`` as ``[..., n, e]`` (heads out of a projection).
    On a mesh the last dim is gathered first where its split would not
    fall on whole groups of ``e`` (``n`` not divisible by the ranks it is
    split over): DTensor cannot split a sharded dim into parts that cut
    the shards. The result's gradient comes back on the result's own
    placements (:func:`grad_as_placed`), which the backward's flatten
    takes."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.unflatten(-1, (n, e))
    d = x.ndim - 1
    parts = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(d):
            parts *= x.device_mesh.size(i)
    if n % parts:
        x = unshard(x, d)
    return grad_as_placed(x.unflatten(-1, (n, e)))


def merged(x, start: int, end: int):
    """``x.flatten(start, end)``; on a mesh its gradient comes back on the
    flattened tensor's own placements (:func:`grad_as_placed`), which the
    backward's split into the merged dims takes (a gradient split inside a
    merged dim's groups would not be)."""
    return grad_as_placed(x.flatten(start, end))


def block_of(shape, mesh, where: tuple):
    """``(sizes, offsets)`` of this rank's block of a tensor of ``shape``
    laid out as ``where`` (``Shard``/``Replicate`` placements) on
    ``mesh``, as DTensor cuts it (``torch.chunk``'s even blocks, a dim
    split over several mesh dims split in mesh-dim order). Plain integer
    arithmetic: it runs under ``FakeTensorMode`` too."""
    sizes, offs = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(where):
        if p.is_shard():
            d, n = p.dim, mesh.size(i)
            chunk = -(-sizes[d] // n)
            offs[d] += coord[i] * chunk
            sizes[d] = max(0, min(chunk, sizes[d] - coord[i] * chunk))
    return sizes, offs


def _local_block(x, want: tuple, mesh):
    """This rank's block of ``x`` laid out as ``want`` on ``mesh``: a
    ``DTensor`` is redistributed to ``want``; a plain tensor (the same on
    every rank) is cut to the block ``want`` gives this rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return redistribute(x, want).to_local()
    size, off = block_of(x.shape, mesh, want)
    return x[tuple(slice(o, o + n) for o, n in zip(off, size))]


def _seq_block(cache):
    """``(local tensor, offset of its block of dim 1)`` of a ``DTensor``
    cache ``[B, S, ...]``."""
    _, off = block_of(cache.shape, cache.device_mesh, cache.placements)
    return cache.to_local(), off[1]


def _value_placements(placements, seq_dims: int) -> tuple:
    """A value's placements beside a ``[B, S, ...]`` cache's: rows split
    as the cache's, the sequence whole; the value has ``seq_dims`` (0 or 1)
    dims where the cache has its sequence dim."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in placements:
        if not isinstance(p, Shard) or p.dim == 1:
            out.append(Replicate())
        elif p.dim == 0:
            out.append(Shard(0))
        else:
            out.append(Shard(p.dim - 1 + seq_dims))
    return tuple(out)


def write_rows(cache, pos, value):
    """``cache[b, pos[b]] = value[b]`` for every row ``b``, in place: a
    decode step's cache write (``cache`` ``[B, S, ...]``, ``pos`` ``[B]``,
    ``value`` ``[B, ...]``). On a mesh each rank writes into its own shard
    of the cache: the rows it holds, at the positions inside its block of
    the sequence (DTensor has no in-place strategy for an indexed write
    into a sequence-split cache)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.long()] = value
        return
    mesh = cache.device_mesh
    lc, lo = _seq_block(cache)
    rows_split = _value_placements(cache.placements, 0)
    lv = _local_block(value, rows_split, mesh)
    lp = _local_block(pos, tuple(p if p.is_shard(0) else Replicate()
                                 for p in rows_split), mesh)
    n = lc.shape[1]
    if n == 0 or lc.shape[0] == 0:
        return
    rel = lp.long() - lo
    inside = (rel >= 0) & (rel < n)
    rel = rel.clamp(0, n - 1)
    rows = torch.arange(lc.shape[0], device=lc.device)
    keep = lc[rows, rel]
    mask = inside.reshape(-1, *([1] * (keep.ndim - 1)))
    lc[rows, rel] = torch.where(mask, lv.to(lc.dtype), keep)


def write_seq(cache, value, slots=None):
    """``cache[:, :t] = value`` (``slots=None``; ``t`` = ``value``'s dim 1)
    or ``cache[:, slots] = value`` (``slots`` distinct positions), in
    place: a prefill's cache fill. On a mesh each rank writes the positions
    inside its block of the sequence into its own shard."""
    import torch
    from torch.distributed.tensor import DTensor
    if not isinstance(cache, DTensor):
        if slots is None:
            cache[:, :value.shape[1]] = value
        else:
            cache[:, slots] = value
        return
    mesh = cache.device_mesh
    lc, lo = _seq_block(cache)
    lv = _local_block(value, _value_placements(cache.placements, 1), mesh)
    n = lc.shape[1]
    if n == 0 or lc.shape[0] == 0:
        return
    if slots is None:
        slots = torch.arange(value.shape[1], device=lc.device)
    rel = slots.long() - lo
    # positions outside this rank's block land in a sink column, cut off
    idx = torch.where((rel >= 0) & (rel < n), rel, n)
    buf = torch.cat([lc, lc[:, :1]], dim=1)
    buf[:, idx] = lv.to(lc.dtype)
    lc.copy_(buf[:, :n])


def grad_as_placed(x):
    """``x`` itself, except that the backward pass brings its gradient to
    ``x``'s placements before it flows on: an op before it (a view that
    splits a dim) may accept only the placements its forward made. The
    identity on a plain tensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def on_mesh(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (an activation of a sharded step)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def whole(t):
    """A ``DTensor``'s global value as a plain tensor (a collective: every
    rank of its mesh calls it); any other value itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """A ``DTensor``'s local shard, sharing its storage (under
    ``no_grad``, a write lands in the DTensor); any other value itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t

