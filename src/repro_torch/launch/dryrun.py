"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
as rank 0 of the production meshes and read off the roofline terms (the
port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod|--both-meshes] [--out results/dryrun] \\
        [--tag baseline] [--bf16-params] [--microbatches N] [--device cpu]

The reference lowers and compiles each cell for 256 (512) TPU devices and
walks the compiled HLO. The port has no compiler to ask, so it *runs* the
cell as one rank of the mesh with nothing real underneath:

  * the default process group is ``torch.distributed``'s ``fake`` backend
    at world size 256 (512 for ``(2, 16, 16)``), this process rank 0: every
    collective returns at once, moving nothing;
  * every tensor is a ``FakeTensor`` (``FakeTensorMode``): shapes, dtypes
    and devices, no storage, so the full configs need no device memory;
  * the params, moments, batch and caches are DTensors on the production
    ``DeviceMesh`` (``launch.mesh.make_production_mesh``), placed by the
    sharding rules (``launch.train.shard_for_mesh``, ``launch.specs``), and
    the unchanged train step / prefill / decode runs on them, with one
    exception: a loop of identical trips (a train step's microbatches,
    each with its own backward; flash attention's kv-chunk loop outside
    autograd, 32 x 32 chunk pairs a layer at 32k) runs its first trip and
    one more whose ops count for the other n - 1
    (``models.counting.folded_loops``), as the reference's HLO walk counts
    a while body times its trip count.

Per cell this emits one JSON record with the reference's keys:
  * ``per_device``: FLOPs, bytes accessed, collective bytes by kind and
    their counts from ``hlo_analysis.count_ops`` over this rank's local ops
    (every op counted once per trip of the loops eager code unrolls or
    folds; ``while_trip_counts`` names the reference's scanned loops), and
    ``comm_debug_counts``, ``CommDebugMode``'s count of the collectives
    that ran (a folded loop's two trips once each);
  * ``memory_analysis``: ``argument_size_in_bytes`` (the local bytes of
    the inputs the cell reads: params, optimizer state, batch, caches; the
    reference's compiled program drops the inputs it never reads, such as a
    prefill's labels, a cache it only overwrites, or an encoder in decode,
    and so does this count), ``held_bytes`` (the port's addition: params,
    and a train step's moments, as the rank holds them at rest),
    ``output_size_in_
    bytes`` (the local bytes of what the cell returns), ``alias_size_in_
    bytes`` (outputs that are inputs updated in place), ``peak_memory_in_
    bytes`` (``MemTracker``'s peak over the cell, inputs included) and
    ``temp_size_in_bytes`` (peak - arguments). The reference's
    ``cost_analysis_*_once`` and ``generated_code_size_in_bytes`` have no
    eager meaning and are omitted, as the reference omits what it cannot
    read; ``compile_seconds`` is the time of the analysis after the trace
    (``lower_seconds`` = ``trace_seconds``, the trace itself);
  * ``roofline``: the three terms against the hardware model below,
    ``dominant`` and ``bound_s``; ``fit``: the peak against the card's
    memory, scaled by ``PEAK_CALIBRATION`` (the card's allocator peak over
    the traced peak on the one cell measured both ways;
    ``calibrated_peak_in_bytes``), one of "fits", "within the calibration
    gap" (only the unscaled peak fits) or "does not fit", and ``fits``
    (it fits with the margin); ``model_flops_*``, ``useful_flops_ratio``
    and ``roofline_fraction``, as the reference computes them.

**Hardware model**: one NVIDIA H100 80GB HBM3 (SXM5, 700 W), per card, from
NVIDIA's data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM, NVLink 4 at
450 GB/s per direction, 80 GB. A 16 x 16 mesh spans more than one 8-card
NVLink domain, so the slower links between hosts carry some of its
collectives: the collective term is a lower bound.

The ``rmat-coloring`` cell is the counterpart of ``lower_coloring``: the
port's distributed coloring is eager with a host sync every round, so it
cannot run on fake tensors. Its record is built from shapes, as the
reference lowers it: the port's collective call sites
(:func:`coloring_collectives`) with the wire's per-round and setup bytes by
tier from ``analysis.wirecost.closed_form_table``, over the reference's
``max_rounds`` envelope (every round the wider wire), and the per-rank
memory from the slab shapes (:func:`coloring_memory`).

A failing cell prints the op DTensor or fake mode refused; ``main`` exits 1
if any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback

from ..configs import ARCH_IDS, get_config
from ..models import counting
from ..models.config import SHAPES
from ..train import AdamWConfig

# ---- hardware model (NVIDIA H100 80GB HBM3, SXM5, 700 W; per card)
PEAK_FLOPS = 989e12          # dense bf16
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s per direction (NVLink 4)
HBM_BYTES = 80e9             # device memory
# the card's peak over the dry run's: on the one cell measured both ways
# (chip_smoke.py phases 13 (b) and 14 (b): qwen3-4b, 2 layers, float32,
# batch 4 x 512, a 1 x 1 mesh; NVIDIA H100 80GB HBM3, torch 2.11) a warm
# step's max_memory_allocated came out this factor above the traced peak:
# the allocator's rounding and what ops allocate inside themselves. A cell
# whose traced peak fits 80 GB only without it is "within the calibration
# gap"
PEAK_CALIBRATION = 23_633_060_864 / 23_455_580_160

# long_500k runs only for sub-quadratic archs (DESIGN.md §Arch-applicability)
LONG_OK = {"mamba2-130m", "recurrentgemma-2b"}

# per-arch gradient-accumulation defaults, the reference's, so the two
# packages' cells are the same cells
MICROBATCH_DEFAULTS = {
    "mistral-nemo-12b": 2, "qwen3-4b": 1, "starcoder2-3b": 2, "gemma2-2b": 2,
    "mamba2-130m": 1, "whisper-medium": 1, "recurrentgemma-2b": 2,
    "llama-3.2-vision-11b": 8, "grok-1-314b": 16, "deepseek-v2-lite-16b": 16,
}


def cells(arch=None, shape=None):
    for a in ARCH_IDS + ["rmat-coloring"]:
        if arch and a != arch:
            continue
        if a == "rmat-coloring":
            if shape in (None, "coloring"):
                yield a, "coloring"
            continue
        for s in SHAPES:
            if shape and s != shape:
                continue
            if s == "long_500k" and a not in LONG_OK:
                continue
            yield a, s


def _opt_cfg(cfg):
    # bf16 moments for the giants so optimizer state fits
    big = counting.param_count(cfg) > 50e9
    return AdamWConfig(moment_dtype="bfloat16" if big else "float32")


# in-place ops whose first argument is written, not read
_OVERWRITES = ("copy_", "fill_", "zero_")


# ---------------------------------------------------------------- the world
@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks (collectives return at once and move nothing);
    the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_fake_mode():
    """``FakeTensorMode`` for a rank's trace, with one exception: DTensor's
    host-side index arithmetic (the offsets of a ``_StridedShard``, a
    shard's global offset) builds index tensors and reads their values,
    which fake tensors do not have; those factory calls (and every op whose
    tensor inputs are all real) run on real CPU tensors. Everything the
    model, the optimizer and DTensor's sharding propagation make stays
    fake."""
    import torch
    from torch._subclasses.fake_tensor import (FakeTensor, FakeTensorMode,
                                               unset_fake_temporarily)
    from torch.utils._pytree import tree_flatten
    from .hlo_analysis import (INDEX_MATH_FILES, check_torch_internals,
                               in_sharding_propagation)
    check_torch_internals()

    def host_index_math(func, args, kwargs) -> bool:
        if func.overloadpacket.__name__.startswith("lift"):
            return False    # a constant the model makes: fake, as always
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        if tensors:
            return not any(isinstance(t, FakeTensor) for t in tensors)
        # the caller: the first frame past the dispatch modes and torch's
        # dispatch machinery
        f = sys._getframe(2)
        while f is not None and (
                f.f_code.co_name == "__torch_dispatch__"
                or ("/torch/" in f.f_code.co_filename
                    and "/distributed/tensor/" not in f.f_code.co_filename)):
            f = f.f_back
        # DTensor's host-side index arithmetic builds small CPU index
        # tensors and reads them back (``.tolist()``, ``int()``)
        return (f is not None
                and f.f_code.co_filename.endswith(INDEX_MATH_FILES)
                and not in_sharding_propagation())

    class RankFakeMode(FakeTensorMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if host_index_math(func, args, kwargs or {}):
                with unset_fake_temporarily():
                    return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    # the index tensors then meet fake shards (an index_select of a strided
    # shard): they enter the fake world as constants
    return RankFakeMode(allow_non_fake_inputs=True)


def _fake_params(cfg, dev):
    """``(params module, axes)`` of ``cfg`` with every parameter an empty
    tensor on ``dev`` (a fake tensor under ``FakeTensorMode``)."""
    import torch
    from torch import nn
    from .. import models
    params, axes = models.init_params(cfg, device="meta")
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod.register_parameter(leaf, nn.Parameter(
            torch.empty(p.shape, dtype=p.dtype, device=dev),
            requires_grad=False))
    return params, axes


def _placed(shapes, where, mesh, dev):
    """A tree of zero tensors of ``shapes`` (meta tensors) on ``dev``, each
    a DTensor on its placements in ``where``."""
    import torch
    from . import specs as S
    if isinstance(shapes, dict):
        return {k: _placed(v, where[k], mesh, dev) for k, v in shapes.items()}
    return S.distribute(torch.zeros(shapes.shape, dtype=shapes.dtype,
                                    device=dev), mesh, where)


def _leaves(tree):
    import torch
    from torch import nn
    if isinstance(tree, nn.Module):
        yield from (p for _, p in tree.named_parameters())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(tree, only=None) -> int:
    """This rank's bytes of the tensors in ``tree`` (a DTensor counts its
    local shard), each storage once; with ``only`` (a set of storage
    refs), just the tensors whose storage is in it."""
    from torch.multiprocessing.reductions import StorageWeakRef
    from ..parallel.sharding import local
    seen, total = set(), 0
    for t in _leaves(tree):
        t = local(t)
        ref = StorageWeakRef(t.untyped_storage())
        if ref in seen or (only is not None and ref not in only):
            continue
        seen.add(ref)
        total += t.numel() * t.element_size()
    return total


def _storages(tree) -> set:
    from torch.multiprocessing.reductions import StorageWeakRef
    from ..parallel.sharding import local
    return {StorageWeakRef(local(t).untyped_storage()) for t in _leaves(tree)}


def _read_inputs(inputs: set):
    """A dispatch mode that collects the storages of ``inputs`` (storage
    refs of the inputs' local tensors) that some op of this rank reads.
    A view or a metadata query (``prim.device``) reads nothing; the target
    of ``copy_``/``fill_``/``zero_`` is
    written, not read: an
    input that is only ever overwritten (a cache a prefill fills whole)
    or never touched (an encoder in decode) is not read. Read off
    ``.read`` after the block."""
    from torch.distributed.tensor import DTensor
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    import torch
    from .hlo_analysis import in_sharding_propagation

    class ReadInputs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.read = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            if not func.is_view and func.namespace != "prim" \
                    and not in_sharding_propagation():
                name = func.overloadpacket.__name__
                operands = args[1:] if name in _OVERWRITES else args
                for t in tree_flatten((operands, kwargs))[0]:
                    if isinstance(t, torch.Tensor):
                        ref = StorageWeakRef(t.untyped_storage())
                        if ref in inputs:
                            self.read.add(ref)
            return func(*args, **kwargs)

    return ReadInputs()


def _rank_mem_tracker():
    """``MemTracker`` for this rank: it tracks the local tensors DTensor
    runs on, but not the global-shape fake tensors DTensor's sharding
    propagation makes (under an outer ``FakeTensorMode`` the tracker cannot
    tell them apart by mode; a 256-rank cell's global logits alone would
    read as hundreds of GB)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from .hlo_analysis import in_sharding_propagation

    class RankMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if in_sharding_propagation():
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return RankMemTracker()


def _trip_counts(cfg, shape, microbatches: int) -> list:
    """The loops the reference scans and eager code unrolls: the
    microbatch loop of a train step, and the layer-group scan (forward, and
    backward for a train step)."""
    from ..models.transformer import arch_blocks
    groups = cfg.num_layers if cfg.family == "encdec" else arch_blocks(cfg)[2]
    trips = [groups] if shape.kind != "train" else [groups, groups]
    if shape.kind == "train" and microbatches > 1:
        trips = [microbatches] + trips
    return trips


def trace_cell(arch: str, shape_name: str, mesh, rules=None, *,
               bf16_params: bool = False, microbatches: int = 1,
               device=None, cfg=None, shape=None) -> dict:
    """Run one cell as this rank of ``mesh`` on fake tensors; the
    counterpart of the reference's ``lower_cell``. ``cfg``/``shape``
    override the arch's config and ``SHAPES[shape_name]`` (the tests pass
    smoke configs). Returns the trace: the op counts, the collectives, the
    memory and the seconds it took."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from .. import models
    from ..core.graph import resolve_device
    from ..models.params import param_axes
    from ..parallel.sharding import activation_rules, rules_for_mesh
    from ..train import TrainStepConfig
    from . import specs as S
    from .hlo_analysis import count_ops
    from .train import shard_for_mesh

    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    rules = rules if rules is not None else rules_for_mesh(mesh)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with _rank_fake_mode():
        params, axes = _fake_params(cfg, dev)
        if shape.kind == "train":
            opt_cfg = _opt_cfg(cfg)
            ts_cfg = TrainStepConfig(bf16_compute_params=bf16_params,
                                     microbatches=microbatches)
            params, opt_state, step = shard_for_mesh(cfg, params, axes,
                                                     opt_cfg, ts_cfg, mesh)
            batch = S.batch_put(
                {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in S.batch_specs(cfg, shape).items()},
                cfg, rules, mesh)
            inputs = (params, opt_state, batch)

            def run():
                p, o, metrics = step(params, opt_state, batch)
                return (p, o, metrics)
        else:
            named = dict(params.named_parameters())
            S.device_put(params, S.tree_shardings(
                named, param_axes(params, axes), rules, mesh), mesh)
            if shape.kind == "prefill":
                batch = S.batch_put(
                    {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                     for k, v in S.batch_specs(cfg, shape).items()},
                    cfg, rules, mesh)
                c_abs, c_axes = models.cache_spec(cfg, shape.global_batch,
                                                  shape.seq_len)
                caches = _placed(c_abs, S.tree_shardings(c_abs, c_axes, rules,
                                                         mesh), mesh, dev)
                inputs = (params, batch, caches)

                def run():
                    with activation_rules(rules), implicit_replication(), \
                            torch.no_grad():
                        logits, _, new = models.forward(cfg, params, batch,
                                                        caches=caches)
                        # serving returns last-position logits only
                        return logits[:, -1], new
            else:
                c_abs, c_axes, tok = S.decode_specs(cfg, shape)
                caches = _placed(c_abs, S.tree_shardings(c_abs, c_axes, rules,
                                                         mesh), mesh, dev)
                tokens = _placed(tok, S.tree_shardings(
                    tok, ("cache_batch",), rules, mesh), mesh, dev)
                inputs = (params, caches, tokens)

                def run():
                    with activation_rules(rules), implicit_replication(), \
                            torch.no_grad():
                        return models.decode_step(cfg, params, caches, tokens)
        setup_s = time.perf_counter() - t0
        tracker = _rank_mem_tracker()
        tracker.track_external(*[t for tree in inputs for t in _leaves(tree)])
        reads = _read_inputs(_storages(inputs))
        t0 = time.perf_counter()
        with tracker, CommDebugMode() as comm, reads, count_ops() as stats, \
                counting.folded_loops():
            outputs = run()
        trace_s = time.perf_counter() - t0
        # jit drops the inputs its program never reads, so the reference's
        # argument size counts only the inputs read
        args_bytes = _local_bytes(inputs, only=reads.read)
        # what the rank holds at rest: params, and a train step's moments
        held = _local_bytes(inputs[0]) + (
            _local_bytes([opt_state["m"], opt_state["v"]])
            if shape.kind == "train" else 0)
        out_bytes = _local_bytes(outputs)
        # outputs that are inputs updated in place (the reference's donated
        # aliases)
        alias = _local_bytes(outputs, only=_storages(inputs))
        peak = sum(snap.get("Total", 0) for snap in
                   tracker.get_tracker_snapshot("peak").values())
    stats.while_trip_counts = _trip_counts(cfg, shape, microbatches)
    return dict(cfg=cfg, shape=shape, stats=stats, setup_seconds=setup_s,
                trace_seconds=trace_s, argument_bytes=args_bytes,
                held_bytes=held,
                output_bytes=out_bytes, alias_bytes=alias,
                peak_bytes=max(peak, args_bytes),
                comm_debug_counts={k.__name__: v for k, v in
                                   comm.get_comm_counts().items()})


# ---------------------------------------------------------------- coloring
def trace_coloring(num_devices: int, ccfg=None) -> dict:
    """The paper's own workload on ``num_devices`` ranks, from shapes (the
    counterpart of the reference's ``lower_coloring``; see the module
    docstring); ``ccfg`` overrides ``configs.rmat_coloring.get_config()``.
    Refuses the ELL engines, as the reference does."""
    from ..analysis.wirecost import closed_form_table
    from ..configs.rmat_coloring import get_config as get_col
    from ..core.distance2 import MODELS
    from ..core.engine import get_backend
    from ..core.frontier import frontier_capacities
    ccfg = ccfg if ccfg is not None else get_col()
    D = int(num_devices)
    t0 = time.perf_counter()
    if get_backend(ccfg.engine).needs_ell:
        raise ValueError(
            f"dry-run lowers the coloring cell from shapes alone; the "
            f"{ccfg.engine!r} engine needs a real host graph for its ELL "
            "width — use engine='sort' or 'bitmap' here (ELL engines run "
            "via color_distributed)")
    if ccfg.model not in MODELS:
        raise ValueError(f"unknown coloring model {ccfg.model!r}")
    v = 1 << ccfg.dryrun_scale
    e2 = 2 * ccfg.edge_factor * v
    if ccfg.model != "d1":
        # d2/pd2 color the squared constraint graph: |E(G2)| is bounded by
        # the wedge count ~ avg_degree x |directed edges|
        e2 *= 2 * ccfg.edge_factor
    vl = -(-v // D)
    el = int(e2 / D * 1.35)  # slab padding headroom for R-MAT skew
    fcv = fce = 0
    if ccfg.frontier != "off":
        fcv, fce = frontier_capacities(vl, el, capacity=ccfg.frontier_capacity)
    # shapes only: every local vertex is boundary (Bl = Vl), the packed
    # entries take color_bound (no provable Delta+1 without a graph)
    wire = "full" if ccfg.wire == "full" else "boundary"
    bl = vl if wire == "boundary" else 0
    table = closed_form_table(num_devices=D, verts_local=vl,
                              boundary_local=bl, wire_colors=ccfg.color_bound,
                              frontier_cap_v=fcv, wire=wire,
                              scheme=ccfg.partition)
    tiers = table["tiers"]
    per_round = {k: t["bytes_per_round"] for k, t in tiers.items()
                 if "bytes_per_round" in t}
    rounds = ccfg.max_rounds
    program = coloring_collectives(table, rounds)
    # each round takes one wire: its round wire, or the slab when every
    # rank's pending set fits; the envelope takes the wider every round
    wires = {e["site"]: e for e in program if e["phase"] == "round"
             and e["kind"] == "all-gather"}
    widest = max(wires, key=lambda s: wires[s]["bytes"])
    coll = {k: 0.0 for k in ("all-gather", "all-reduce", "reduce-scatter",
                             "all-to-all", "collective-permute")}
    counts = {k: 0 for k in coll}
    for e in program:
        n = rounds if e["phase"] == "round" else 1
        if e["phase"] == "round" and e["kind"] == "all-gather" \
                and e["site"] != widest:
            continue
        coll[e["kind"]] += float(n * e["bytes"])
        counts[e["kind"]] += n * e["calls"]
    args, carried, temps = coloring_memory(
        D, vl, el, bl, fcv, fce, per_round, engine=get_backend(
            ccfg.engine).name, max_colors=ccfg.color_bound)
    return dict(table=table, program=program, collective_bytes_by_kind=coll,
                collective_counts=counts, argument_bytes=args,
                peak_bytes=args + carried + temps, rounds=rounds,
                shapes=dict(verts_local=vl, edges_local=el, boundary_local=bl,
                            frontier_cap_v=fcv, frontier_cap_e=fce,
                            widest_round_tier=widest),
                trace_seconds=time.perf_counter() - t0)


def coloring_memory(D: int, vl: int, el: int, bl: int, fcv: int, fce: int,
                    per_round: dict, engine: str = "sort",
                    max_colors: int = 0) -> tuple:
    """``(arguments, carried, temporaries)``: a rank's bytes in the port's
    distributed coloring (``core.distributed._bsp_local``) from the slab
    shapes: its rows of the layout, the state carried across rounds, and
    the larger of a round's two phases: the local solve (the per-edge
    sweep operands and the engine's first-fit working set, where the peak
    falls) and the wire (the gathered words, the snapshot buffers)."""
    vp = vl * D
    args = 4 * el * 2 + 4 * bl
    carried = (4 * vl + vl + 4 * vp            # colors, pending, snapshot
               + 8 * D * bl + 4 * bl           # boundary gids, safe ids
               + el * (1 + 1 + 4 * 4)          # real, dst_local, 4 int32 maps
               + (8 + 4) * (vl + 1) * bool(fcv)  # frontier row pointers
               + (4 * 4 * fce + 4 * fcv) * bool(fcv))  # the frontier slab
    if engine == "sort":
        # segment_mex over the edges and one synthetic entry a vertex: four
        # int64 orders, seven int32 keys, one bool a row; the result
        m = el + vl
        mex = 61 * m + 4 * (vl + 1)
    else:
        # table_mex: a uint8 table a vertex and color, its bool and uint8
        # reads, the int32 keys, the int64 argmax
        mex = 3 * (vl + 1) * (max_colors + 1) + 4 * el + 8 * vl
    solve = (4 * (vp + 1) + (vl + 1) + 4 * (vl + 1) + 4 * vl  # snap, offsets
             + el * (3 * 4 + 2)                # precede, keys, statics, masks
             + mex)
    halo_words = per_round.get("halo", per_round.get("spill", 0)) // 4
    wire = (4 * (vp + 1) * 3 + (vp + 1)        # snap_pad, buf, masked, pend
            + 4 * max(halo_words, per_round.get("slab", 0) // 4)
            + 4 * el * 2 + el)                 # per-edge colour reads, mask
    return args, carried, max(solve, wire)


def coloring_collectives(table: dict, max_rounds: int) -> list:
    """Every collective call site of the port's distributed coloring
    (``core.distributed``) for the shapes of ``table`` (a
    ``closed_form_table``): ``{"phase": "setup" | "round" | "end", "site",
    "kind", "calls", "bytes"}``, bytes per call site and trip by the
    reference's convention (an all-gather's gathered result). A round runs
    the termination vote, the frontier vote when the frontier is on, and
    ONE of its wire sites (the round wire, or the slab when every rank's
    pending set fits)."""
    tiers, D = table["tiers"], table["num_devices"]
    out = []

    def site(phase, name, kind, nbytes, calls=1):
        out.append(dict(phase=phase, site=name, kind=kind, calls=calls,
                        bytes=int(nbytes)))
    if "setup" in tiers:
        site("setup", "boundary ids", "all-gather",
             tiers["setup"]["bytes_once"])
    fcv = table["frontier_cap_v"]
    if fcv:
        site("round", "frontier vote", "all-reduce", 2 * 4)
    for tier in ("halo", "spill"):
        if tier in tiers:
            site("round", tier, "all-gather", tiers[tier]["bytes_per_round"])
    if "slab" in tiers:
        slab = tiers["slab"]["bytes_per_round"]
        # (gid, color) packed in one int32 word, else one gather of each
        site("round", "slab", "all-gather", slab,
             calls=1 if slab == D * fcv * 4 else 2)
    site("round", "termination vote", "all-reduce", 4)
    # the colors gathered on every rank; the rounds and the deepest sweep
    # of each round maxed across ranks
    site("end", "colors", "all-gather", 4 * table["verts_global"])
    site("end", "rounds and sweeps", "all-reduce", 4 * (max_rounds + 1))
    return out


# ---------------------------------------------------------------- analysis
def _roofline(flops: float, nbytes: float, coll: float) -> dict:
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
             "collective_s": coll / LINK_BW}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant, "bound_s": max(terms.values())}


def fit_verdict(peak_bytes: float) -> str:
    """"fits" (the calibrated peak fits the card), "within the calibration
    gap" (only the traced peak fits) or "does not fit"."""
    if peak_bytes * PEAK_CALIBRATION <= HBM_BYTES:
        return "fits"
    return ("within the calibration gap" if peak_bytes <= HBM_BYTES
            else "does not fit")


def _fit(rec: dict, peak_bytes: float) -> None:
    rec["memory_analysis"]["calibrated_peak_in_bytes"] = int(
        peak_bytes * PEAK_CALIBRATION)
    rec["peak_calibration"] = PEAK_CALIBRATION
    rec["fit"] = fit_verdict(peak_bytes)
    rec["fits"] = rec["fit"] == "fits"


def analyse(trace: dict, mesh, arch: str, shape_name: str) -> dict:
    """The reference's record (see the module docstring) from a
    :func:`trace_cell` or :func:`trace_coloring` trace."""
    from ..parallel.sharding import mesh_axes
    axes = mesh_axes(mesh)
    n_dev = math.prod(axes.values())
    rec = {"arch": arch, "shape": shape_name, "mesh": list(axes.values()),
           "axes": list(axes), "devices": n_dev,
           "trace_seconds": trace["trace_seconds"],
           "lower_seconds": trace["trace_seconds"]}
    if arch == "rmat-coloring":
        coll = trace["collective_bytes_by_kind"]
        rec["per_device"] = {
            "flops": 0.0, "bytes_accessed": float(trace["peak_bytes"]),
            "collective_bytes": sum(coll.values()),
            "collective_by_kind": coll,
            "collective_counts": trace["collective_counts"],
            "while_trip_counts": [trace["rounds"]]}
        rec["coloring"] = {"wire_cost": trace["table"], **trace["shapes"]}
        mem = {"argument_size_in_bytes": trace["argument_bytes"],
               "peak_memory_in_bytes": trace["peak_bytes"],
               "temp_size_in_bytes": trace["peak_bytes"]
               - trace["argument_bytes"]}
        rec["memory_analysis"] = mem
        rec["roofline"] = _roofline(0.0, float(trace["peak_bytes"]),
                                    sum(coll.values()))
        _fit(rec, trace["peak_bytes"])
        return rec
    st = trace["stats"]
    flops_dev, bytes_dev = st.dot_flops, st.boundary_bytes
    rec["setup_seconds"] = trace["setup_seconds"]
    rec["per_device"] = {
        "flops": flops_dev,
        "bytes_accessed": bytes_dev,
        "collective_bytes": st.collective_bytes,
        "collective_by_kind": st.collective_bytes_by_kind,
        "collective_counts": st.collective_counts,
        "collective_sent_by_kind": st.collective_sent_bytes_by_kind,
        "while_trip_counts": st.while_trip_counts,
        "comm_debug_counts": trace["comm_debug_counts"],
    }
    rec["memory_analysis"] = {
        "argument_size_in_bytes": trace["argument_bytes"],
        "held_bytes": trace["held_bytes"],
        "output_size_in_bytes": trace["output_bytes"],
        "alias_size_in_bytes": trace["alias_bytes"],
        "temp_size_in_bytes": trace["peak_bytes"] - trace["argument_bytes"],
        "peak_memory_in_bytes": trace["peak_bytes"],
    }
    rec["roofline"] = _roofline(flops_dev, bytes_dev, st.collective_bytes)
    _fit(rec, trace["peak_bytes"])
    cfg, shape = trace["cfg"], trace["shape"]
    mf = counting.model_flops(cfg, shape)
    rec["model_flops_total"] = mf
    rec["model_flops_per_device"] = mf / n_dev
    rec["useful_flops_ratio"] = (mf / n_dev) / flops_dev if flops_dev else 0.0
    # roofline fraction: ideal model-FLOPs time / achieved bound
    bound = rec["roofline"]["bound_s"]
    rec["roofline_fraction"] = (mf / n_dev / PEAK_FLOPS) / bound if bound \
        else 0.0
    return rec


def run_cell(arch, shape_name, multi_pod, out_dir, rules=None,
             tag="baseline", bf16_params=False, microbatches=1,
             device=None):
    """One cell in a fake world of the production mesh's size; writes its
    JSON record under ``out_dir`` and prints the reference's two lines."""
    from .mesh import make_production_mesh, production_shape
    from ..parallel.sharding import DEFAULT_RULES, rules_for_mesh
    shape, _ = production_shape(multi_pod=multi_pod)
    with fake_world(math.prod(shape)):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        rules = rules_for_mesh(mesh, rules or DEFAULT_RULES)
        if arch == "rmat-coloring":
            trace = trace_coloring(math.prod(shape))
        else:
            trace = trace_cell(arch, shape_name, mesh, rules,
                               bf16_params=bf16_params,
                               microbatches=microbatches, device=device)
        t0 = time.perf_counter()
        rec = analyse(trace, mesh, arch, shape_name)
        rec["compile_seconds"] = time.perf_counter() - t0
    rec["tag"] = tag
    rec["device_type"] = mesh.device_type
    os.makedirs(out_dir, exist_ok=True)
    mp = "multipod" if multi_pod else "pod"
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mp}__{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {arch} x {shape_name} x {mp}: "
          f"trace={rec['trace_seconds']:.1f}s "
          f"flops/dev={rec['per_device']['flops']:.3e} "
          f"coll/dev={rec['per_device']['collective_bytes']:.3e}B "
          f"dominant={rec['roofline']['dominant']} "
          f"frac={rec.get('roofline_fraction', 0):.3f}", flush=True)
    ma = rec["memory_analysis"]
    print(f"         memory/device: args="
          f"{ma.get('argument_size_in_bytes', 0)/2**30:.2f}GiB "
          f"temp={ma.get('temp_size_in_bytes', 0)/2**30:.2f}GiB "
          f"out={ma.get('output_size_in_bytes', 0)/2**30:.2f}GiB "
          f"peak={ma.get('peak_memory_in_bytes', 0)/2**30:.2f}GiB of "
          f"{HBM_BYTES/1e9:.0f} GB (calibrated "
          f"{ma['calibrated_peak_in_bytes']/2**30:.2f}GiB: {rec['fit']})",
          flush=True)
    return rec


def _refused_op(exc: BaseException) -> str:
    """The op named in a failure, where fake mode or DTensor names one."""
    text = f"{type(exc).__name__}: {exc}"
    for line in text.splitlines():
        for key in ("aten.", "Operator ", "op "):
            if key in line:
                return line.strip()[:300]
    return text.splitlines()[0][:300] if text else repr(exc)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--bf16-params", action="store_true",
                    help="mixed precision: bf16 compute params")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="gradient-accumulation microbatches for train cells "
                         "(0 = per-arch MICROBATCH_DEFAULTS)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: fake CUDA tensors) or cpu")
    args = ap.parse_args(argv)

    failures = []
    for arch, shape_name in cells(args.arch, args.shape):
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        mb = args.microbatches or MICROBATCH_DEFAULTS.get(arch, 1)
        for mp in meshes:
            try:
                run_cell(arch, shape_name, mp, args.out, tag=args.tag,
                         bf16_params=args.bf16_params, microbatches=mb,
                         device=args.device)
            except Exception as e:  # a cell's failure is reported, not fatal
                traceback.print_exc()
                failures.append((arch, shape_name, mp, _refused_op(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("dry-run complete: all cells traced.")


if __name__ == "__main__":
    main()
