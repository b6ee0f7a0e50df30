"""repro_torch's multi-pod dry run (``launch.dryrun``) and its op counter
(``launch.hlo_analysis.count_ops``), held to the reference's
``repro.launch.dryrun`` on the CPU.

The reference's ``dryrun`` writes ``XLA_FLAGS`` at import, so it runs in
one subprocess for the whole module, with 4 host devices and a 2 x 2
``("data", "model")`` mesh of ``Auto`` axes (under jax 0.9 the reference's
own ``make_production_mesh`` makes ``Explicit`` axes, on which its
``with_sharding_constraint`` calls fail: ROADMAP C12). There it lowers and
compiles every arch x {train, prefill, decode} at the arch's smoke config
(seq 64, batch 4, one microbatch) with ``lower_cell`` + ``analyse``, and
qwen3-4b's train cell again with 4 microbatches of one row (ROADMAP C13).
The port traces the same cells as rank 0 of a ``fake`` process group of 4
ranks under ``FakeTensorMode`` (``trace_cell`` + ``analyse``), in this
process while the reference runs; the group is destroyed after.

Per cell: ``argument_size_in_bytes`` and ``model_flops_total`` exactly
equal; per-device ``dot_flops`` within ``FLOPS_TOL`` of the reference's,
or of its named gap (``FLOPS_GAPS``: the ops the two programs lay out
differently, named op by op in PERF.md section 6). Beside them: the
reference's four ``tests/test_hlo_analysis.py`` programs written in torch
and counted by ``count_ops``; a known redistribute counted as one
all-gather of the stated bytes; the coloring cell against
``closed_form_table``; the MoE count that replaced ``bincount``; the cache
writes a sharded prefill and decode make and the decode attention by
cache blocks, on four real gloo ranks, against the same on one device;
and that the two modules import neither ``jax`` nor ``repro``.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import count_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 4
# per-device dot FLOPs, the port's local matmuls against the reference's
# HLO dots: within FLOPS_TOL (relative) of the reference's, or of the
# reference's times (1 + the gap) where the two programs lay an op out
# differently (PERF.md section 6 names each gap's ops, as ``port_by_op``
# and ``reference_by_op`` below print them): decode's token projections, which
# DTensor splits less than XLA does; the SSD scan, which runs on each
# rank's rows with every head; the reference's attention dots in a train
# step, 1.5-2x the port's
FLOPS_TOL = 0.02
FLOPS_GAPS = {
    ("mistral-nemo-12b", "train"): -0.0465,
    ("mistral-nemo-12b", "decode"): 0.1364,
    ("qwen3-4b", "train"): -0.0465, ("qwen3-4b", "decode"): 0.1364,
    ("starcoder2-3b", "train"): -0.1081,
    ("starcoder2-3b", "decode"): 0.1667,
    ("gemma2-2b", "train"): -0.0426, ("gemma2-2b", "decode"): 0.1364,
    ("mamba2-130m", "train"): 0.2758, ("mamba2-130m", "prefill"): 0.1236,
    ("mamba2-130m", "decode"): 0.4565,
    ("whisper-medium", "train"): -0.0784,
    ("whisper-medium", "decode"): 0.3214,
    ("recurrentgemma-2b", "train"): -0.0351,
    ("recurrentgemma-2b", "decode"): 0.1313,
    ("llama-3.2-vision-11b", "train"): -0.0409,
    ("llama-3.2-vision-11b", "decode"): 0.1648,
    ("grok-1-314b", "decode"): 0.0517,
    ("deepseek-v2-lite-16b", "decode"): 0.2966,
}

# the train cells with one row per microbatch (BATCH microbatches) over
# the 2 data ranks, each block replicated on them (ROADMAP C13): from 1 to
# BATCH microbatches the port's projection gradients (autograd's
# MmBackward0) grow where the reference's backward dots do not, on top of
# the one-microbatch cell's gap (PERF.md section 6 names the ops, by
# ``main`` below with ``--microbatches 4``)
MICRO_ONE_ROW_GAPS = {"qwen3-4b": 0.0213, "deepseek-v2-lite-16b": 0.1456}

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    from repro.launch import dryrun as RD
    from repro.configs import ARCH_IDS, get_smoke_config
    from repro.models.config import ShapeConfig
    from repro.parallel.sharding import DEFAULT_RULES, rules_for_mesh
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = rules_for_mesh(mesh, DEFAULT_RULES)
    RD.get_config = get_smoke_config
    out = {"cells": [list(c) for c in RD.cells()],
           "long_ok": sorted(RD.LONG_OK),
           "microbatches": RD.MICROBATCH_DEFAULTS, "records": {}}
    for kind in ("train", "prefill", "decode"):
        RD.SHAPES["smoke_" + kind] = ShapeConfig("smoke_" + kind, %d, %d,
                                                 kind)
    for arch in ARCH_IDS:
        for kind in ("train", "prefill", "decode"):
            lowered, cfg, shape = RD.lower_cell(arch, "smoke_" + kind, mesh,
                                                rules)
            rec = RD.analyse(lowered, cfg, shape, mesh, arch, kind, None)
            out["records"][arch + "/" + kind] = rec
    # a microbatch of one row over the 2 data ranks (ROADMAP C13)
    for arch in %r:
        lowered, cfg, shape = RD.lower_cell(arch, "smoke_train", mesh, rules,
                                            microbatches=%d)
        out["records"][arch + "/train/mb"] = RD.analyse(
            lowered, cfg, shape, mesh, arch, "train", None)
    # the coloring cell at the smoke config, frontier on and off. With the
    # frontier on, jax 0.9 refuses the reference's frontier cond under
    # shard_map's varying-axes check (ROADMAP C1), so that program lowers
    # with the check off: the same program, untyped
    import dataclasses, functools
    import repro.configs.rmat_coloring as RC
    import repro.core.distributed as RDist
    checked = RDist.shard_map
    out["coloring"] = {}
    for frontier in ("auto", "off"):
        RC.get_config = functools.partial(dataclasses.replace,
                                          RC.get_smoke_config(),
                                          frontier=frontier)
        RDist.shard_map = checked if frontier == "off" else \
            functools.partial(checked, check_vma=False)
        lowered, ccfg, _ = RD.lower_coloring(mesh)
        out["coloring"][frontier] = RD.analyse(
            lowered, ccfg, None, mesh, "rmat-coloring", "coloring", None)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""" % (SEQ, BATCH, tuple(MICRO_ONE_ROW_GAPS), BATCH))


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """``(reference output, port records)``: the reference's subprocess
    runs while this process traces the port's cells."""
    path = str(tmp_path_factory.mktemp("dryrun") / "reference.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, path],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    port = {}
    try:
        with D.fake_world(4):
            mesh = make_mesh((2, 2), ("data", "model"), "cpu")
            for arch in ARCH_IDS:
                for kind in KINDS:
                    trace = D.trace_cell(arch, kind, mesh, device="cpu",
                                         cfg=get_smoke_config(arch),
                                         shape=ShapeConfig(kind, SEQ, BATCH,
                                                           kind))
                    port[f"{arch}/{kind}"] = D.analyse(trace, mesh, arch,
                                                       kind)
            for arch in MICRO_ONE_ROW_GAPS:
                trace = D.trace_cell(arch, "train", mesh, device="cpu",
                                     cfg=get_smoke_config(arch),
                                     shape=ShapeConfig("train", SEQ, BATCH,
                                                       "train"),
                                     microbatches=BATCH)
                port[f"{arch}/train/mb"] = D.analyse(trace, mesh, arch,
                                                     "train")
    finally:
        out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-3000:]
    with open(path) as f:
        return json.load(f), port


def test_cells_and_tables_are_the_references(dry):
    ref, _ = dry
    assert [list(c) for c in D.cells()] == ref["cells"]
    assert sorted(D.LONG_OK) == ref["long_ok"]
    assert D.MICROBATCH_DEFAULTS == ref["microbatches"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_matches_the_reference(dry, arch, kind):
    ref, port = dry
    r, p = ref["records"][f"{arch}/{kind}"], port[f"{arch}/{kind}"]
    assert p["memory_analysis"]["argument_size_in_bytes"] == \
        r["memory_analysis"]["argument_size_in_bytes"]
    assert p["model_flops_total"] == r["model_flops_total"]
    assert p["model_flops_per_device"] == r["model_flops_per_device"]
    got, want = p["per_device"]["flops"], r["per_device"]["flops"]
    gap = FLOPS_GAPS.get((arch, kind), 0.0)
    assert abs(got / want - 1 - gap) <= FLOPS_TOL, (got, want, gap)
    assert p["roofline"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    assert 0 < p["memory_analysis"]["argument_size_in_bytes"] \
        <= p["memory_analysis"]["peak_memory_in_bytes"]


@pytest.mark.parametrize("arch", list(MICRO_ONE_ROW_GAPS))
def test_a_microbatch_smaller_than_the_data_ranks_traces(dry, arch):
    """ROADMAP C13: the port traces the cell the reference lowers, with
    the reference's argument bytes and model FLOPs, and its per-device
    FLOPs at the named gap."""
    ref, port = dry
    r, p = ref["records"][f"{arch}/train/mb"], port[f"{arch}/train/mb"]
    assert p["memory_analysis"]["argument_size_in_bytes"] == \
        r["memory_analysis"]["argument_size_in_bytes"]
    assert p["model_flops_per_device"] == r["model_flops_per_device"]
    got, want = p["per_device"]["flops"], r["per_device"]["flops"]
    assert abs(got / want - 1 - MICRO_ONE_ROW_GAPS[arch]) <= 1e-3, (got, want)


# ---------------------------------------------------------------- by op
# one cell's FLOPs op by op in both packages: the source of the names in
# FLOPS_GAPS and PERF.md section 6; by hand, from the repository root:
#     PYTHONPATH=src python tests/test_torch_dryrun.py --arch A --kind K
_BY_OP_REFERENCE = textwrap.dedent("""
    import collections, json, re, sys
    import jax
    from jax.sharding import AxisType
    from repro.launch import dryrun as RD, hlo_analysis as H
    from repro.configs import get_smoke_config
    from repro.models.config import ShapeConfig
    from repro.parallel.sharding import DEFAULT_RULES, rules_for_mesh
    arch, kind, seq, batch, mb = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
        int(sys.argv[4]), int(sys.argv[5])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    RD.get_config = get_smoke_config
    RD.SHAPES["cell"] = ShapeConfig("cell", seq, batch, kind)
    lowered, _, _ = RD.lower_cell(arch, "cell", mesh,
                                  rules_for_mesh(mesh, DEFAULT_RULES),
                                  microbatches=mb)
    comps = H._split_computations(lowered.compile().as_text())
    edges, _, _, _ = H._analyze_structure(comps)
    mult, _ = H._multipliers(comps, edges)
    by = collections.Counter()
    for cname, lines in comps.items():
        defs = H._defs_of(lines)
        for ln in lines:
            if " dot(" not in ln:
                continue
            m = re.search(r'op_name="([^"]*)"', ln)
            name = m.group(1) if m else "?"
            phase = ("recompute" if "rematted_computation" in name else
                     "backward" if "transpose(" in name else "forward")
            op = name.rstrip("/").split("/")[-2] if "/" in name else name
            op = re.sub(r"^jvp\\((.*)\\)$", r"\\1", op)
            by[phase + " | " + op] += H._dot_flops_of_line(ln, defs) \\
                * mult.get(cname, 1)
    print(json.dumps(by))
""")


def reference_by_op(arch, kind, seq, batch, microbatches=1) -> dict:
    """The reference's per-device HLO dot FLOPs of one cell by ``op_name``
    (the jax source op and its phase: forward, ``transpose`` = backward,
    ``rematted_computation`` = recompute)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _BY_OP_REFERENCE, arch, kind,
                          str(seq), str(batch), str(microbatches)], env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _model_frame(path: str) -> bool:
    """Whether a source file is model code (not the dry run's or the train
    step's own)."""
    return "repro_torch" in path and "/launch/" not in path \
        and not path.endswith("train_step.py")


def _forward_site(node) -> str:
    """The model line whose forward op made autograd node ``node``, from
    the traceback anomaly mode keeps in its metadata; "" if none."""
    import re
    frames = re.findall(r'File "([^"]+)", line (\d+), in (\S+)\n\s*(.*)',
                        "".join(node.metadata.get("traceback_", [])))
    for path, line, fn, text in reversed(frames):
        if _model_frame(path):
            return f"{os.path.basename(path)}:{line} {fn}: {text[:60]}"
    return ""


@contextlib.contextmanager
def _flops_by_site(forward_sites: bool = False):
    """A Counter filled, while the context is open, with the port's
    per-device matmul FLOPs by the model source line that issued them (in
    the backward pass, the autograd node, or the model line a recompute
    runs) and their phase. ``forward_sites`` names an autograd node with
    the forward line that made it too (anomaly mode records each node's
    traceback; its NaN check is off, fake tensors have no values)."""
    import collections
    import linecache
    from repro_torch.launch import hlo_analysis as H
    by = collections.Counter()
    count = H._count

    def attributed(stats, registry, func, args, kwargs, out):
        before = stats.dot_flops
        count(stats, registry, func, args, kwargs, out)
        if stats.dot_flops == before:
            return
        node = torch._C._current_autograd_node()
        f, site = sys._getframe(1), (node.name() if node is not None
                                     else "?")
        if node is not None and forward_sites:
            site = f"{site} of {_forward_site(node) or '?'}"
        while f is not None:
            path = f.f_code.co_filename
            if _model_frame(path):
                text = linecache.getline(path, f.f_lineno).strip()
                site = (f"{os.path.basename(path)}:{f.f_lineno} "
                        f"{f.f_code.co_name}: {text[:60]}")
                break
            f = f.f_back
        phase = "backward" if node is not None else "forward"
        by[f"{phase} | {site}"] += stats.dot_flops - before

    H._count = attributed
    anomaly = torch.autograd.set_detect_anomaly(forward_sites,
                                                check_nan=False)
    try:
        with anomaly:
            yield by
    finally:
        H._count = count


def port_by_op(arch, kind, seq, batch, microbatches=1) -> dict:
    """The port's per-device matmul FLOPs of the smoke cell by site
    (``_flops_by_site``) on the 2 x 2 mesh of ``reference_by_op``."""
    with _flops_by_site() as by, D.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        D.trace_cell(arch, kind, mesh, device="cpu",
                     cfg=get_smoke_config(arch),
                     shape=ShapeConfig(kind, seq, batch, kind),
                     microbatches=microbatches)
    return by


def production_by_op(arch, shape_name, multi_pod, microbatches, out_dir,
                     device=None) -> dict:
    """The port's per-device matmul FLOPs by site of one full-config cell
    on a production mesh (a gradient's by its node and forward line), traced as ``launch.dryrun`` traces it (its
    record written under ``out_dir``, its two lines printed). No reference
    beside it: the reference lowers no full config on this host."""
    with _flops_by_site(forward_sites=True) as by:
        D.run_cell(arch, shape_name, multi_pod, out_dir,
                   microbatches=microbatches, device=device)
    return by


def test_a_flops_gap_is_its_named_ops():
    """qwen3-4b's decode gap (FLOPS_GAPS) lies wholly in the head
    projections, op by op: the port's ``proj_heads`` matmuls against the
    reference's ``btd,dhe->bthe`` dots; every other op's FLOPs agree."""
    cell = ("qwen3-4b", "decode", SEQ, BATCH)
    ref, got = reference_by_op(*cell), port_by_op(*cell)
    named_ref = sum(v for k, v in ref.items() if k.endswith("btd,dhe->bthe"))
    named_got = sum(v for k, v in got.items() if " proj_heads: " in k)
    assert named_ref > 0 and named_got > named_ref
    gap = sum(got.values()) - sum(ref.values())
    assert gap == named_got - named_ref
    assert abs(sum(got.values()) / sum(ref.values()) - 1
               - FLOPS_GAPS[cell[:2]]) <= 1e-4


# ---------------------------------------------------------------- count_ops
def test_scanned_matmuls_count_every_trip():
    """``test_hlo_analysis.py``'s scan of 16 matmuls: eager code runs every
    trip, so each is counted."""
    w = torch.zeros(16, 64, 64)
    x = torch.ones(4, 64)
    with count_ops() as st:
        for i in range(16):
            x = x @ w[i]
        x.sum()
    assert st.dot_flops == 16 * 2 * 4 * 64 * 64


def test_nested_loops_multiply():
    w = torch.zeros(4, 3, 32, 32)
    x = torch.ones(2, 32)
    with count_ops() as st:
        for i in range(4):
            for j in range(3):
                x = x @ w[i, j]
        x.sum()
    assert st.dot_flops == 4 * 3 * 2 * 2 * 32 * 32


def test_one_matmul_counted_once():
    a, b = torch.ones(8, 128), torch.ones(128, 16)
    with count_ops() as st:
        a @ b
    assert st.dot_flops == 2 * 8 * 128 * 16
    assert st.boundary_bytes >= (8 * 128 + 128 * 16 + 8 * 16) * 4


@pytest.mark.parametrize("dtype,size", [
    (torch.float32, 4), (torch.bfloat16, 2), (torch.float16, 2),
    (torch.int8, 1), (torch.uint8, 1), (torch.int16, 2), (torch.int32, 4),
    (torch.int64, 8), (torch.float64, 8), (torch.bool, 1),
    (torch.complex64, 8)])
def test_bytes_per_dtype(dtype, size):
    """``_shape_bytes``'s table: a copy of 4 x 8 elements moves them in
    and out."""
    x = torch.zeros(4, 8, dtype=dtype)
    with count_ops() as st:
        x.clone()
    assert st.boundary_bytes == 2 * 32 * size


def test_slice_like_ops_cost_twice_what_they_touch():
    x = torch.zeros(64, 128)
    idx = torch.arange(8)
    with count_ops() as st:
        x.index_select(0, idx)
    assert st.boundary_bytes == 2 * 8 * 128 * 4
    upd = torch.ones(8, 128)
    with count_ops() as st:
        x.index_put_((idx,), upd)
    assert st.boundary_bytes == 2 * 8 * 128 * 4


def test_a_redistribute_is_one_all_gather_of_the_whole():
    """A ``Shard(0)`` -> ``Replicate`` redistribute over 4 fake ranks is one
    all-gather whose result is the whole tensor (the reference's
    convention) and whose input is this rank's quarter."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with D.fake_world(4):
        mesh = make_mesh((4,), ("data",), "cpu")
        x = distribute_tensor(torch.zeros(64, 32), mesh, [Shard(0)],
                              src_data_rank=None)
        with count_ops() as st:
            x.redistribute(mesh, [Replicate()]).to_local()
    assert st.collective_counts["all-gather"] == 1
    assert sum(st.collective_counts.values()) == 1
    assert st.collective_bytes_by_kind["all-gather"] == 64 * 32 * 4
    assert st.collective_sent_bytes_by_kind["all-gather"] == 16 * 32 * 4
    assert st.collective_bytes == 64 * 32 * 4
    assert st.dot_flops == 0


def test_a_folded_loop_counts_every_trip():
    """Flash attention's kv-chunk loop, folded (one trip run, its ops
    counted per trip, as the reference counts a while body), counts what
    the whole loop counts; outside autograd only."""
    from repro_torch.models import counting
    from repro_torch.models.layers import flash_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 256, 4, 8, generator=g)
    k, v = (torch.randn(2, 256, 2, 8, generator=g) for _ in range(2))
    pos = torch.arange(256)

    def attend():
        return flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                               q_chunk=64, kv_chunk=32)
    with torch.no_grad():
        with count_ops() as whole:
            want = attend()
        with count_ops() as folded, counting.folded_loops():
            got = attend()
    assert folded.dot_flops == whole.dot_flops == 2 * (2 * 2 * 4 * 256 * 256 * 8)
    assert folded.boundary_bytes == whole.boundary_bytes
    assert got.shape == want.shape
    with count_ops() as graded, counting.folded_loops():
        attend()
    assert graded.dot_flops == whole.dot_flops


def test_a_folded_loop_refuses_trips_of_other_shapes():
    """A folded loop counts its second trip for the other n - 1, so every
    trip must run on the same shapes: ``trips`` checks them all."""
    from repro_torch.models import counting
    same = [torch.zeros(4, 8) for _ in range(3)]
    with torch.no_grad(), counting.folded_loops():
        assert len(list(counting.trips(same, 3))) == 2
        with pytest.raises(ValueError, match="same shapes"):
            list(counting.trips(same[:2] + [torch.zeros(4, 7)], 3))
        with pytest.raises(ValueError, match="same shapes"):
            list(counting.trips(same[:2] + [torch.zeros(4, 8).half()], 3))


def test_folded_microbatches_count_every_microbatch():
    """A train step's microbatch loop, folded (each trip runs its own
    backward), counts what the whole loop counts."""
    import dataclasses
    from repro_torch.launch import train as lt
    from repro_torch.models import counting
    from repro_torch.train import AdamWConfig, TrainStepConfig, data
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), dtype="float32")
    dcfg = data.data_config_for(cfg, ShapeConfig("t", 16, 4, "train"))
    counted = []
    for fold in (False, True):
        params, state, step, _ = lt.build(cfg, AdamWConfig(),
                                          TrainStepConfig(microbatches=2),
                                          device="cpu")
        with count_ops() as st:
            if fold:
                with counting.folded_loops():
                    step(params, state, lt.batch_on(dcfg, 0, "cpu"))
            else:
                step(params, state, lt.batch_on(dcfg, 0, "cpu"))
        counted.append(st)
    whole, folded = counted
    assert folded.dot_flops == whole.dot_flops > 0
    assert folded.boundary_bytes == whole.boundary_bytes


# ---------------------------------------------------------------- coloring
def test_coloring_cell_is_the_closed_form():
    """The ``rmat-coloring`` cell at ``get_smoke_config()`` on 4 ranks: the
    wire is ``closed_form_table``'s, setup once and the widest round tier
    every round of the ``max_rounds`` envelope; the arguments are each
    rank's slab rows."""
    from repro_torch.analysis.wirecost import closed_form_table
    from repro_torch.configs.rmat_coloring import get_smoke_config as col
    from repro_torch.core.frontier import frontier_capacities
    ccfg = col()
    trace = D.trace_coloring(4, ccfg)
    v = 1 << ccfg.dryrun_scale
    vl = v // 4
    el = int(2 * ccfg.edge_factor * v / 4 * 1.35)
    cap_v, _ = frontier_capacities(vl, el)
    table = closed_form_table(num_devices=4, verts_local=vl,
                              boundary_local=vl,
                              wire_colors=ccfg.color_bound,
                              frontier_cap_v=cap_v, wire="boundary")
    assert trace["table"] == table
    tiers = table["tiers"]
    widest = max(tiers["halo"]["bytes_per_round"],
                 tiers["slab"]["bytes_per_round"])
    # setup once, the wider round wire every round, the colors at the end
    assert trace["collective_bytes_by_kind"]["all-gather"] == \
        tiers["setup"]["bytes_once"] + ccfg.max_rounds * widest + 4 * v
    assert trace["argument_bytes"] == 4 * (2 * el + vl)
    with D.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rec = D.analyse(trace, mesh, "rmat-coloring", "coloring")
    assert rec["per_device"]["collective_bytes"] == sum(
        trace["collective_bytes_by_kind"].values())
    assert rec["roofline"]["dominant"] in ("memory_s", "collective_s")
    assert rec["fits"] and rec["fit"] == "fits"


@pytest.mark.parametrize("peak,verdict", [
    (10e9, "fits"), (0.999999 * D.HBM_BYTES / D.PEAK_CALIBRATION, "fits"),
    (79.9e9, "within the calibration gap"),
    (D.HBM_BYTES, "within the calibration gap"),
    (81e9, "does not fit")])
def test_fit_verdict_carries_the_calibration(peak, verdict):
    """The traced peak is scaled by the card's measured margin before it
    is held to 80 GB; a cell that fits only unscaled is named so."""
    assert D.fit_verdict(peak) == verdict
    rec = {"memory_analysis": {}}
    D._fit(rec, peak)
    assert rec["fit"] == verdict and rec["fits"] == (verdict == "fits")
    assert rec["memory_analysis"]["calibrated_peak_in_bytes"] == \
        int(peak * D.PEAK_CALIBRATION)


# the one collective the two programs lay out differently: the reference's
# jit returns the colors sharded and maxes the rounds and the conflict,
# sweep and frontier histograms in one all-reduce after the loop; the port
# gathers the colors and maxes the rounds and sweeps ("end" sites)
def _reference_epilogue(max_rounds):
    return {"all-reduce": (1, 4 * (1 + 3 * max_rounds))}


@pytest.mark.parametrize("frontier", ["auto", "off"])
def test_coloring_cell_matches_the_reference(dry, frontier):
    """The coloring cell at the smoke config on 2 x 2 against the
    reference's ``lower_coloring`` + ``analyse``: argument bytes exactly,
    and per device the collectives' counts and bytes by kind exactly. The
    reference's round loop ends on the data, so its HLO walk counts the
    round body once, both wire branches included: the port's call sites,
    each once, are that program's, but for the epilogue."""
    import dataclasses
    from repro_torch.configs.rmat_coloring import get_smoke_config as col
    ccfg = dataclasses.replace(col(), frontier=frontier)
    r = dry[0]["coloring"][frontier]
    trace = D.trace_coloring(4, ccfg)
    assert trace["argument_bytes"] == \
        r["memory_analysis"]["argument_size_in_bytes"]
    want = {k: (r["per_device"]["collective_counts"][k],
                r["per_device"]["collective_by_kind"][k])
            for k in r["per_device"]["collective_counts"]}
    got = {k: [0, 0] for k in want}
    for e in trace["program"]:
        if e["phase"] != "end":
            got[e["kind"]][0] += e["calls"]
            got[e["kind"]][1] += e["bytes"]
    for kind, (calls, nbytes) in _reference_epilogue(ccfg.max_rounds).items():
        got[kind][0] += calls
        got[kind][1] += nbytes
    assert {k: tuple(v) for k, v in got.items()} == want
    assert r["per_device"]["while_trip_counts"] == \
        [1] * (3 if frontier == "auto" else 2)


COLORING_CASES = [("sort", True), ("sort", False), ("bitmap", True),
                  ("bitmap", False)]
# the memory model against the port's measured peak (relative): it holds
# the frontier slab in every round and leaves out a few vertex-sized
# temporaries
COLORING_MEMORY_TOL = 0.10


def rank_coloring_program(pmesh):
    """On four real gloo ranks: the port's distributed coloring of the
    smoke config's R-MAT graph, per (engine, frontier) case, under
    ``count_ops`` and the dry run's memory tracker; beside each, what
    ``coloring_collectives`` and ``coloring_memory`` give for its layout's
    shapes (the setup once, each round its votes and the wire it took, the
    slab when its frontier count is set, the end once)."""
    from repro_torch.analysis.wirecost import closed_form_table
    from repro_torch.configs.rmat_coloring import get_smoke_config as col
    from repro_torch.core import rmat
    from repro_torch.core.distributed import (build_distributed_coloring,
                                              partition_graph)
    from repro_torch.core.frontier import frontier_capacities
    ccfg = col()
    g = rmat.generate(ccfg.dryrun_scale, ccfg.edge_factor, ccfg.params)
    lay = partition_graph(g, pmesh.num_devices)
    vl, el, bl = lay.verts_local, lay.lsrc.shape[1], lay.bnd.shape[1]
    colors = min(g.max_degree() + 1, ccfg.color_bound)
    out = {}
    for engine, frontier in COLORING_CASES:
        fcv, fce = frontier_capacities(vl, el, g.max_degree()) \
            if frontier else (0, 0)
        fn = build_distributed_coloring(
            pmesh, vl, el, max_rounds=ccfg.max_rounds, engine=engine,
            max_colors=colors, frontier_cap_v=fcv, frontier_cap_e=fce,
            wire="boundary", wire_colors=ccfg.color_bound)
        tracker = D._rank_mem_tracker()
        with tracker, count_ops() as st:
            _, rounds, _, _, fronts = fn(lay.lsrc, lay.ldst, lay.bnd)
        peak = sum(snap.get("Total", 0) for snap in
                   tracker.get_tracker_snapshot("peak").values())
        table = closed_form_table(num_devices=pmesh.num_devices,
                                  verts_local=vl, boundary_local=bl,
                                  wire_colors=ccfg.color_bound,
                                  frontier_cap_v=fcv, wire="boundary")
        slab_rounds = int((fronts[:rounds] > 0).sum())
        want = {}
        for e in D.coloring_collectives(table, ccfg.max_rounds):
            n = 1
            if e["phase"] == "round":
                n = {"slab": slab_rounds, "halo": rounds - slab_rounds}.get(
                    e["site"], rounds)
            c, b = want.get(e["kind"], (0, 0))
            want[e["kind"]] = (c + n * e["calls"], b + n * e["bytes"])
        got = {k: (st.collective_counts[k],
                   int(st.collective_bytes_by_kind[k])) for k in want}
        per_round = {k: t["bytes_per_round"] for k, t in
                     table["tiers"].items() if "bytes_per_round" in t}
        model = sum(D.coloring_memory(pmesh.num_devices, vl, el, bl, fcv,
                                      fce, per_round, engine=engine,
                                      max_colors=colors))
        out[f"{engine}/{frontier}"] = dict(
            got=got, want=want, rounds=int(rounds), slab_rounds=slab_rounds,
            peak=peak, model=model)
    return out


@pytest.fixture(scope="module")
def coloring_ranks():
    from repro_torch.launch import run_ranks
    return run_ranks("test_torch_dryrun:rank_coloring_program", 4,
                     device="cpu", timeout=300)


@pytest.mark.parametrize("engine,frontier", COLORING_CASES)
def test_coloring_collectives_are_the_ports_program(coloring_ranks, engine,
                                                    frontier):
    for ranks in coloring_ranks:
        r = ranks[f"{engine}/{frontier}"]
        assert r["got"] == r["want"], r
        # with the frontier on, both wires ran
        assert (0 < r["slab_rounds"] < r["rounds"]) if frontier \
            else r["slab_rounds"] == 0, r


@pytest.mark.parametrize("engine,frontier", COLORING_CASES)
def test_coloring_memory_is_the_ports_program(coloring_ranks, engine,
                                              frontier):
    """``coloring_memory`` (the coloring cell's per-rank peak) against the
    peak the dry run's memory tracker measures on each rank's real run,
    within ``COLORING_MEMORY_TOL``."""
    for ranks in coloring_ranks:
        r = ranks[f"{engine}/{frontier}"]
        assert abs(r["model"] / r["peak"] - 1) <= COLORING_MEMORY_TOL, r


def test_coloring_cell_refuses_ell_engines():
    import dataclasses
    from repro_torch.configs.rmat_coloring import get_smoke_config as col
    with pytest.raises(ValueError, match="ELL width"):
        D.trace_coloring(4, dataclasses.replace(col(), engine="ell_pallas"))


# ---------------------------------------------------------------- repairs
def test_moe_expert_counts_equal_bincount():
    """The fixed-shape count that replaced ``bincount`` in ``moe._dispatch``
    (fake tensors refuse bincount's data-dependent shape)."""
    from repro_torch.models.moe import _dispatch
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, 8, generator=g)
    probs = torch.softmax(torch.randn(3, 16, 6, generator=g), dim=-1)
    *_, counts = _dispatch(x, probs, 2, 6, 4)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :2]
    assert torch.equal(counts, torch.bincount(top.reshape(-1),
                                              minlength=6).float())


def rank_cache_writes(pmesh):
    """On a 2 x 2 mesh of real gloo ranks: ``write_rows`` and ``write_seq``
    into sequence- and batch-split caches, gathered, against the same
    writes into plain tensors (exact); decode attention by cache blocks
    (``attend_cache`` on a mesh) against one device's (1e-6)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.parallel.sharding import write_rows, write_seq
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, shape in (("kv", (4, 8, 2, 3)), ("latent", (4, 8, 5))):
        base = torch.randn(*shape, generator=g)
        pos = torch.tensor([0, 3, 4, 7])
        rows = torch.randn(shape[0], *shape[2:], generator=g)
        seq = torch.randn(shape[0], 5, *shape[2:], generator=g)
        slots = torch.tensor([6, 7, 0, 1, 2])
        cases = {"rows": lambda c: write_rows(c, pos, rows),
                 "prefix": lambda c: write_seq(c, seq),
                 "slots": lambda c: write_seq(c, seq, slots)}
        for case, write in cases.items():
            plain = base.clone()
            write(plain)
            sharded = distribute_tensor(base.clone(), mesh,
                                        [Shard(0), Shard(1)],
                                        src_data_rank=None)
            write(sharded)
            out[f"{name}/{case}"] = bool(torch.equal(sharded.full_tensor(),
                                                     plain))
    # decode attention over a cache split by rows and sequence, or by rows
    # and kv heads, against the same attention on one device
    from repro_torch.models.layers import attend_cache
    q = torch.randn(4, 1, 4, 3, generator=g)
    k, v = (torch.randn(4, 8, 2, 3, generator=g) for _ in range(2))
    valid = torch.arange(8)[None, :] < torch.tensor([1, 3, 6, 8])[:, None]
    want = attend_cache(q, k, v, valid, softcap=5.0)
    for case, where in (("seq", [Shard(0), Shard(1)]),
                        ("heads", [Shard(0), Shard(2)])):
        got = attend_cache(
            distribute_tensor(q, mesh, [Shard(0), Shard(2)] if case ==
                              "heads" else [Shard(0), Replicate()],
                              src_data_rank=None),
            distribute_tensor(k, mesh, where, src_data_rank=None),
            distribute_tensor(v, mesh, where, src_data_rank=None), valid,
            softcap=5.0)
        err = float((got.full_tensor() - want).abs().max())
        out[f"attend/{case}"] = err <= 1e-6
    return out


def test_sharded_cache_writes_equal_plain_writes():
    from repro_torch.launch import run_ranks
    ranks = run_ranks("test_torch_dryrun:rank_cache_writes", 4,
                      device="cpu", timeout=300)
    for r in ranks:
        assert r and all(r.values()), r


def test_a_renamed_torch_internal_is_refused(monkeypatch):
    """The counters find DTensor's sharding propagation by a torch-internal
    frame name: on this torch it is there, and a torch without it is
    refused, not miscounted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from repro_torch.launch import hlo_analysis as H
    H.check_torch_internals()
    monkeypatch.delattr(ShardingPropagator, H.PROPAGATION_FRAME)
    with pytest.raises(RuntimeError, match=H.PROPAGATION_FRAME):
        with count_ops():
            pass
    monkeypatch.undo()
    monkeypatch.setattr(H, "INDEX_MATH_FILES", ("distributed/no_such.py",))
    with pytest.raises(RuntimeError, match="no_such"):
        D._rank_fake_mode()


def test_dryrun_modules_import_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import repro_torch.launch.dryrun as D
        import repro_torch.launch.hlo_analysis as H
        import torch
        with H.count_ops() as st:
            torch.ones(2, 3) @ torch.ones(3, 4)
        assert st.dot_flops == 48
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


def test_cli_runs_a_coloring_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes one record per cell
    and prints the reference's lines (the coloring cell: no trace)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rmat-coloring", "--both-meshes", "--device", "cpu", "--out",
         str(tmp_path)], env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dry-run complete" in out.stdout
    for mp, n in (("pod", 256), ("multipod", 512)):
        with open(tmp_path / f"rmat-coloring__coloring__{mp}__baseline.json") as f:
            rec = json.load(f)
        assert rec["devices"] == n
        assert math.prod(rec["mesh"]) == n


def _print_table(title, table):
    print(f"== {title}: {sum(table.values()):.6e}")
    for key, v in sorted(table.items()):
        print(f"  {v:14.0f}  {key}")


def main():
    """One cell's FLOPs op by op in both packages (see ``port_by_op``), or,
    with ``--production``, the port's alone at the full config on the
    production meshes (``production_by_op``)."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--kind", choices=KINDS)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--microbatches", type=int, default=None,
                    help="default: 1, or the arch's MICROBATCH_DEFAULTS "
                         "with --production")
    ap.add_argument("--production", choices=("pod", "multipod", "both"),
                    help="the full config's --shape on the (16, 16) and/or "
                         "(2, 16, 16) mesh, port only")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--out", default="results/dryrun_by_op")
    ap.add_argument("--device", default=None,
                    help="with --production: cuda (the default: fake CUDA "
                         "tensors) or cpu")
    args = ap.parse_args()
    if args.production:
        mb = args.microbatches or D.MICROBATCH_DEFAULTS.get(args.arch, 1)
        for mp in (("pod", "multipod") if args.production == "both"
                   else (args.production,)):
            got = production_by_op(args.arch, args.shape, mp == "multipod",
                                   mb, args.out, device=args.device)
            _print_table(f"port {args.arch} {args.shape} {mp} (local "
                         f"matmuls by source line)", got)
        return
    if args.kind is None:
        ap.error("--kind is required without --production")
    cell = (args.arch, args.kind, args.seq, args.batch,
            args.microbatches or 1)
    ref, got = reference_by_op(*cell), port_by_op(*cell)
    _print_table("reference (HLO dots by op_name)", ref)
    _print_table("port (local matmuls by source line)", got)
    r, p = sum(ref.values()), sum(got.values())
    print(f"== port - reference: {p - r:+.6e} ({100 * (p / r - 1):+.2f} %)")


if __name__ == "__main__":
    main()
