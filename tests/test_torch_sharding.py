"""repro_torch's sharding rules (``repro_torch.parallel.sharding``), mesh and
spec builders (``repro_torch.launch.{mesh,specs}``) against the
reference's, on the CPU and without a process group: a mesh here is any
object with axis names and a shape, as the reference's ``FakeMesh`` is.

The first five tests are the port's versions of
``tests/test_sharding_rules.py``. Then, for every arch's full params tree,
the port's ``spec_for_array`` equals the reference's leaf for leaf on the
production meshes ``(16, 16)`` and ``(2, 16, 16)`` and on ``(4, 16)``; a
port parameter of a stacked leaf gets the reference's spec without its
``"layers"`` entry, and ``tree_shardings`` turns each spec into DTensor
placements. Integer results, held exactly.
"""
import dataclasses

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import models as RM
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_config
from repro.launch import specs as RS
from repro.parallel import sharding as RSH
from repro_torch import models as PM
from repro_torch.configs import get_config as p_config
from repro_torch.configs import get_smoke_config as p_smoke
from repro_torch.launch import mesh as PMESH
from repro_torch.launch import specs as PS
from repro_torch.launch import train as ltrain
from repro_torch.models.params import param_axes, reference_leaves
from repro_torch.parallel.sharding import (DEFAULT_RULES, Rules, Spec,
                                           activation_rules, constrain,
                                           fit_placements, logical_to_spec,
                                           placements,
                                           row_local, rules_for_mesh,
                                           spec_for_array, unshard)
from repro_torch.train import AdamWConfig, TrainStepConfig


class FakeMesh:
    """A mesh without devices: axis names and a shape."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = type("D", (), {"shape": tuple(shape)})()


MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (4, 16): ("data", "model")}


@pytest.fixture(scope="module")
def mesh():
    return FakeMesh((1, 1), ("data", "model"))


# ------------------------------------------- tests/test_sharding_rules.py
def test_basic_mapping(mesh):
    rules = rules_for_mesh(mesh)
    spec = logical_to_spec(("embed", "mlp"), rules)
    assert spec == Spec("data", "model")


def test_pod_pruned_on_single_pod(mesh):
    rules = rules_for_mesh(mesh)
    assert rules.resolve("batch") == ("data",) or rules.resolve("batch") == "data"


def test_dedup_repeated_axis():
    rules = Rules({"a": "model", "b": "model"})
    spec = logical_to_spec(("a", "b"), rules)
    assert spec == Spec("model", None)  # later dim loses the contested axis


def test_divisibility_drop():
    fake = FakeMesh((4, 16), ("data", "model"))
    rules = rules_for_mesh(fake, DEFAULT_RULES)
    # kv_heads = 8 does not divide model=16 -> replicated
    spec = spec_for_array((2, 128, 8, 64), ("batch", None, "kv_heads", None),
                          rules, fake)
    assert spec[2] is None
    # heads = 32 divides -> sharded
    spec2 = spec_for_array((2, 128, 32, 64), ("batch", None, "heads", None),
                           rules, fake)
    assert spec2[2] == "model"


def test_override():
    r = DEFAULT_RULES.override(experts=None)
    assert r.resolve("experts") is None
    assert r.resolve("heads") == "model"


# ------------------------------------------------ parity, every full arch
def test_default_rules_are_the_reference_table():
    assert DEFAULT_RULES.table == RSH.DEFAULT_RULES.table
    for shape, axes in MESHES.items():
        fake = FakeMesh(shape, axes)
        assert rules_for_mesh(fake).table == \
            RSH.rules_for_mesh(fake).table


def _leaves(shapes, axes, path=()):
    if isinstance(axes, dict):
        for k in axes:
            yield from _leaves(shapes[k], axes[k], path + (k,))
    else:
        yield path, tuple(shapes.shape), axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_array_is_the_reference_on_production_meshes(arch):
    """Every leaf of the full config's params tree: the port's spec equals
    the reference's (same shape and axes), and each port parameter's spec
    is its reference leaf's without the leading ``"layers"`` entry."""
    rshapes, raxes = RM.init_params(r_config(arch), None)
    module, paxes = PM.init_params(p_config(arch), device="meta")
    assert paxes == raxes
    leaves = list(_leaves(rshapes, raxes))
    by_name = param_axes(module, paxes)
    ports = list(reference_leaves(module))
    assert len(ports) == len(leaves)
    names = {id(p): n for n, p in module.named_parameters()}
    sharded = 0
    for shape, axes in MESHES.items():
        fake = FakeMesh(shape, axes)
        prules, rrules = rules_for_mesh(fake), RSH.rules_for_mesh(fake)
        want = {}
        for path, shp, ax in leaves:
            got = spec_for_array(shp, ax, prules, fake)
            ref = RSH.spec_for_array(shp, ax, rrules, fake)
            assert tuple(got) == tuple(ref), (path, shape)
            want[path] = tuple(ref)
            sharded += any(e is not None for e in got)
        for path, parts, stacked in ports:
            ref = want[path][1:] if stacked else want[path]
            for p in parts:
                got = spec_for_array(tuple(p.shape), by_name[names[id(p)]],
                                     prules, fake)
                assert tuple(got) == ref, (names[id(p)], shape)
    assert sharded > 0


def test_kv_heads_stay_whole_where_model_does_not_divide_them():
    """qwen3-4b's 8 kv heads on model=16 are replicated, its 32 heads
    split, and the embed dim goes to data."""
    module, axes = PM.init_params(p_config("qwen3-4b"), device="meta")
    fake = FakeMesh((16, 16), ("data", "model"))
    sh = PS.tree_shardings(dict(module.named_parameters()),
                           param_axes(module, axes), rules_for_mesh(fake),
                           fake)
    wq, wk = sh["blocks.0.b0.attn.wq"], sh["blocks.0.b0.attn.wk"]
    assert wq == (Shard(0), Shard(1))      # (embed, heads, head_dim)
    assert wk == (Shard(0), Replicate())   # kv_heads 8 on model 16
    assert sh["embed"] == (Shard(1), Shard(0))


def test_tree_shardings_match_the_reference_on_batch_and_caches():
    """Batch and decode-cache trees: placements from the same specs as the
    reference's ``NamedSharding`` tree, meta tensors of its shapes and
    dtypes."""
    cfg_r, cfg_p = r_config("deepseek-v2-lite-16b"), p_config(
        "deepseek-v2-lite-16b")
    shape = RM.ShapeConfig("t", 4096, 256, "train")
    for arch in ("whisper-medium", "llama-3.2-vision-11b"):
        rb, pb = RS.batch_specs(r_config(arch), shape), \
            PS.batch_specs(p_config(arch), shape)
        assert sorted(rb) == sorted(pb)
        for k in rb:
            assert tuple(rb[k].shape) == tuple(pb[k].shape)
            assert str(rb[k].dtype) == str(pb[k].dtype).split(".")[-1]
            assert pb[k].is_meta
        assert RS.batch_axes(r_config(arch)) == PS.batch_axes(p_config(arch))
    for shape_, axes in MESHES.items():
        fake = FakeMesh(shape_, axes)
        rcache, rax, rtok = RS.decode_specs(cfg_r, RM.ShapeConfig(
            "d", 4096, 64, "decode"))
        pcache, pax, ptok = PS.decode_specs(cfg_p, RM.ShapeConfig(
            "d", 4096, 64, "decode"))
        assert pax == rax and tuple(ptok.shape) == tuple(rtok.shape)
        got = PS.tree_shardings(pcache, pax, rules_for_mesh(fake), fake)
        for path, shp, ax in _leaves(rcache, rax):
            node = got
            for k in path:
                node = node[k]
            ref = RSH.spec_for_array(shp, ax, RSH.rules_for_mesh(fake), fake)
            assert node == placements(Spec(*ref), fake), path
    assert PS.scalar_sharding(FakeMesh((2, 16, 16), MESHES[(2, 16, 16)])) == \
        (Replicate(),) * 3


def test_placements_follow_the_mesh_axis_order():
    fake = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    rules = rules_for_mesh(fake)
    spec = spec_for_array((64, 128), ("batch", None), rules, fake)
    assert spec == Spec(("pod", "data"), None)
    assert placements(spec, fake) == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        placements(Spec(("data", "pod"), None), fake)


@pytest.mark.parametrize("shape", list(MESHES))
def test_fit_placements_is_spec_for_arrays_rule(shape):
    """A row split the mesh does not divide is dropped by the same rule on
    placements (a microbatch's input) as on specs (``constrain``)."""
    fake = FakeMesh(shape, MESHES[shape])
    rules = rules_for_mesh(fake)
    split = placements(Spec(("pod", "data") if len(shape) == 3 else "data",
                            None), fake)
    for rows in (1, 2, 4, 16, 32, 64):
        want = placements(spec_for_array((rows, 8), ("batch", None), rules,
                                         fake), fake)
        assert fit_placements((rows, 8), split, fake) == want, rows
    assert fit_placements((1, 8), split, fake) == (Replicate(),) * len(shape)


def test_constrain_and_friends_are_the_identity_off_a_mesh():
    """Plain tensors pass ``constrain``, ``unshard`` and ``row_local``
    untouched, rules or no rules."""
    x = torch.arange(12.0).reshape(3, 4)
    fake = FakeMesh((2, 2), ("data", "model"))
    for rules in (None, rules_for_mesh(fake)):
        with activation_rules(rules):
            assert constrain(x, ("batch", None)) is x
            assert unshard(x, 0, 1) is x
            assert row_local(lambda a: a * 2, 1)(x).equal(x * 2)


def test_production_mesh_refuses_too_few_ranks():
    """Without a process group of 256 (512) ranks the production meshes
    raise and say how many they take; importing the module touched no
    group."""
    assert PMESH.production_shape() == ((16, 16), ("data", "model"))
    assert PMESH.production_shape(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"takes {n} ranks"):
            PMESH.make_production_mesh(multi_pod=multi, device="cpu")


def test_build_on_a_mesh_defaults_to_the_card(monkeypatch):
    """``build(mesh=...)`` with ``device=None`` runs on the card, and so
    raises without one, before it touches the mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(p_smoke("qwen3-4b"), dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ltrain.build(cfg, AdamWConfig(), TrainStepConfig(), mesh=object())
