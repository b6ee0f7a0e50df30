"""repro_torch's sharded LM trainer (``launch.train.build(mesh=)``,
``shard_for_mesh``, ``train_on_mesh``; ``train.checkpoint.restore(
shardings=)``) on four gloo ranks on the CPU, held to the reference's
one-device jitted step.

The reference's own sharded-step test (``tests/test_distributed.py::
test_sharded_train_step_2x2``) does not run under this jax, but its
one-device step does; so the port's sharded step is held against that
step, which is what the reference's test meant to show. One launch of four
ranks (``run_ranks``) does all the rank-side work while this process
computes the reference's steps:

* every arch at its smoke config (float32 copies), one step on the 2 x 2
  ``("data", "model")`` mesh from the reference's seed-0 params (carried
  with ``convert.lm_params_from_arrays``), against the reference's
  one-device jitted step on the same batch, under the bars of
  ``tests/test_torch_train.py`` (``_hold_step``: loss and ``grad_norm``,
  m and v, the gradient read off m, params where |g| clears the bar);
* qwen3-4b on the ``(1, 4)`` and ``(4, 1)`` meshes under the same bars
  (``(1, 4)`` replicates its 2 kv heads: 4 does not divide them);
* sharding at rest: every param and moment shard on every rank has the
  size its spec implies, and on 2 x 2 each rank holds a quarter of each of
  the largest leaves;
* checkpoints: a 2 x 2 ``save`` is byte-identical to a one-device save of
  the same values; ``restore(shardings=)`` puts it on ``(4, 1)``, and a
  plain ``restore`` on one device, and the next step of each equals the
  2 x 2 run's next step under the same bars; a reference checkpoint
  restores onto the 2 x 2 mesh;
* ``microbatches=2`` on 2 x 2 (microbatch ``i`` is block ``i`` of the
  global rows) against the reference's microbatched jitted step, for a
  dense arch and an MoE arch (whose aux loss is a product of
  per-microbatch means, so it sees which rows form a microbatch);
* ``build(mesh=)`` draws the one-device ``build``'s seed-0 params, and
  ``train_on_mesh`` repeats the one-device driver's losses;
* ``make_mesh`` refuses several gloo ranks on the card.
"""
import dataclasses
import filecmp
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch import models as PM
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_smoke_config as p_smoke
from repro_torch.convert import (lm_params_from_arrays, lm_params_to_arrays,
                                 opt_state_from_arrays, opt_state_to_arrays)
from repro_torch.launch import run_ranks
from repro_torch.launch import train as ltrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import param_axes, tree_map
from repro_torch.parallel.sharding import (Spec, placements, rules_for_mesh,
                                           spec_for_array, whole)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tstep

B, T = 4, 16
MICRO = ("qwen3-4b", "deepseek-v2-lite-16b")    # microbatches=2 on 2 x 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DRIVER = dict(arch="qwen3-4b", smoke=True, steps=3, batch=B, seq=T,
              log_every=1, ckpt_every=2)


def _cfg(arch):
    return dataclasses.replace(p_smoke(arch), dtype="float32")


def _batch(cfg, step):
    dcfg = tdata.data_config_for(cfg, PM.ShapeConfig("t", T, B, "train"))
    return {k: torch.from_numpy(v)
            for k, v in tdata.batch_for_step(dcfg, step).items()}


# ------------------------------------------------------------- rank side
def _gathered(params, state):
    """``{"params", "opt"}`` in the reference's layout, whole (every rank
    calls it: the leaves are gathered)."""
    return {"params": lm_params_to_arrays(params),
            "opt": opt_state_to_arrays(params, state)}


def _save(rank, root, tree):
    if rank == 0:
        tckpt.save(root, 0, tree)


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def _held_bytes(params, axes, state, mesh) -> dict:
    """Each param's and moment's local numel against the size its spec on
    ``mesh`` implies; local and whole bytes; the whole-held leaves."""
    from torch.distributed.tensor import DTensor
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules = rules_for_mesh(mesh)
    by_name = param_axes(params, axes)
    bad, whole_held = [], []
    local_b = whole_b = 0
    largest = []
    for name, p in params.named_parameters():
        spec = spec_for_array(tuple(p.shape), by_name[name], rules, mesh)
        split = [int(np.prod([sizes[a] for a in
                              ((e,) if isinstance(e, str) else e or ())]))
                 for e in spec]
        want = int(np.prod([n // k for n, k in zip(p.shape, split)]))
        for t in (p, state["m"][name], state["v"][name]):
            assert isinstance(t, DTensor)
            assert t.placements == placements(spec, mesh), name
            if t.to_local().numel() != want:
                bad.append(name)
            local_b += t.to_local().numel() * t.element_size()
            whole_b += t.numel() * t.element_size()
        if want == p.numel():
            whole_held.append([name, list(p.shape)])
        largest.append([p.numel(), name, want])
    largest.sort(reverse=True)
    return dict(bad=bad, whole_held=whole_held, local=local_b, whole=whole_b,
                largest=largest[:4])


def rank_sharded(pmesh, root):
    """The four ranks' work (module docstring); writes the gathered states
    under ``root`` (rank 0) and returns what the tests read."""
    rank = pmesh.rank
    out = {"steps": {}}
    opt_cfg = topt.AdamWConfig(**OPT)
    ts_cfg = tstep.TrainStepConfig()
    meshes = {s: make_mesh(s, ("data", "model"), "cpu")
              for s in ((2, 2), (1, 4), (4, 1))}

    def sharded(arch, shape, ts_cfg=ts_cfg):
        cfg = _cfg(arch)
        tree, _, _ = tckpt.load(os.path.join(root, "weights", arch))
        module = lm_params_from_arrays(cfg, tree, device="cpu")
        _, axes = PM.init_params(cfg, device="meta")
        params, state, step = ltrain.shard_for_mesh(
            cfg, module, axes, opt_cfg, ts_cfg, meshes[shape])
        _, _, m = step(params, state, _batch(cfg, 0))
        return cfg, params, axes, state, step, m

    for arch in ARCH_IDS:
        _, params, axes, state, _, m = sharded(arch, (2, 2))
        key = f"{arch}@2x2"
        out["steps"][key] = _metrics(m)
        _save(rank, os.path.join(root, "port", key), _gathered(params, state))
        out.setdefault("held", {})[arch] = _held_bytes(params, axes, state,
                                                       meshes[(2, 2)])
    for shape in ((1, 4), (4, 1)):
        _, params, axes, state, _, m = sharded("qwen3-4b", shape)
        key = f"qwen3-4b@{shape[0]}x{shape[1]}"
        out["steps"][key] = _metrics(m)
        _save(rank, os.path.join(root, "port", key), _gathered(params, state))
        out["held"][key] = _held_bytes(params, axes, state, meshes[shape])

    # checkpoints: 2 x 2 save == one-device save; restart on (4, 1) and on
    # one device, each against the 2 x 2 run's next step
    cfg, params, _, state, step, _ = sharded("qwen3-4b", (2, 2))
    ck = os.path.join(root, "ck22")
    tckpt.save(ck, 1, ltrain.state_tree(params, state))
    plain = tree_map(whole, ltrain.state_tree(params, state))
    if rank == 0:
        tckpt.save(os.path.join(root, "ck1dev"), 1, plain)
    _, _, m = step(params, state, _batch(cfg, 1))
    out["steps"]["next@2x2"] = _metrics(m)
    _save(rank, os.path.join(root, "port", "next@2x2"),
          _gathered(params, state))
    _, params41, _, state41, step41, _ = sharded("qwen3-4b", (4, 1))
    state41, at = ltrain.restore_into(ck, params41, state41,
                                      mesh=meshes[(4, 1)])
    restored = ltrain.state_tree(params41, state41)
    out["restored_placements"] = str(
        restored["params"]["blocks.0.b0.attn.wq"].placements)
    _, _, m = step41(params41, state41, _batch(cfg, 1))
    out["steps"]["next@4x1"] = _metrics(m)
    _save(rank, os.path.join(root, "port", "next@4x1"),
          _gathered(params41, state41))
    one = lm_params_from_arrays(cfg, tckpt.load(
        os.path.join(root, "weights", "qwen3-4b"))[0], device="cpu")
    state1, at1 = ltrain.restore_into(ck, one, topt.init_opt_state(one, opt_cfg))
    _, _, m = tstep.make_train_step(cfg, opt_cfg)(one, state1, _batch(cfg, 1))
    out["steps"]["next@1"] = _metrics(m)
    _save(rank, os.path.join(root, "port", "next@1"), _gathered(one, state1))
    out["restored_at"] = [at, at1]

    # microbatches=2 on 2 x 2, against the reference's microbatched step
    for arch in MICRO:
        _, params, _, state, _, m = sharded(
            arch, (2, 2), tstep.TrainStepConfig(microbatches=2))
        key = f"{arch}@2x2/mb2"
        out["steps"][key] = _metrics(m)
        _save(rank, os.path.join(root, "port", key), _gathered(params, state))

    # several gloo ranks on the card are refused (the default device too)
    out["refused"] = []
    for dev in (None, "cuda"):
        try:
            make_mesh((2, 2), ("data", "model"), dev)
        except ValueError as e:
            out["refused"].append(str(e))

    # a reference checkpoint onto the 2 x 2 mesh
    m22 = meshes[(2, 2)]
    where = placements(Spec("data", None), m22)
    got, _ = tckpt.restore(os.path.join(root, "refck"),
                           {"w": torch.zeros(4, 4)}, shardings={"w": where},
                           mesh=m22)
    out["refck"] = dict(placements=str(got["w"].placements),
                        local=got["w"].to_local().tolist(),
                        whole=whole(got["w"]).tolist())

    # build(mesh=) draws the one-device build's params; the driver on a mesh
    p22, s22, f22, mesh = ltrain.build(cfg, opt_cfg, ts_cfg, device="cpu",
                                       mesh=m22)
    p1, s1, f1, none = ltrain.build(cfg, opt_cfg, ts_cfg, device="cpu")
    out["build"] = dict(
        mesh=mesh is m22, none=none is None,
        equal=all(torch.equal(whole(a.detach()), b.detach()) for a, b in
                  zip(p22.parameters(), p1.parameters())))
    out["driver"] = ltrain.train_on_mesh(
        pmesh, mesh_shape=(2, 2), ckpt_dir=os.path.join(root, "drv"),
        **DRIVER)["losses"]
    return out


# ------------------------------------------------------------ test side
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the reference's seed-0 weights and a reference checkpoint,
    start the four ranks, compute the reference's steps while they run,
    and return ``(ranks' results, reference steps, root)``."""
    import jax
    import jax.numpy as jnp
    from repro import models as RM
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import checkpoint as rckpt
    from repro.train import optimizer as ropt
    from repro.train import train_step as rstep

    root = str(tmp_path_factory.mktemp("sharded"))
    weights = {}
    for arch in ARCH_IDS:
        params, _ = RM.init_params(r_smoke(arch), jax.random.PRNGKey(0))
        weights[arch] = jax.tree.map(np.asarray, params)
        rckpt.save(os.path.join(root, "weights", arch), 0, weights[arch])
    rckpt.save(os.path.join(root, "refck"), 2,
               {"w": jnp.arange(16.0).reshape(4, 4)})
    got = {}

    def ranks():
        try:
            got["ranks"] = run_ranks(
                "test_torch_train_sharded:rank_sharded", 4, dict(root=root),
                device="cpu", timeout=900, workdir=os.path.join(root, "job"))
        except Exception as e:     # re-raised below, after the reference
            got["error"] = e
    th = threading.Thread(target=ranks)
    th.start()
    ref = {}
    try:
        ocfg = ropt.AdamWConfig(**OPT)
        for arch, n in [(a, 1) for a in ARCH_IDS] + [(a, 2) for a in MICRO]:
            cfg = dataclasses.replace(r_smoke(arch), dtype="float32")
            step = jax.jit(rstep.make_train_step(
                cfg, ocfg, rstep.TrainStepConfig(microbatches=n)))
            rparams = jax.tree.map(jnp.asarray, weights[arch])
            batch = {k: jnp.asarray(v.numpy())
                     for k, v in _batch(_cfg(arch), 0).items()}
            rparams, rstate, rm = step(rparams, ropt.init_opt_state(
                rparams, ocfg), batch)
            ref[arch if n == 1 else f"{arch}/mb{n}"] = (rm, rparams, rstate)
    finally:
        th.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], ref, root


def _port(root, key):
    tree, _, _ = tckpt.load(os.path.join(root, "port", key))
    return tree


def _held_against(arch, port_tree, pm, rm, rparams, rstate):
    """``tests/test_torch_train.py``'s step bars between a gathered port
    state and ``(rm, rparams, rstate)``."""
    from test_torch_train import _hold_step
    module = lm_params_from_arrays(_cfg(arch), port_tree["params"],
                                   device="cpu")
    state = opt_state_from_arrays(module, port_tree["opt"])
    pm = {k: torch.tensor(v) for k, v in pm.items()}
    return _hold_step(pm, module, state, rm, rparams, rstate,
                      float(rm["lr"]), OPT.get("b1", 0.9))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_step_matches_the_reference_step(arch, runs):
    ranks, ref, root = runs
    key = f"{arch}@2x2"
    assert all(r["steps"][key] == ranks[0]["steps"][key] for r in ranks)
    rm, rparams, rstate = ref[arch]
    perr, loose, total = _held_against(arch, _port(root, key),
                                       ranks[0]["steps"][key], rm, rparams,
                                       rstate)
    print(f"{arch} on 2x2: loss {ranks[0]['steps'][key]['loss']:.6f}/"
          f"{float(rm['loss']):.6f} param err {perr:.3g}; {loose} of "
          f"{total} entries under the lr bar")


@pytest.mark.parametrize("shape", ["1x4", "4x1"])
def test_other_mesh_shapes_match_the_reference_step(shape, runs):
    ranks, ref, root = runs
    key = f"qwen3-4b@{shape}"
    rm, rparams, rstate = ref["qwen3-4b"]
    _held_against("qwen3-4b", _port(root, key), ranks[0]["steps"][key], rm,
                  rparams, rstate)
    held = ranks[0]["held"][key]
    assert not held["bad"]
    whole_names = {n for n, _ in held["whole_held"]}
    # (1, 4): 4 does not divide the smoke config's 2 kv heads
    kv = "blocks.0.b0.attn.wk" in whole_names
    assert kv == (shape == "1x4" and _cfg("qwen3-4b").n_kv_heads % 4 != 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_moments_are_sharded_at_rest(arch, runs):
    """Every rank holds exactly the shards its specs imply; each of the
    largest leaves is split four ways on 2 x 2; only small leaves (norms,
    biases, scalars' kin) are held whole."""
    ranks, _, _ = runs
    for r in ranks:
        held = r["held"][arch]
        assert not held["bad"], held["bad"]
        assert held["local"] < held["whole"]
        for numel, name, local in held["largest"][:2]:
            assert local * 4 == numel, (name, numel, local)
        cfg = _cfg(arch)
        for name, shape in held["whole_held"]:
            assert int(np.prod(shape)) <= 4 * cfg.d_model, (name, shape)


def test_sharded_save_is_the_one_device_save_byte_for_byte(runs):
    _, _, root = runs
    a, b = (tckpt.step_dir(os.path.join(root, d), 1)
            for d in ("ck22", "ck1dev"))
    for f in ("arrays.npz", "manifest.json"):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


def test_restart_on_other_meshes_takes_the_same_next_step(runs):
    """The 2 x 2 checkpoint restored onto (4, 1) with ``shardings=`` and
    onto one device: the next step equals the 2 x 2 run's next step under
    the step bars."""
    ranks, _, root = runs
    r0 = ranks[0]
    assert r0["restored_at"] == [1, 1]
    assert r0["restored_placements"] == "(Shard(dim=0), Replicate())"
    want = _port(root, "next@2x2")
    rm = {k: np.float32(v) for k, v in r0["steps"]["next@2x2"].items()}
    for key in ("next@4x1", "next@1"):
        _held_against("qwen3-4b", _port(root, key), r0["steps"][key], rm,
                      want["params"], want["opt"])


@pytest.mark.parametrize("arch", MICRO)
def test_microbatches_are_global_row_blocks(arch, runs):
    """``microbatches=2`` on 2 x 2 (microbatch ``i`` is block ``i`` of the
    global rows, one row of it on each data rank) takes the reference's
    microbatched step under the step bars, and returns the reference's
    last-microbatch ``nll`` and ``aux`` within the loss bar. The MoE
    arch's aux loss is a product of per-microbatch means, so a microbatch
    made of other rows (each rank's own rows split in two) misses it."""
    from test_torch_train import STEP_LOSS
    ranks, ref, root = runs
    key = f"{arch}@2x2/mb2"
    got = ranks[0]["steps"][key]
    assert all(r["steps"][key] == got for r in ranks)
    rm, rparams, rstate = ref[f"{arch}/mb2"]
    _held_against(arch, _port(root, key), got, rm, rparams, rstate)
    for k in ("nll", "aux"):
        want = float(rm[k])
        assert abs(got[k] - want) <= STEP_LOSS * max(1.0, abs(want)), k


def test_gloo_ranks_on_the_card_are_refused(runs):
    """``make_mesh`` refuses a mesh of four gloo ranks on the card (asked
    for by default or by name) and says why, before touching a device:
    gloo does not carry DTensor's collectives on CUDA tensors."""
    ranks, _, _ = runs
    for r in ranks:
        assert len(r["refused"]) == 2, r["refused"]
        for msg in r["refused"]:
            assert "4 gloo ranks on the card" in msg and "NCCL" in msg, msg


def test_reference_checkpoint_restores_onto_the_mesh(runs):
    """The port of ``tests/test_train_substrate.py::
    test_checkpoint_reshard_on_restore`` on a 2 x 2 mesh: rows split over
    ``data``, whole over ``model``."""
    ranks, _, _ = runs
    full = np.arange(16.0).reshape(4, 4)
    for r in ranks:
        got = r["refck"]
        assert got["placements"] == "(Shard(dim=0), Replicate())"
        assert np.array_equal(got["whole"], full)
    for rank, r in enumerate(ranks):
        rows = 2 * (rank // 2)
        assert np.array_equal(r["refck"]["local"], full[rows:rows + 2])


def test_build_on_a_mesh_and_the_driver_follow_one_device(runs, tmp_path):
    """``build(mesh=)`` holds the one-device build's seed-0 params, split;
    ``train_on_mesh`` repeats the one-device driver's losses within the
    loss bar, and its checkpoints restore on one device."""
    ranks, _, root = runs
    assert ranks[0]["build"] == dict(mesh=True, none=True, equal=True)
    argv = []
    for k, v in DRIVER.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    want = ltrain.main(argv + ["--device", "cpu"])
    for r in ranks:
        got = r["driver"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert abs(a - b) <= 2.0 ** -8 * abs(b), (got, want)
    assert tckpt.latest_step(os.path.join(root, "drv")) == DRIVER["steps"]
