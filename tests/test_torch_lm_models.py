"""repro_torch's model zoo (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, on the CPU at the smoke configs: the reference's
``init_params(cfg, PRNGKey(0))`` is carried into the port with
``convert.lm_params_from_arrays``, and the same numpy-seeded tokens (and
image embeddings / audio frames) go through both packages.

Integer outputs are held exactly: the configs, ``arch_blocks``,
``cache_spec`` shapes, dtypes and axes, ``cur_len``, the params tree's
paths, shapes and axes, and ``param_count``/``active_param_count``/
``model_flops`` of all ten full configs.

Float outputs carry a stated tolerance, a departure from the north star's
exact bar: the packages reduce in different orders.
* Float32 copies of the smoke configs: max abs error <= 1e-4·max(1,
  max|ref|), argmax tokens equal. Worst measured (CPU, torch 2.13 against
  jax 0.9): logits 4.8e-5 at max|ref| 4.0 (mamba2-130m; the others <=
  1.0e-5), caches 3.5e-5, decode logits 1.4e-5 (both mamba2-130m).
* bf16 as configured: the reference's own bar, err < 0.05·max(max|ref|,
  10) (``tests/test_decode.py``), on every token. Worst measured: 0.418
  (mamba2-130m; the dense archs <= 0.078). In bf16 a 1-ulp difference
  upstream of a router can flip a token's top-k expert, and through
  attention the flip reaches later tokens; so the MoE archs run with the
  reference's expert choices replayed into the port's routers (at the
  port's own router probabilities). Measured on these inputs with the
  choices replayed: deepseek 0.064, grok 0.0625 (over seeds 0-15: at most
  0.109 against a bar of 0.5). Left to choose for itself, the port picks
  other experts than the reference for 2 of deepseek's 32 tokens and none
  of grok's here (at most 3 of 32 over seeds 0-15); the test allows 4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.models import counting as RCount
from repro.models import transformer as RT
from repro_torch import models as PM
from repro_torch.configs import ARCH_IDS as P_ARCH_IDS
from repro_torch.configs import get_config as p_config
from repro_torch.configs import get_smoke_config as p_smoke
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays
from repro_torch.models import counting as PCount
from repro_torch.models import transformer as PT
from repro_torch.models.params import reference_leaves

from conftest import SLOW_ARCHS, arch_params

B, T, S = 2, 16, 32
MOE_ARCHS = {"deepseek-v2-lite-16b", "grok-1-314b"}
GROK_XFAIL = {"grok-1-314b": [pytest.mark.xfail(
    reason="MoE decode/full-forward logits mismatch, as in the reference "
           "(tests/test_decode.py)")]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, dtype=None, capacity=None, full=False):
    """The reference's and the port's config for ``arch``, changed alike."""
    out = []
    for cfg in ((r_config(arch), p_config(arch)) if full
                else (r_smoke(arch), p_smoke(arch))):
        if dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        if capacity and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def weights():
    """The reference's seed-0 params per smoke arch, as numpy trees (the
    dtype and capacity knobs do not change the params tree)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            params, _ = RM.init_params(r_smoke(arch), jax.random.PRNGKey(0))
            cache[arch] = jax.tree.map(np.asarray, params)
        return cache[arch]
    return get


def _batch(cfg, seed=0, t=T):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(B, cfg.vlm.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(B, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref_forward(cfg):
    return jax.jit(lambda p, b, c: RM.forward(cfg, p, b, caches=c))


def _ref_decode(cfg):
    return jax.jit(lambda p, c, t: RM.decode_step(cfg, p, c, t))


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", k)]
    return tree


# ------------------------------------------------------------------ configs
def test_config_registry_matches_reference():
    """Same arch ids, and every config (smoke and full) field for field."""
    assert P_ARCH_IDS == ARCH_IDS
    for arch in ARCH_IDS + ["rmat-coloring"]:
        for r, p in ((r_config(arch), p_config(arch)),
                     (r_smoke(arch), p_smoke(arch))):
            assert dataclasses.asdict(p) == dataclasses.asdict(r), arch
    spec = p_config("rmat-coloring").to_spec()
    assert (spec.strategy, spec.engine, spec.max_sweeps) == \
        ("distributed", "sort", 16384)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_blocks_match_reference(arch):
    for full in (False, True):
        rc, pc = _configs(arch, full=full)
        rp, rpat, rn, rs = RT.arch_blocks(rc)
        pp, ppat, pn, ps = PT.arch_blocks(pc)
        assert [b.key for b in pp] == [b.key for b in rp]
        assert [b.key for b in ppat] == [b.key for b in rpat]
        assert [b.key for b in ps] == [b.key for b in rs]
        assert pn == rn


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_match_reference(arch):
    """param_count, active_param_count, expert params and model_flops of
    the full config, exactly; the port's tree is built on the meta device."""
    rc, pc = _configs(arch, full=True)
    assert pc.param_count() == rc.param_count()
    assert pc.active_param_count() == rc.active_param_count()
    assert PCount.expert_param_count(pc) == RCount.expert_param_count(rc)
    for name, shape in PM.SHAPES.items():
        assert PCount.model_flops(pc, shape) == RCount.model_flops(rc, RM.SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_spec_matches_reference(arch):
    """Shapes, dtypes and logical axes of every cache leaf (smoke and full
    configs), and init_cache's zeros."""
    for full in (False, True):
        rc, pc = _configs(arch, full=full)
        rs, ra = RM.cache_spec(rc, 3, 40)
        ps, pa = PM.cache_spec(pc, 3, 40)
        rleaves = jax.tree_util.tree_flatten_with_path(
            rs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))[0]
        n = 0
        for path, leaf in rleaves:
            got = _leaf(ps, path)
            assert got.device.type == "meta"
            assert tuple(got.shape) == tuple(leaf.shape), path
            assert str(got.dtype).replace("torch.", "") == str(leaf.dtype), path
            n += 1
        assert n == len(jax.tree.leaves(ps))
        assert pa == ra
    caches = PM.init_cache(_configs(arch)[1], 3, 40, device="cpu")
    assert all(int(t.abs().sum()) == 0 for t in jax.tree.leaves(caches))


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_carry_across_exactly(arch, weights):
    """lm_params_from_arrays then lm_params_to_arrays gives the reference's
    tree back bit for bit; the port's names follow the path rule (a leaf of
    a stacked child ``S`` is ``S.{g}.rest``); the axes trees are equal."""
    rc, pc = _configs(arch)
    tree = weights(arch)
    module = lm_params_from_arrays(pc, tree, device="cpu")
    back = lm_params_to_arrays(module)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    names = dict(module.named_parameters())
    for path, parts, stacked in reference_leaves(module):
        if stacked:
            for g, part in enumerate(parts):
                assert names[".".join((path[0], str(g)) + path[1:])] is part
        else:
            assert names[".".join(path)] is parts[0]
    _, raxes = RM.init_params(rc, None)
    _, paxes = PM.init_params(pc, device="meta")
    assert paxes == raxes


def test_params_from_arrays_checks_the_tree(weights):
    pc = p_smoke("qwen3-4b")
    tree = weights("qwen3-4b")
    bad = dict(tree, final_norm=np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_arrays(pc, bad, device="cpu")
    with pytest.raises(KeyError, match="lm_head"):
        lm_params_from_arrays(pc, {k: v for k, v in tree.items()
                                   if k != "lm_head"}, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        lm_params_from_arrays(pc, dict(tree, extra=np.zeros(1)), device="cpu")


def test_meta_init_allocates_nothing():
    """grok-1-314b's full tree on the meta device: 316 B parameters, no
    byte allocated, float32 (param_dtype) throughout."""
    pc = p_config("grok-1-314b")
    module, _ = PM.init_params(pc, device="meta")
    params = list(module.parameters())
    assert all(p.is_meta and p.dtype == torch.float32 for p in params)
    assert sum(p.numel() for p in params) == pc.param_count() > 3e11
    assert not any(p.requires_grad for p in params)


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = p_smoke("qwen3-4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.init_params(pc, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.init_cache(pc, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_arrays(pc, {})
    with pytest.raises(ValueError, match="Generator"):
        PM.init_params(pc, None, device="cpu")


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference_float32(arch, weights):
    """Logits and aux loss of a float32 copy; the module's call is the
    function."""
    rc, pc = _configs(arch, dtype="float32")
    module = lm_params_from_arrays(pc, weights(arch), device="cpu")
    batch = _batch(rc)
    rl, raux, _ = _ref_forward(rc)(weights(arch), _jb(batch), None)
    with torch.inference_mode():
        pl, paux, none = PM.forward(pc, module, _tb(batch))
        if pc.family == "encdec":
            again = module(_tb(batch)["tokens"], _tb(batch)["frames"])[0]
        else:
            again = module(_tb(batch)["tokens"],
                           image_embeds=_tb(batch).get("image_embeds"))[0]
    assert none is None and torch.equal(again, pl)
    rl, pl = _f32(rl), _f32(pl)
    assert pl.shape == rl.shape == (B, T, rc.vocab_size)
    assert np.abs(pl - rl).max() <= 1e-4 * max(1.0, np.abs(rl).max())
    assert np.array_equal(pl.argmax(-1), rl.argmax(-1))
    assert abs(float(paux) - float(raux)) <= 1e-6


def _record_reference_routing(monkeypatch):
    """The expert indices ``lax.top_k`` picks in each of the reference's MoE
    layers, in call order, read back from the jitted forward through an
    ordered debug callback."""
    import repro.models.moe as RMoE
    seen, real = [], RMoE.lax

    class _Lax:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def top_k(x, k):
            vals, idx = real.top_k(x, k)
            jax.debug.callback(lambda a: seen.append(np.asarray(a)), idx,
                               ordered=True)
            return vals, idx

    monkeypatch.setattr(RMoE, "lax", _Lax())
    return seen


def _replay_routing(monkeypatch, routes):
    """The port's MoE layers take ``routes``' experts, in call order, at
    their own router probabilities. Returns the experts each layer would
    have picked itself, and the routes not yet replayed."""
    from repro_torch.models import moe as PMoE
    real, queue, own = PMoE.top_k_lower_index, list(routes), []

    def top_k(probs, k):
        _, idx = real(probs, k)
        own.append(idx.numpy())
        forced = torch.from_numpy(np.array(queue.pop(0))).to(idx.dtype)
        return torch.gather(probs, -1, forced), forced

    monkeypatch.setattr(PMoE, "top_k_lower_index", top_k)
    return own, queue


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference_bf16(arch, weights, monkeypatch):
    """Logits of the config as it is (bf16 compute): the reference's own
    bar on every token, with the reference's expert choices replayed into
    the port for the MoE archs (see the module docstring)."""
    rc, pc = _configs(arch)
    module = lm_params_from_arrays(pc, weights(arch), device="cpu")
    batch = _batch(rc)
    moe = arch in MOE_ARCHS
    if moe:
        routes = _record_reference_routing(monkeypatch)
    rl, _, _ = _ref_forward(rc)(weights(arch), _jb(batch), None)
    jax.effects_barrier()
    if moe:
        own, left = _replay_routing(monkeypatch, routes)
    with torch.inference_mode():
        pl, _, _ = PM.forward(pc, module, _tb(batch))
    if moe:
        assert routes and len(own) == len(routes) and not left
        chose_other = np.zeros((B, T), bool)
        for mine, theirs in zip(own, routes):
            chose_other |= (np.sort(mine, -1) != np.sort(theirs, -1)).any(-1)
        assert chose_other.sum() <= B * T // 8, int(chose_other.sum())
    assert pl.dtype == torch.bfloat16
    rl, pl = _f32(rl), _f32(pl)
    bar = 0.05 * max(np.abs(rl).max(), 10.0)
    assert np.abs(pl - rl).max() < bar, np.abs(pl - rl).max(-1)


def test_loss_fn_matches_reference(weights):
    """Forward-only loss (next-token NLL + MoE aux) and chunked_xent's
    chunking, float32."""
    for arch in ("qwen3-4b", "deepseek-v2-lite-16b", "whisper-medium"):
        rc, pc = _configs(arch, dtype="float32")
        module = lm_params_from_arrays(pc, weights(arch), device="cpu")
        batch = _batch(rc)
        batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
        rloss, rm = jax.jit(lambda p, b: RM.loss_fn(rc, p, b))(
            weights(arch), _jb(batch))
        with torch.inference_mode():
            ploss, pm = PM.loss_fn(pc, module, _tb(batch))
        assert abs(float(ploss) - float(rloss)) <= 1e-5, arch
        assert abs(float(pm["aux"]) - float(rm["aux"])) <= 1e-6, arch
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 32, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 32)).astype(np.int32)
    for chunk in (4, 32, 7):
        want = RT.chunked_xent(jnp.asarray(logits), jnp.asarray(labels), chunk)
        got = PT.chunked_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                              chunk)
        assert abs(float(got) - float(want)) <= 1e-5


# ------------------------------------------------------------------ decode
def _prefill_and_decode_match(rc, pc, tree, t=T, s=S, steps=2):
    """Prefill ``t`` tokens into an ``s``-slot cache in both packages and
    compare the caches leaf by leaf (cur_len exactly), then the logits and
    the caches over ``steps`` decode steps."""
    module = lm_params_from_arrays(pc, tree, device="cpu")
    batch = _batch(rc, t=t)
    rcache = RM.init_cache(rc, B, s)
    _, _, rcache = _ref_forward(rc)(tree, _jb(batch), rcache)
    with torch.inference_mode():
        pcache = PM.init_cache(pc, B, s, device="cpu")
        _, _, pcache = PM.forward(pc, module, _tb(batch), caches=pcache)

    def same_caches():
        for path, leaf in jax.tree_util.tree_flatten_with_path(rcache)[0]:
            got, want = _f32(_leaf(pcache, path)), _f32(leaf)
            if path[-1].key == "cur_len":
                assert np.array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= \
                    1e-4 * max(1.0, np.abs(want).max()), path

    same_caches()
    step = _ref_decode(rc)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        nt = rng.integers(0, rc.vocab_size, (B,)).astype(np.int32)
        rl, rcache = step(tree, rcache, jnp.asarray(nt))
        with torch.inference_mode():
            pl, pcache = PM.decode_step(pc, module, pcache, torch.from_numpy(nt))
        rl, pl = _f32(rl), _f32(pl)
        assert np.abs(pl - rl).max() <= 1e-4 * max(1.0, np.abs(rl).max())
        assert np.array_equal(pl.argmax(-1), rl.argmax(-1))
        same_caches()


@pytest.mark.parametrize("arch", arch_params(ARCH_IDS))
def test_prefill_and_decode_match_reference(arch, weights):
    """Float32 copy (MoE capacity 8, as the reference's decode test): the
    caches after prefill leaf by leaf (cur_len exactly), then the logits
    and the caches over two decode steps."""
    rc, pc = _configs(arch, dtype="float32", capacity=8.0)
    _prefill_and_decode_match(rc, pc, weights(arch))


@pytest.mark.parametrize("t", [6, 20])
@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b"])
def test_local_ring_buffer_wraps_like_the_reference(arch, t, weights):
    """The local-attention layers' ring buffer of 8 slots around its wrap.
    After a 6-token prefill, four decode steps run with one slot still
    empty, with the buffer just full, then overwrite slots 0 and 1. A
    20-token prefill fills the buffer from slot 20 % 8 and decodes on
    around it. Float32 copies, compared as in the decode test above."""
    rc, pc = (dataclasses.replace(c, local_window=8)
              for c in _configs(arch, dtype="float32"))
    local = "b0" if arch == "gemma2-2b" else "b2"
    assert PM.cache_spec(pc, B, S)[0]["blocks"][local]["k"].shape[2] == 8
    _prefill_and_decode_match(rc, pc, weights(arch), t=t, steps=4)


@pytest.mark.parametrize("arch", arch_params(ARCH_IDS, extra_marks=GROK_XFAIL))
def test_prefill_then_decode_matches_full(arch):
    """The reference's serving contract on the port alone
    (``tests/test_decode.py``): prefill + decode == the full forward, bf16
    as configured, under its bar; the weights are the port's own draws."""
    _, pc = _configs(arch, capacity=8.0)
    module, _ = PM.init_params(pc, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(0)
    batch = _tb(_batch(pc))
    with torch.inference_mode():
        caches = PM.init_cache(pc, B, S, device="cpu")
        _, _, caches = PM.forward(pc, module, batch, caches=caches)
        assert caches["cur_len"].tolist() == [T] * B
        toks = batch["tokens"]
        for _ in range(2):
            nt = torch.from_numpy(rng.integers(0, pc.vocab_size, (B,)).astype(np.int32))
            logits, caches = PM.decode_step(pc, module, caches, nt)
            toks = torch.cat([toks, nt[:, None]], dim=1)
            full, _, _ = PM.forward(pc, module, dict(batch, tokens=toks))
            err = float((logits.float() - full[:, -1].float()).abs().max())
            ref = float(full[:, -1].float().abs().max())
            assert err < 0.05 * max(ref, 10.0), (arch, err, ref)


def test_decode_batch_isolated():
    """Per-sequence cur_len: decoding leaks nothing across batch rows."""
    pc = p_smoke("qwen3-4b")
    module, _ = PM.init_params(pc, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, pc.vocab_size, (2, 8)).astype(np.int32))
    nt = torch.from_numpy(rng.integers(0, pc.vocab_size, (2,)).astype(np.int32))
    with torch.inference_mode():
        caches = PM.init_cache(pc, 2, 16, device="cpu")
        _, _, caches = PM.forward(pc, module, {"tokens": toks}, caches=caches)
        la, _ = PM.decode_step(pc, module, caches, nt)
        caches2 = PM.init_cache(pc, 2, 16, device="cpu")
        _, _, caches2 = PM.forward(pc, module, {"tokens": toks.flip(0)},
                                   caches=caches2)
        lb, _ = PM.decode_step(pc, module, caches2, nt.flip(0))
    assert float((la.float() - lb.flip(0).float()).abs().max()) <= 2e-2


def test_whisper_at_1500_frames_reproduces_the_reference():
    """At whisper-medium's 1500 frames the reference's non-causal
    flash_attention pads the keys to two chunks of 1024 and attends to the
    zero pad, which decode's cache_attention does not: its decode misses
    its own full forward (0.79 at these widths, float32). The port keeps
    the reference's algorithm, so it reproduces both sides (measured:
    2e-6 against the reference) and the same gap."""
    rc, pc = _configs("whisper-medium", dtype="float32")
    rc, pc = (dataclasses.replace(c, encdec=dataclasses.replace(
        c.encdec, enc_seq=1500)) for c in (rc, pc))
    tree = jax.tree.map(np.asarray, RM.init_params(rc, jax.random.PRNGKey(0))[0])
    module = lm_params_from_arrays(pc, tree, device="cpu")
    batch = _batch(rc, t=8)
    nt = np.random.default_rng(1).integers(0, rc.vocab_size, (B,)).astype(np.int32)
    longer = dict(batch, tokens=np.concatenate([batch["tokens"], nt[:, None]], 1))
    rcache = _ref_forward(rc)(tree, _jb(batch), RM.init_cache(rc, B, 16))[2]
    rdec = _f32(_ref_decode(rc)(tree, rcache, jnp.asarray(nt))[0])
    rfull = _f32(_ref_forward(rc)(tree, _jb(longer), None)[0][:, -1])
    with torch.inference_mode():
        pcache = PM.forward(pc, module, _tb(batch),
                            caches=PM.init_cache(pc, B, 16, device="cpu"))[2]
        pdec = _f32(PM.decode_step(pc, module, pcache, torch.from_numpy(nt))[0])
        pfull = _f32(PM.forward(pc, module, _tb(longer))[0][:, -1])
    assert np.abs(pdec - rdec).max() <= 1e-4 * max(1.0, np.abs(rdec).max())
    assert np.abs(pfull - rfull).max() <= 1e-4 * max(1.0, np.abs(rfull).max())
    gap = np.abs(rdec - rfull).max()
    assert gap >= 0.05 * max(np.abs(rfull).max(), 10.0)
    assert abs(np.abs(pdec - pfull).max() - gap) <= 1e-4


def test_whisper_decode_matches_full_forward_with_one_key_chunk(monkeypatch):
    """The witness for whisper's cross-attention cache at 1500 frames: with
    every key in one chunk of ``flash_attention`` (no zero-padded key), the
    port's prefill + two decode steps meet its own full forward under the
    reference's bar, in float32 and in bf16 as configured. Measured: 1.5e-6
    (float32) and 0.016 (bf16) at max|ref| ~3.9."""
    from repro_torch.models import layers as PL
    real = PL.flash_attention

    def one_chunk(q, k, v, **kw):
        kw["kv_chunk"] = max(k.shape[1], kw.get("kv_chunk", 1024))
        return real(q, k, v, **kw)

    monkeypatch.setattr(PL, "flash_attention", one_chunk)
    for dtype in ("float32", None):
        _, pc = _configs("whisper-medium", dtype=dtype)
        pc = dataclasses.replace(pc, encdec=dataclasses.replace(
            pc.encdec, enc_seq=1500))
        module, _ = PM.init_params(pc, torch.Generator().manual_seed(0),
                                   device="cpu")
        batch = _tb(_batch(pc, t=8))
        rng = np.random.default_rng(1)
        with torch.inference_mode():
            caches = PM.forward(pc, module, batch,
                                caches=PM.init_cache(pc, B, 16, device="cpu"))[2]
            toks = batch["tokens"]
            for _ in range(2):
                nt = torch.from_numpy(
                    rng.integers(0, pc.vocab_size, (B,)).astype(np.int32))
                logits, caches = PM.decode_step(pc, module, caches, nt)
                toks = torch.cat([toks, nt[:, None]], dim=1)
                full = PM.forward(pc, module, dict(batch, tokens=toks))[0][:, -1]
                err = float((logits.float() - full.float()).abs().max())
                ref = float(full.float().abs().max())
                assert err < 0.05 * max(ref, 10.0), (dtype, err, ref)
