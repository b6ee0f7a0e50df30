"""repro_torch's LM layers against the reference's (``repro.models.layers``,
``mamba2``, ``rglru``, ``mla``, ``moe``): the same numpy-seeded inputs and
weights go through both packages, on the CPU.

Tolerances. The two packages reduce in different orders, so the bar is a
stated tolerance, not the north star's exact equality. Inputs are float32
unless a case says bf16; the bar is an absolute error on values of order 1.
Worst errors measured here (CPU, torch 2.13 against jax 0.9): flash
attention 8.3e-7, local 7.2e-7, cache 4.8e-7, flash in bf16 0 (the same
bf16 values), rope 2.4e-7, rms_norm 7.2e-7 (bf16: 0, bit-equal), gelu
5.8e-7, SSD scan 1.1e-5 (y over one 50-step chunk; states 2.4e-6), RG-LRU
block 1.2e-7 (its log-step scan against ``lax.associative_scan``), Mamba-2
block 1.6e-6, MLA 1.2e-6, MoE 2.9e-6 (bf16: 0.125 at max|ref| 17, two
bf16 ulps).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from repro.models import layers as RL
from repro.models import mamba2 as RMa
from repro.models import mla as RMla
from repro.models import moe as RMoe
from repro.models import rglru as RRg
from repro.models.config import (MLAConfig, ModelConfig, MoEConfig,
                                 RGLRUConfig, SSMConfig)
from repro.models.params import ParamBuilder as RParamBuilder
from repro_torch.models import layers as PL
from repro_torch.models import mamba2 as PMa
from repro_torch.models import mla as PMla
from repro_torch.models import moe as PMoe
from repro_torch.models import rglru as PRg
from repro_torch.models import config as PC
from repro_torch.models.params import ParamTree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(got, want):
    return float(np.abs(_np(got) - _np(want)).max())


def _port_tree(tree) -> ParamTree:
    """The reference's params dict as a port ParamTree (same names)."""
    node = ParamTree()
    for k, v in tree.items():
        if isinstance(v, dict):
            node.add_module(k, _port_tree(v))
        else:
            node.register_parameter(k, nn.Parameter(
                torch.from_numpy(np.array(v, np.float32)), requires_grad=False))
    return node


def _ref_params(init, *args, seed=0):
    b = RParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    init(b, *args)
    p, _ = b.build()
    return p, _port_tree(p)


def _port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    sub = {"moe": PC.MoEConfig, "mla": PC.MLAConfig, "ssm": PC.SSMConfig,
           "rglru": PC.RGLRUConfig, "encdec": PC.EncDecConfig,
           "vlm": PC.VLMConfig}
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = (sub[f.name](**dataclasses.asdict(v))
                      if f.name in sub and v is not None else v)
    return PC.ModelConfig(**kw)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("t,h,kh,d", [(33, 4, 4, 16), (64, 8, 2, 32), (100, 4, 1, 8)])
@pytest.mark.parametrize("chunks", [(16, 16), (64, 32), (1024, 1024)])
def test_flash_matches_reference(t, h, kh, d, chunks):
    """Worst: 8.3e-7."""
    rng = np.random.default_rng(t + h)
    q, k, v = (rng.normal(size=(2, t, n, d)) for n in (h, kh, kh))
    pos = np.arange(t, dtype=np.int32)
    want = jax.jit(lambda q, k, v, pos: RL.flash_attention(
        q, k, v, q_positions=pos, kv_positions=pos, causal=True,
        q_chunk=chunks[0], kv_chunk=chunks[1]))(_j(q), _j(k), _j(v),
                                                jnp.asarray(pos))
    got = PL.flash_attention(_t(q), _t(k), _t(v),
                             q_positions=torch.from_numpy(pos),
                             kv_positions=torch.from_numpy(pos), causal=True,
                             q_chunk=chunks[0], kv_chunk=chunks[1])
    assert got.shape == want.shape
    assert _err(got, want) <= 1e-5


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [8, 16, 128])
def test_local_matches_reference(window, softcap):
    """Worst: 7.2e-7."""
    rng = np.random.default_rng(window)
    t, h, kh, d = 50, 4, 2, 16
    q, k, v = (rng.normal(size=(2, t, n, d)) for n in (h, kh, kh))
    pos = np.arange(t, dtype=np.int32)
    want = jax.jit(lambda q, k, v, pos: RL.local_attention(
        q, k, v, window=window, q_positions=pos, softcap=softcap))(
        _j(q), _j(k), _j(v), jnp.asarray(pos))
    got = PL.local_attention(_t(q), _t(k), _t(v), window=window,
                             q_positions=torch.from_numpy(pos), softcap=softcap)
    assert _err(got, want) <= 1e-5


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 50.0)])
def test_cache_attention_matches_reference(window, softcap):
    """Worst: 4.8e-7 (the masked tail beyond cur_len holds garbage on
    purpose)."""
    rng = np.random.default_rng(3)
    b, s, h, kh, d = 3, 16, 4, 2, 8
    q = rng.normal(size=(b, 1, h, d))
    k, v = rng.normal(size=(b, s, kh, d)), rng.normal(size=(b, s, kh, d))
    cur = np.array([4, 16, 9], np.int32)
    want = RL.cache_attention(_j(q), _j(k), _j(v), cur_len=jnp.asarray(cur),
                              window=window, softcap=softcap)
    got = PL.cache_attention(_t(q), _t(k), _t(v), cur_len=torch.from_numpy(cur),
                             window=window, softcap=softcap)
    assert _err(got, want) <= 1e-5


def test_flash_matches_reference_in_bf16():
    """bf16 operands (the models' compute dtype), fp32 accumulation in both;
    worst: 0 (the outputs round to the same bf16 values)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 40, n, 16)) for n in (4, 2, 2))
    pos = np.arange(40, dtype=np.int32)
    want = jax.jit(lambda q, k, v, pos: RL.flash_attention(
        q, k, v, q_positions=pos, kv_positions=pos, q_chunk=16, kv_chunk=16))(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
        jnp.asarray(pos))
    got = PL.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                             _t(v, torch.bfloat16),
                             q_positions=torch.from_numpy(pos),
                             kv_positions=torch.from_numpy(pos), q_chunk=16,
                             kv_chunk=16)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= 2 ** -6   # one bf16 ulp at 1-2


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    """1-D positions (prefill) and [B, 1] positions (decode); worst 2.4e-7."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 3, 16))
    pos = np.arange(8, dtype=np.int32) + 1000
    got = PL.rope(_t(x), torch.from_numpy(pos), theta)
    want = RL.rope(_j(x), jnp.asarray(pos), theta)
    assert _err(got, want) <= 2e-5   # angles in fp32 both sides
    x1 = rng.normal(size=(2, 1, 3, 16))
    cur = np.array([[5], [77]], np.int32)
    assert _err(PL.rope(_t(x1), torch.from_numpy(cur), theta),
                RL.rope(_j(x1), jnp.asarray(cur), theta)) <= 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    """fp32 reduction, data path in the input dtype, scaled by 1 + w;
    worst: 7.2e-7 in fp32, bit-equal in bf16."""
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(4, 5, 64)) * 3, rng.normal(size=(64,)) * 0.1
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = PL.rms_norm(_t(x, tdt), _t(w), 1e-6)
    want = RL.rms_norm(_j(x, jdt), _j(w), 1e-6)
    assert got.dtype == tdt
    assert _err(got, want) <= (1e-5 if dtype == "float32" else 0.0)


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; the port uses it too."""
    x = np.linspace(-6, 6, 97)
    assert _err(PL.gelu(_t(x)), jax.nn.gelu(_j(x))) <= 1e-6
    assert _err(PL.gelu(_t(x)), torch.nn.functional.gelu(_t(x))) > 1e-4


# ------------------------------------------------------------- SSD / RG-LRU
@pytest.mark.parametrize("chunk", [4, 8, 16, 50])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_reference(chunk, with_state):
    """Chunked SSD (intra-chunk segsum, inter-chunk state scan), T=50 so
    the last chunk is padded; worst 1.1e-5 (y), 2.4e-6 (states)."""
    rng = np.random.default_rng(chunk)
    b, t, h, p, n = 2, 50, 3, 4, 8
    x = rng.normal(size=(b, t, h, p))
    dta = -np.abs(rng.normal(size=(b, t, h))) * 0.3
    bm, cm = rng.normal(size=(b, t, n)), rng.normal(size=(b, t, n))
    s0 = rng.normal(size=(b, h, p, n)) if with_state else None
    y, final = PMa.ssd_scan(_t(x), _t(dta), _t(bm), _t(cm), chunk,
                            init_state=None if s0 is None else _t(s0))
    ry, rfinal = jax.jit(lambda *a, s: RMa.ssd_scan(*a, chunk, init_state=s))(
        _j(x), _j(dta), _j(bm), _j(cm), s=None if s0 is None else _j(s0))
    assert _err(y, ry) <= 1e-4 and _err(final, rfinal) <= 1e-4


def _rglru_cfg():
    return ModelConfig(name="t", family="hybrid", num_layers=1, d_model=16,
                       n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=64,
                       rglru=RGLRUConfig(d_rnn=24))


@pytest.mark.parametrize("t", [1, 10, 33])
def test_rglru_matches_reference(t):
    """The block (gates, conv, scan) on a full sequence, then one decode
    step from its state; worst 1.2e-7 (log-step scan vs associative_scan)."""
    cfg = _rglru_cfg()
    pj, pt = _ref_params(RRg.rglru_init, cfg, cfg.rglru)
    pcfg = _port_cfg(cfg)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, 16)) * 0.5
    ry, rh, rtail = jax.jit(lambda p, x: RRg.rglru_forward(
        p, x, cfg, cfg.rglru))(pj, _j(x))
    y, h, tail = PRg.rglru_forward(pt, _t(x), pcfg, pcfg.rglru)
    assert _err(y, ry) <= 1e-5 and _err(h, rh) <= 1e-5 and _err(tail, rtail) <= 1e-6
    x1 = rng.normal(size=(2, 1, 16)) * 0.5
    ry1, rh1, rt1 = jax.jit(lambda *a: RRg.rglru_decode(
        *a, cfg, cfg.rglru))(pj, _j(x1), rh, rtail)
    y1, h1, t1 = PRg.rglru_decode(pt, _t(x1), h, tail, pcfg, pcfg.rglru)
    assert _err(y1, ry1) <= 1e-5 and _err(h1, rh1) <= 1e-5 and _err(t1, rt1) <= 1e-6


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, 37, 5)))
    b = torch.from_numpy(rng.normal(size=(2, 37, 5)))
    h, want = torch.zeros(2, 5, dtype=a.dtype), []
    for i in range(37):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    assert torch.allclose(PRg.linear_scan(a, b), torch.stack(want, 1),
                          rtol=0, atol=1e-12)


def _ssm_cfg():
    return ModelConfig(name="t", family="ssm", num_layers=1, d_model=32,
                       n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=64,
                       head_dim=16, ssm=SSMConfig(d_state=8, headdim=16,
                                                  expand=2, chunk=8))


def test_mamba2_block_matches_reference():
    """Full sequence (T=20: chunks of 8, the last padded), then one decode
    step; worst 1.6e-6."""
    cfg = _ssm_cfg()
    pj, pt = _ref_params(RMa.mamba2_init, cfg, cfg.ssm)
    # non-zero decay/skip parameters, so every term is exercised
    rng = np.random.default_rng(1)
    for name in ("A_log", "dt_bias", "D", "norm_w", "conv_b"):
        v = rng.normal(size=pj[name].shape) * 0.3
        pj[name] = _j(v)
        getattr(pt, name).copy_(_t(v))
    pcfg = _port_cfg(cfg)
    x = rng.normal(size=(2, 20, 32))
    ry, rs, rtail = jax.jit(lambda p, x: RMa.mamba2_forward(
        p, x, cfg, cfg.ssm))(pj, _j(x))
    y, s, tail = PMa.mamba2_forward(pt, _t(x), pcfg, pcfg.ssm)
    assert _err(y, ry) <= 1e-5 and _err(s, rs) <= 1e-5 and _err(tail, rtail) <= 1e-6
    x1 = rng.normal(size=(2, 1, 32))
    ry1, rs1, rt1 = jax.jit(lambda *a: RMa.mamba2_decode(
        *a, cfg, cfg.ssm))(pj, _j(x1), rs, rtail)
    y1, s1, t1 = PMa.mamba2_decode(pt, _t(x1), s, tail, pcfg, pcfg.ssm)
    assert _err(y1, ry1) <= 1e-5 and _err(s1, rs1) <= 1e-5 and _err(t1, rt1) == 0


# ------------------------------------------------------------- MLA / MoE
def test_mla_matches_reference():
    """Full-sequence MLA, then the absorbed decode against the latent cache
    the forward returned (written at position T); worst 1.2e-6."""
    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=64,
                      mla=MLAConfig(kv_lora_rank=16, rope_head_dim=8,
                                    nope_head_dim=8, v_head_dim=8))
    pj, pt = _ref_params(RMla.mla_init, cfg, cfg.mla)
    pcfg = _port_cfg(cfg)
    rng = np.random.default_rng(0)
    t = 12
    x = rng.normal(size=(2, t, 32))
    pos = np.arange(t, dtype=np.int32)
    ry, (rckv, rkr) = jax.jit(lambda p, x, pos: RMla.mla_forward(
        p, x, pos, cfg, cfg.mla))(pj, _j(x), jnp.asarray(pos))
    y, (ckv, kr) = PMla.mla_forward(pt, _t(x), torch.from_numpy(pos), pcfg, pcfg.mla)
    assert _err(y, ry) <= 1e-5 and _err(ckv, rckv) <= 1e-5 and _err(kr, rkr) <= 1e-5
    x1 = rng.normal(size=(2, 1, 32))
    cur = np.array([t, t], np.int32)
    _, _, ckv1, kr1 = jax.jit(lambda p, x, pos: RMla._project(
        p, x, pos, cfg.mla, cfg.norm_eps))(pj, _j(x1), jnp.asarray(cur)[:, None])
    cache_c = jnp.concatenate([rckv, ckv1], 1)
    cache_k = jnp.concatenate([rkr, kr1], 1)
    ry1, _ = jax.jit(lambda *a: RMla.mla_decode(*a, cfg, cfg.mla))(
        pj, _j(x1), cache_c, cache_k, jnp.asarray(cur) + 1,
        jnp.asarray(cur)[:, None])
    y1, _ = PMla.mla_decode(pt, _t(x1), _t(np.asarray(cache_c)),
                            _t(np.asarray(cache_k)), torch.from_numpy(cur) + 1,
                            torch.from_numpy(cur)[:, None], pcfg, pcfg.mla)
    assert _err(y1, ry1) <= 1e-5


def _ref_moe(cfg):
    return jax.jit(lambda p, x: RMoe.moe_apply(p, x, cfg, cfg.moe))


def _moe_cfg(act="swiglu", cf=1.25, shared=1, e=8, k=2):
    return ModelConfig(name="t", family="moe", num_layers=1, d_model=32,
                       n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=64, act=act,
                       moe=MoEConfig(num_experts=e, top_k=k, d_expert=24,
                                     num_shared=shared, d_shared=16,
                                     capacity_factor=cf))


@pytest.mark.parametrize("act,cf,shared", [
    ("swiglu", 1.25, 1),    # capacity 4 of 16 slots: tokens drop
    ("swiglu", 8.0, 0),     # nothing drops
    ("gelu", 0.5, 0),       # capacity 3: most tokens drop
])
def test_moe_matches_reference(act, cf, shared):
    """Routing, top-k, stable expert sort, capacity drops, combine, the
    shared expert and the load-balance loss; worst 2.9e-6."""
    cfg = _moe_cfg(act, cf, shared)
    pj, pt = _ref_params(RMoe.moe_init, cfg, cfg.moe)
    pcfg = _port_cfg(cfg)
    x = np.random.default_rng(2).normal(size=(3, 16, 32))
    ry, raux = _ref_moe(cfg)(pj, _j(x))
    y, aux = PMoe.moe_apply(pt, _t(x), pcfg, pcfg.moe)
    assert _err(y, ry) <= 1e-5
    assert abs(float(aux) - float(raux)) <= 1e-6


def test_moe_ties_route_to_the_lower_expert():
    """A zero router makes every expert tie: ``lax.top_k`` takes the lowest
    indices, and so must the port, or capacity drops other tokens."""
    cfg = _moe_cfg(cf=1.0, shared=0)
    pj, pt = _ref_params(RMoe.moe_init, cfg, cfg.moe)
    pj["router"] = jnp.zeros_like(pj["router"])
    pt.router.zero_()
    pcfg = _port_cfg(cfg)
    x = np.random.default_rng(4).normal(size=(2, 16, 32))
    ry, _ = _ref_moe(cfg)(pj, _j(x))
    y, _ = PMoe.moe_apply(pt, _t(x), pcfg, pcfg.moe)
    assert _err(y, ry) <= 1e-5
    vals, idx = PMoe.top_k_lower_index(torch.full((5, 8), 0.125), 3)
    assert idx.tolist() == [[0, 1, 2]] * 5


def test_moe_matches_reference_in_bf16():
    """The same bf16 input through both MoE layers: every output within
    2^-6 of the largest (two bf16 ulps of it; measured: 0.125 at 17).
    The bf16 model tests lean on this: a routing flip there comes from
    rounding upstream of the layer, not from the dispatch."""
    cfg = _moe_cfg(cf=8.0)
    pj, pt = _ref_params(RMoe.moe_init, cfg, cfg.moe)
    pcfg = _port_cfg(cfg)
    x = np.random.default_rng(5).normal(size=(2, 16, 32))
    ry, _ = _ref_moe(cfg)(pj, _j(x, jnp.bfloat16))
    y, _ = PMoe.moe_apply(pt, _t(x, torch.bfloat16), pcfg, pcfg.moe)
    assert y.dtype == torch.bfloat16
    assert _err(y, ry) <= 2 ** -6 * float(np.abs(_np(ry)).max())
