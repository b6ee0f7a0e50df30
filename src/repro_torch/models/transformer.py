"""Composable decoder stack covering the dense / MoE / SSM / hybrid / VLM
families — the port of ``repro.models.transformer`` (whisper's
encoder-decoder lives in whisper.py on the same block machinery).

An architecture is a (prefix, pattern × groups, suffix) list of
``BlockSpec(attn, mlp)``. The stack is an ``nn.Module``
(:class:`LMStack`): the pattern groups are an ``nn.ModuleList`` named
``blocks`` (group ``g``'s block ``j`` is ``blocks.{g}.b{j}``), beside
``prefix{i}``/``suffix{i}`` blocks, ``embed``, ``final_norm`` and
``lm_head`` (``repro_torch.models.params`` gives the path rule onto the
reference's stacked tree). The groups run in a Python loop, so the
reference's ``lax.scan`` (``scan_layers``) has no counterpart. ``remat``
has: while autograd records a cache-free forward (training), each pattern
group runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps
only the group's input and recomputes its body in the backward pass, the
reference's ``jax.checkpoint(..., nothing_saveable)`` around its scanned
group body. Serving (``inference_mode``, or caches given) is unchanged.

Modes: ``full`` (train forward / prefill with cache fill) and ``decode``
(one token against caches). Caches keep the reference's tree layout —
``prefix{i}``, ``blocks`` with every leaf stacked on a leading group dim,
``suffix{i}``, ``cur_len`` — and are written **in place**: prefill and
decode store into the cache tensors they are given and return the tree
with a new ``cur_len``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import (activation_rules, block_of, constrain,
                                 current_rules, grad_as_placed, on_mesh,
                                 placements, redistribute, spec_for_array,
                                 write_rows, write_seq)
from .config import ModelConfig
from .params import ParamBuilder, ParamTree, dtype_of, map_axes, tree_map
from . import layers as L
from .layers import merge_heads, proj_heads
from .moe import moe_init, moe_apply
from .mla import mla_init, mla_forward, mla_decode, project as mla_project
from .mamba2 import mamba2_init, mamba2_forward, mamba2_decode, dims as ssm_dims
from .rglru import rglru_init, rglru_forward, rglru_decode


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    attn: str   # global | local | mla | ssd | rec | cross | enc
    mlp: str    # dense | moe | none

    @property
    def key(self) -> str:
        return f"{self.attn}_{self.mlp}"


def arch_blocks(cfg: ModelConfig):
    """(prefix, pattern, n_groups, suffix) of BlockSpecs for a config."""
    if cfg.family == "ssm":
        return [], [BlockSpec("ssd", "none")], cfg.num_layers, []
    if cfg.family == "hybrid":
        pat = [BlockSpec("rec", "dense"), BlockSpec("rec", "dense"),
               BlockSpec("local", "dense")]
        n = cfg.num_layers // len(pat)
        rest = cfg.num_layers - n * len(pat)
        suffix = [BlockSpec("rec", "dense")] * rest
        return [], pat, n, suffix
    if cfg.family == "vlm":
        v = cfg.vlm
        pat = [BlockSpec("global", "dense")] * (v.cross_every - 1) \
            + [BlockSpec("cross", "dense")]
        assert cfg.num_layers % v.cross_every == 0
        return [], pat, cfg.num_layers // v.cross_every, []
    if cfg.family == "moe":
        attn = "mla" if cfg.mla is not None else "global"
        nd = cfg.moe.first_dense_layers
        prefix = [BlockSpec(attn, "dense")] * nd
        return prefix, [BlockSpec(attn, "moe")], cfg.num_layers - nd, []
    # dense
    if cfg.layer_pattern == "local_global":
        pat = [BlockSpec("local", "dense"), BlockSpec("global", "dense")]
        assert cfg.num_layers % 2 == 0
        return [], pat, cfg.num_layers // 2, []
    return [], [BlockSpec("global", "dense")], cfg.num_layers, []


# ------------------------------------------------------------------ init
def attn_init(b: ParamBuilder, cfg: ModelConfig, kv_axis="kv_heads"):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b.dense("wq", (d, h, hd), ("embed", "heads", None))
    b.dense("wk", (d, kh, hd), ("embed", kv_axis, None))
    b.dense("wv", (d, kh, hd), ("embed", kv_axis, None))
    b.dense("wo", (h, hd, d), ("heads", None, "embed"))
    if cfg.qk_norm:
        b.zeros("q_norm", (hd,), (None,))
        b.zeros("k_norm", (hd,), (None,))
    return b


def _cross_init(b: ParamBuilder, cfg: ModelConfig):
    attn_init(b, cfg)
    b.zeros("gate_attn", (), ())
    b.zeros("gate_mlp", (), ())
    return b


def block_init(b: ParamBuilder, cfg: ModelConfig, spec: BlockSpec):
    d = cfg.d_model
    b.zeros("ln1", (d,), ("embed",))
    if spec.attn in ("global", "local", "enc"):
        attn_init(b.child("attn"), cfg)
    elif spec.attn == "cross":
        b.zeros("ln_cross", (d,), ("embed",))
        _cross_init(b.child("cross"), cfg)
        attn_init(b.child("attn"), cfg)
    elif spec.attn == "mla":
        mla_init(b.child("attn"), cfg, cfg.mla)
    elif spec.attn == "ssd":
        mamba2_init(b.child("attn"), cfg, cfg.ssm)
    elif spec.attn == "rec":
        rglru_init(b.child("attn"), cfg, cfg.rglru)
    else:
        raise ValueError(spec.attn)
    if cfg.post_norms and spec.attn not in ("ssd",):
        b.zeros("ln1_post", (d,), ("embed",))
    if spec.mlp != "none":
        b.zeros("ln2", (d,), ("embed",))
        if spec.mlp == "moe":
            moe_init(b.child("mlp"), cfg, cfg.moe)
        else:
            dff = cfg.d_ff
            if cfg.moe is not None and cfg.moe.first_dense_d_ff:
                dff = cfg.moe.first_dense_d_ff
            L.mlp_init(b.child("mlp"), d, dff, cfg.act)
        if cfg.post_norms:
            b.zeros("ln2_post", (d,), ("embed",))
    return b


class LMStack(ParamTree):
    """The decoder stack of every family but ``encdec``, as an
    ``nn.Module``; ``stack(tokens, ...)`` is :func:`forward`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, tokens, *, image_embeds=None, caches=None):
        return forward(self.cfg, self, tokens, image_embeds=image_embeds,
                       caches=caches)


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator], device):
    """Build (LMStack, axes); ``device="meta"`` is abstract (shapes only)."""
    b = ParamBuilder(generator, device, dtype_of(cfg.param_dtype),
                     node=LMStack(cfg))
    # embed std = d^-1/2: keeps tied logits ~unit-std (inputs re-scaled by
    # sqrt(d) when emb_scale is set, the gemma convention)
    b.dense("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
            scale=cfg.d_model ** -0.5)
    prefix, pattern, n_groups, suffix = arch_blocks(cfg)
    for i, spec in enumerate(prefix):
        block_init(b.child(f"prefix{i}"), cfg, spec)
    b.stacked_child(
        "blocks", n_groups,
        lambda bb: [block_init(bb.child(f"b{j}"), cfg, s)
                    for j, s in enumerate(pattern)])
    for i, spec in enumerate(suffix):
        block_init(b.child(f"suffix{i}"), cfg, spec)
    b.zeros("final_norm", (cfg.d_model,), ("embed",))
    if not cfg.tie_embeddings:
        b.dense("lm_head", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return b.build()


# ------------------------------------------------------------------ apply
def attn_full(p, cfg, x, positions, spec, cache=None, *, causal=True):
    """Self attention over a full sequence; optionally fills a cache."""
    dt = x.dtype
    # gather the sequence-parallel residual once here (Megatron-SP style),
    # not inside the attention chunk loops
    x = constrain(x, ("batch", None, None))
    q = proj_heads(x, p["wq"].to(dt))
    k = proj_heads(x, p["wk"].to(dt))
    v = proj_heads(x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if spec.attn != "enc":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    if spec.attn == "local" and cfg.local_window:
        out = L.local_attention(q, k, v, window=cfg.local_window,
                                q_positions=positions, softcap=cfg.attn_softcap)
    else:
        out = L.flash_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            causal=causal, softcap=cfg.attn_softcap)
    out = constrain(out, ("batch", None, "heads", None))
    if cache is not None:
        _fill_kv_cache(cache, k, v, cfg, spec)
    return merge_heads(out, p["wo"].to(dt))


def _fill_kv_cache(cache, k, v, cfg, spec):
    t = k.shape[1]
    if spec.attn == "local" and cfg.local_window:
        w = cache["k"].shape[1]
        tail_k, tail_v = k[:, -w:], v[:, -w:]
        start = max(0, t - w)
        slots = (start + torch.arange(tail_k.shape[1], device=k.device)) % w
        write_seq(cache["k"], tail_k, slots)
        write_seq(cache["v"], tail_v, slots)
    else:
        write_seq(cache["k"], k)
        write_seq(cache["v"], v)


def attn_decode(p, cfg, x, cache, cur_len, spec):
    """Single-token attention against a cache (ring buffer for local)."""
    dt = x.dtype
    positions = cur_len[:, None]
    q = proj_heads(x, p["wq"].to(dt))
    k = proj_heads(x, p["wk"].to(dt))
    v = proj_heads(x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if spec.attn != "enc":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    if spec.attn == "local" and cfg.local_window:
        w = kc.shape[1]
        slot = cur_len.long() % w
        write_rows(kc, slot, k[:, 0])
        write_rows(vc, slot, v[:, 0])
        # position held by ring slot j after writing position cur_len
        slots = torch.arange(w, device=x.device)
        pos_of_slot = cur_len[:, None] - ((cur_len[:, None] - slots[None]) % w)
        out = _ring_attention(q, kc, vc, pos_of_slot, cur_len, cfg.attn_softcap)
    else:
        write_rows(kc, cur_len, k[:, 0])
        write_rows(vc, cur_len, v[:, 0])
        out = L.cache_attention(q, kc, vc, cur_len=cur_len + 1,
                                softcap=cfg.attn_softcap)
    return merge_heads(out, p["wo"].to(dt))


def _ring_attention(q, kc, vc, pos_of_slot, cur_len, softcap):
    """cache_attention over a ring buffer whose slot->position map varies."""
    valid = (pos_of_slot >= 0) & (pos_of_slot <= cur_len[:, None])
    return L.attend_cache(q, kc, vc, valid, softcap=softcap)


def _cross_attn(p, cfg, x, img_kv):
    """Gated cross attention to (precomputed) image K/V."""
    dt = x.dtype
    q = proj_heads(x, p["wq"].to(dt))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = img_kv
    tq = x.shape[1]
    out = L.flash_attention(
        q, k, v,
        q_positions=torch.arange(tq, dtype=torch.int32, device=x.device),
        kv_positions=torch.zeros((k.shape[1],), dtype=torch.int32,
                                 device=x.device),
        causal=False)
    return merge_heads(out, p["wo"].to(dt))


def _image_kv(p, cfg, image_embeds):
    dt = image_embeds.dtype
    k = proj_heads(image_embeds, p["wk"].to(dt))
    v = proj_heads(image_embeds, p["wv"].to(dt))
    if cfg.qk_norm:
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def residual(x, y):
    """``x + y``, the residual add of a block's output ``y``. On a mesh the
    backward brings ``y``'s gradient to ``y``'s own placements first: the
    residual stream is split on seq, and DTensor cannot flatten (batch,
    seq) with seq split in the backward of the matmul that made ``y``."""
    return x + grad_as_placed(y)


def mlp_part(p, cfg, spec, x):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp == "none":
        return x, aux
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.mlp == "moe":
        y, aux = moe_apply(p["mlp"], constrain(h, ("batch", None, None)), cfg,
                           cfg.moe)
    else:
        hh = constrain(h, ("batch", None, None))
        y = L.mlp_apply(L.cast_weights(p["mlp"], x.dtype), hh, cfg.act)
    if cfg.post_norms:
        y = L.rms_norm(y, p["ln2_post"], cfg.norm_eps)
    return residual(x, y), aux


def block_apply_full(p, cfg: ModelConfig, spec: BlockSpec, x, positions,
                     cache=None, image_kv=None):
    """Train/prefill block. Returns (x, aux); a given cache is filled in
    place."""
    # every block input meets a matmul, which flattens (batch, seq): the
    # sequence-parallel residual is gathered here (DTensor cannot flatten
    # an inner dim that is split)
    h = constrain(L.rms_norm(x, p["ln1"], cfg.norm_eps), ("batch", None, None))
    if spec.attn in ("global", "local", "enc"):
        y = attn_full(p["attn"], cfg, h, positions, spec,
                      cache=cache, causal=(spec.attn != "enc"))
    elif spec.attn == "cross":
        y = attn_full(p["attn"], cfg, h, positions, spec, cache=cache)
        if cfg.post_norms:
            y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
        x = residual(x, y)
        hc = constrain(L.rms_norm(x, p["ln_cross"], cfg.norm_eps),
                       ("batch", None, None))
        yc = _cross_attn(p["cross"], cfg, hc, image_kv)
        gate = torch.tanh(p["cross"]["gate_attn"].to(x.dtype))
        x = residual(x, gate * yc)
        return mlp_part(p, cfg, spec, x)
    elif spec.attn == "mla":
        y, (ckv, kr) = mla_forward(p["attn"], h, positions, cfg, cfg.mla)
        if cache is not None:
            write_seq(cache["ckv"], ckv)
            write_seq(cache["kr"], kr)
    elif spec.attn == "ssd":
        y, state, tail = mamba2_forward(p["attn"], h, cfg, cfg.ssm)
        if cache is not None:
            cache["state"].copy_(state)
            cache["conv"].copy_(tail)
        return residual(x, y), torch.zeros((), dtype=torch.float32,
                                           device=x.device)
    elif spec.attn == "rec":
        y, state, tail = rglru_forward(p["attn"], h, cfg, cfg.rglru)
        if cache is not None:
            cache["state"].copy_(state)
            cache["conv"].copy_(tail)
    else:
        raise ValueError(spec.attn)
    if cfg.post_norms:
        y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    return mlp_part(p, cfg, spec, residual(x, y))


def block_apply_decode(p, cfg: ModelConfig, spec: BlockSpec, x, cache, cur_len,
                       image_kv=None):
    """One-token block; updates ``cache`` in place. Returns x."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.attn in ("global", "local", "enc"):
        y = attn_decode(p["attn"], cfg, h, cache, cur_len, spec)
    elif spec.attn == "cross":
        y = attn_decode(p["attn"], cfg, h, cache["self"], cur_len, spec)
        if cfg.post_norms:
            y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
        x = x + y
        hc = L.rms_norm(x, p["ln_cross"], cfg.norm_eps)
        yc = _cross_attn(p["cross"], cfg, hc, (cache["img_k"], cache["img_v"]))
        x = x + torch.tanh(p["cross"]["gate_attn"].to(x.dtype)) * yc
        return mlp_part(p, cfg, spec, x)[0]
    elif spec.attn == "mla":
        # write this step's latent into the cache first
        positions = cur_len[:, None]
        _, _, ckv, kr = mla_project(p["attn"], h, positions, cfg.mla,
                                    cfg.norm_eps)
        write_rows(cache["ckv"], cur_len, ckv[:, 0])
        write_rows(cache["kr"], cur_len, kr[:, 0])
        y, _ = mla_decode(p["attn"], h, cache["ckv"], cache["kr"], cur_len + 1,
                          positions, cfg, cfg.mla)
    elif spec.attn == "ssd":
        y, state, tail = mamba2_decode(p["attn"], h, cache["state"],
                                       cache["conv"], cfg, cfg.ssm)
        cache["state"].copy_(state)
        cache["conv"].copy_(tail)
        return x + y
    elif spec.attn == "rec":
        y, state, tail = rglru_decode(p["attn"], h, cache["state"],
                                      cache["conv"], cfg, cfg.rglru)
        cache["state"].copy_(state)
        cache["conv"].copy_(tail)
    else:
        raise ValueError(spec.attn)
    if cfg.post_norms:
        y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    return mlp_part(p, cfg, spec, x + y)[0]


# ------------------------------------------------------------------ caches
def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def block_cache_spec(cfg: ModelConfig, spec: BlockSpec, batch: int, max_len: int):
    """Meta tensors (shape + dtype) + logical axes for one block's cache."""
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = dtype_of(cfg.dtype)
    if spec.attn in ("global", "enc"):
        s = {"k": _meta((batch, max_len, kh, hd), cdt),
             "v": _meta((batch, max_len, kh, hd), cdt)}
        a = {"k": ("cache_batch", "cache_seq", "kv_heads", None),
             "v": ("cache_batch", "cache_seq", "kv_heads", None)}
    elif spec.attn == "local":
        w = min(cfg.local_window, max_len)
        s = {"k": _meta((batch, w, kh, hd), cdt),
             "v": _meta((batch, w, kh, hd), cdt)}
        a = {"k": ("cache_batch", "cache_seq", "kv_heads", None),
             "v": ("cache_batch", "cache_seq", "kv_heads", None)}
    elif spec.attn == "cross":
        inner_s, inner_a = block_cache_spec(
            cfg, BlockSpec("global", spec.mlp), batch, max_len)
        ti = cfg.vlm.num_image_tokens
        s = {"self": inner_s,
             "img_k": _meta((batch, ti, kh, hd), cdt),
             "img_v": _meta((batch, ti, kh, hd), cdt)}
        a = {"self": inner_a,
             "img_k": ("cache_batch", None, "kv_heads", None),
             "img_v": ("cache_batch", None, "kv_heads", None)}
    elif spec.attn == "mla":
        m = cfg.mla
        s = {"ckv": _meta((batch, max_len, m.kv_lora_rank), cdt),
             "kr": _meta((batch, max_len, m.rope_head_dim), cdt)}
        a = {"ckv": ("cache_batch", "cache_seq", "kv_lora"),
             "kr": ("cache_batch", "cache_seq", None)}
    elif spec.attn == "ssd":
        d_inner, n_heads, conv_dim = ssm_dims(cfg, cfg.ssm)
        s = {"state": _meta((batch, n_heads, cfg.ssm.headdim, cfg.ssm.d_state),
                            torch.float32),
             "conv": _meta((batch, cfg.ssm.conv_width - 1, conv_dim), cdt)}
        a = {"state": ("cache_batch", None, None, None),
             "conv": ("cache_batch", None, "rnn")}
    elif spec.attn == "rec":
        dr = cfg.rglru.d_rnn or cfg.d_model
        s = {"state": _meta((batch, dr), torch.float32),
             "conv": _meta((batch, cfg.rglru.conv_width - 1, dr), cdt)}
        a = {"state": ("cache_batch", "rnn"),
             "conv": ("cache_batch", None, "rnn")}
    else:
        raise ValueError(spec.attn)
    return s, a


def stack_spec(shapes, axes, n: int):
    """A per-layer cache spec stacked on a leading group dim of ``n``."""
    return (tree_map(lambda x: _meta((n,) + tuple(x.shape), x.dtype), shapes),
            map_axes(lambda a: ("layers",) + tuple(a), axes))


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Abstract cache tree (meta tensors) + axes tree for the whole model."""
    prefix, pattern, n_groups, suffix = arch_blocks(cfg)
    shapes: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    for i, spec in enumerate(prefix):
        shapes[f"prefix{i}"], axes[f"prefix{i}"] = block_cache_spec(cfg, spec, batch, max_len)
    blk_s, blk_a = {}, {}
    for j, spec in enumerate(pattern):
        blk_s[f"b{j}"], blk_a[f"b{j}"] = stack_spec(
            *block_cache_spec(cfg, spec, batch, max_len), n_groups)
    shapes["blocks"], axes["blocks"] = blk_s, blk_a
    for i, spec in enumerate(suffix):
        shapes[f"suffix{i}"], axes[f"suffix{i}"] = block_cache_spec(cfg, spec, batch, max_len)
    shapes["cur_len"] = _meta((batch,), torch.int32)
    axes["cur_len"] = ("cache_batch",)
    return shapes, axes


def zeros_like_spec(shapes, device):
    """A zeroed cache tree on ``device`` from a :func:`cache_spec` tree."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                    shapes)


def group_view(tree, g: int):
    """Group ``g`` of a stacked cache tree: views, so writes land in it."""
    return tree_map(lambda a: a[g], tree)


# ------------------------------------------------------------------ model
def embed_tokens(cfg, params, tokens):
    # gather, then cast: elementwise, so equal to the reference's
    # cast-then-gather bit for bit, without casting the whole table
    x = L.lookup(params["embed"], tokens).to(dtype_of(cfg.dtype))
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _logits(cfg, params, x):
    x = constrain(L.rms_norm(x, params["final_norm"], cfg.norm_eps),
                  ("batch", None, None))
    # a tied table's gradient comes back on its own placements, as the
    # lookup's does: torch 2.11 cannot add the two otherwise
    head = (grad_as_placed(params["embed"]).T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head.to(x.dtype)
    logits = constrain(logits, ("batch", None, "vocab"))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def remat_body(cfg: ModelConfig, body, caches=None):
    """``body`` under a non-reentrant ``torch.utils.checkpoint`` (kept
    inputs only, the body recomputed in the backward pass) when
    ``cfg.remat`` is set, autograd records and no caches are filled;
    else ``body`` itself. The recompute runs in autograd's thread (its
    device thread on the card), so the sharding rules active now are
    re-entered there: the recomputed forward takes the same path."""
    if cfg.remat and caches is None and torch.is_grad_enabled():
        rules = current_rules()

        def under_rules(*args, **kwargs):
            with activation_rules(rules):
                return body(*args, **kwargs)
        return functools.partial(checkpoint, under_rules, use_reentrant=False)
    return body


def forward(cfg: ModelConfig, params, tokens, *, image_embeds=None,
            caches=None):
    """Full-sequence forward. Returns (logits, aux_loss, caches|None); a
    given cache tree is filled in place and returned with ``cur_len = T``."""
    prefix, pattern, n_groups, suffix = arch_blocks(cfg)
    t = tokens.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    x = constrain(x, ("batch", "seq", None))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        image_embeds = image_embeds.to(x.dtype)

    for i, spec in enumerate(prefix):
        c = caches[f"prefix{i}"] if caches is not None else None
        x, aux = block_apply_full(params[f"prefix{i}"], cfg, spec, x,
                                  positions, cache=c)
        aux_total = aux_total + aux

    def group_body(x, gp, gc):
        auxg = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, spec in enumerate(pattern):
            pj = gp[f"b{j}"]
            cj = gc[f"b{j}"] if gc is not None else None
            if spec.attn == "cross":
                ikv = _image_kv(pj["cross"], cfg, image_embeds)
                x, aux = block_apply_full(pj, cfg, spec, x, positions,
                                          cache=cj["self"] if cj else None,
                                          image_kv=ikv)
                if cj is not None:
                    cj["img_k"].copy_(ikv[0])
                    cj["img_v"].copy_(ikv[1])
            else:
                x, aux = block_apply_full(pj, cfg, spec, x, positions, cache=cj)
            x = constrain(x, ("batch", "seq", None))
            auxg = auxg + aux
        return x, auxg

    body = remat_body(cfg, group_body, caches)
    for g, gp in enumerate(params["blocks"]):
        gc = group_view(caches["blocks"], g) if caches is not None else None
        x, aux = body(x, gp, gc)
        aux_total = aux_total + aux

    for i, spec in enumerate(suffix):
        c = caches[f"suffix{i}"] if caches is not None else None
        x, aux = block_apply_full(params[f"suffix{i}"], cfg, spec, x,
                                  positions, cache=c)
        aux_total = aux_total + aux

    logits = _logits(cfg, params, x)
    new_caches = None
    if caches is not None:
        new_caches = dict(caches, cur_len=torch.full(
            (tokens.shape[0],), t, dtype=torch.int32, device=tokens.device))
    return logits, aux_total, new_caches


def chunked_xent(logits, labels, t_chunk: int = 512):
    """Mean next-token cross-entropy, chunked over the sequence so the fp32
    logit upcast never materializes [B, T, V]."""
    b, t, v = logits.shape
    tc = min(t_chunk, t)
    if t % tc:
        tc = t  # fall back for odd lengths (smoke shapes)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for s in range(0, t, tc):
        lg32 = logits[:, s:s + tc].float()
        logz = torch.logsumexp(lg32, dim=-1)
        gold = _gold(lg32, labels[:, s:s + tc])
        total = total + (logz - gold).sum()
    return total / (b * t)


def _gold(lg32, labels):
    """The logit of each label ``[B, T]``. On a mesh each rank gathers from
    the logits it holds (its rows, its stretch of the vocabulary) the
    labels that fall in it, and the ranks that split the vocabulary sum:
    DTensor's own gather would need the whole vocabulary on every rank,
    and its backward makes a zero tensor of the global batch on each (80
    GB at train_4k on 256 ranks)."""
    if not on_mesh(lg32):
        return torch.gather(lg32, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = lg32.device_mesh
    where = placements(spec_for_array(tuple(lg32.shape),
                                      ("batch", None, "vocab"),
                                      current_rules(), mesh), mesh)
    rows = tuple(p if p.is_shard(0) else Replicate() for p in where)
    summed = tuple(Partial() if p.is_shard(2) else q
                   for p, q in zip(where, rows))
    lo = block_of(tuple(lg32.shape), mesh, where)[1][2]

    def gather(lg, lab):
        rel = lab.long() - lo
        inside = (rel >= 0) & (rel < lg.shape[-1])
        got = torch.gather(lg, -1, rel.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(inside, got[..., 0], 0.0)

    return local_map(gather, out_placements=(summed,),
                     in_placements=(where, rows), device_mesh=mesh)(
        redistribute(lg32, where), redistribute(labels, rows))


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross-entropy (+ MoE aux); differentiable (the
    train step calls ``backward`` on it)."""
    logits, aux, _ = forward(cfg, params, batch["tokens"],
                             image_embeds=batch.get("image_embeds"))
    nll = chunked_xent(logits, batch["labels"])
    return nll + aux, {"nll": nll, "aux": aux}


def decode_step(cfg: ModelConfig, params, caches, tokens):
    """One decode step for the whole batch. tokens [B] int; caches include
    cur_len [B]. Returns (logits [B, vocab], caches with cur_len + 1); the
    cache tensors are updated in place."""
    prefix, pattern, n_groups, suffix = arch_blocks(cfg)
    cur_len = caches["cur_len"]
    x = embed_tokens(cfg, params, tokens[:, None])
    for i, spec in enumerate(prefix):
        x = block_apply_decode(params[f"prefix{i}"], cfg, spec, x,
                               caches[f"prefix{i}"], cur_len)
    for g, gp in enumerate(params["blocks"]):
        gc = group_view(caches["blocks"], g)
        for j, spec in enumerate(pattern):
            x = block_apply_decode(gp[f"b{j}"], cfg, spec, x, gc[f"b{j}"],
                                   cur_len)
    for i, spec in enumerate(suffix):
        x = block_apply_decode(params[f"suffix{i}"], cfg, spec, x,
                               caches[f"suffix{i}"], cur_len)
    logits = _logits(cfg, params, x)[:, 0]
    return logits, dict(caches, cur_len=cur_len + 1)
