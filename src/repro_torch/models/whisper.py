"""Whisper-style encoder-decoder backbone (conv frontend stubbed) — the port
of ``repro.models.whisper``.

The modality frontend is a STUB: the caller feeds precomputed mel-frame
embeddings [B, enc_seq, d_model] (what the two conv layers would produce).
Encoder: non-causal self-attention + GELU MLP. Decoder: causal
self-attention + cross-attention over the encoder output + GELU MLP.
Sinusoidal positions on both sides. Decode caches self K/V per layer plus
the per-layer cross K/V computed once at prefill; like the decoder stack's,
the caches keep the reference's tree (``blocks/b0/...`` stacked over
layers, ``cur_len``) and are written in place.

The stack is an ``nn.Module`` (:class:`EncDecStack`) with two
``nn.ModuleList``\\ s, ``enc_blocks`` and ``dec_blocks`` (layer ``g`` is
``enc_blocks.{g}.b0``), beside ``enc_norm``, ``embed`` and ``final_norm``.
Under ``cfg.remat``, while autograd records a cache-free forward, each
encoder and decoder block body runs under ``torch.utils.checkpoint``, as
the reference wraps both scanned bodies in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import constrain, grad_as_placed
from .config import ModelConfig
from .params import ParamBuilder, ParamTree, dtype_of
from . import layers as L
from .transformer import (
    BlockSpec, attn_init, attn_full, attn_decode, mlp_part, block_init,
    group_view, merge_heads, proj_heads, remat_body, residual, stack_spec,
    _meta,
)

_SELF = BlockSpec("enc", "dense")        # non-causal, no rope
_DEC_SELF = BlockSpec("global", "dense")  # causal


def _inv_freq(d: int, device):
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    log_base = torch.log(torch.tensor(10000.0, device=device))
    return torch.exp(-dim * (log_base / max(1, d // 2 - 1)))


def _sinusoid(t: int, d: int, dtype, device):
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid_at(positions, d, dtype):
    ang = positions[:, None].float() * _inv_freq(d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _dec_block_init(b: ParamBuilder, cfg: ModelConfig):
    d = cfg.d_model
    b.zeros("ln1", (d,), ("embed",))
    attn_init(b.child("attn"), cfg)
    b.zeros("ln_cross", (d,), ("embed",))
    attn_init(b.child("cross"), cfg)
    b.zeros("ln2", (d,), ("embed",))
    L.mlp_init(b.child("mlp"), d, cfg.d_ff, cfg.act)
    return b


class EncDecStack(ParamTree):
    """The encoder-decoder as an ``nn.Module``; ``stack(tokens, frames)``
    is :func:`forward`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, tokens, frames, *, caches=None):
        return forward(self.cfg, self, tokens, frames, caches=caches)


def init_encdec(cfg: ModelConfig, generator: Optional[torch.Generator], device):
    b = ParamBuilder(generator, device, dtype_of(cfg.param_dtype),
                     node=EncDecStack(cfg))
    e = cfg.encdec
    b.stacked_child("enc_blocks", e.enc_layers,
                    lambda bb: block_init(bb.child("b0"), cfg, _SELF))
    b.zeros("enc_norm", (cfg.d_model,), ("embed",))
    b.dense("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
            scale=cfg.d_model ** -0.5)
    b.stacked_child("dec_blocks", cfg.num_layers,
                    lambda bb: _dec_block_init(bb.child("b0"), cfg))
    b.zeros("final_norm", (cfg.d_model,), ("embed",))
    return b.build()


def encode(cfg: ModelConfig, params, frames):
    """frames: [B, enc_seq, d_model] (conv-stub output) -> [B, enc_seq, d]."""
    x = frames.to(dtype_of(cfg.dtype))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    x = constrain(x, ("batch", "seq", None))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    body = remat_body(cfg, _apply_enc)
    for gp in params["enc_blocks"]:
        x = constrain(body(gp["b0"], cfg, x, positions),
                      ("batch", "seq", None))
    # the decoder's cross projections flatten (batch, seq): gathered once
    return constrain(L.rms_norm(x, params["enc_norm"], cfg.norm_eps),
                     ("batch", None, None))


def _apply_enc(p, cfg, x, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y = attn_full(p["attn"], cfg, h, positions, _SELF, causal=False)
    x = residual(x, y)
    out, _ = mlp_part(p, cfg, _SELF, x)
    return out


def _apply_dec(p, cfg, x, positions, enc_out, cache=None):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y = attn_full(p["attn"], cfg, h, positions, _DEC_SELF,
                  cache=cache["self"] if cache else None)
    x = residual(x, y)
    hc = constrain(L.rms_norm(x, p["ln_cross"], cfg.norm_eps),
                   ("batch", None, None))
    dt = x.dtype
    q = proj_heads(hc, p["cross"]["wq"].to(dt))
    k = proj_heads(enc_out, p["cross"]["wk"].to(dt))
    v = proj_heads(enc_out, p["cross"]["wv"].to(dt))
    yc = L.flash_attention(
        q, k, v, q_positions=positions,
        kv_positions=torch.zeros((k.shape[1],), dtype=torch.int32,
                                 device=x.device),
        causal=False)
    x = residual(x, merge_heads(yc, p["cross"]["wo"].to(dt)))
    out, _ = mlp_part(p, cfg, _DEC_SELF, x)
    if cache is not None:
        cache["cross_k"].copy_(k)
        cache["cross_v"].copy_(v)
    return out


def _embed_dec(cfg, params, tokens, dt):
    x = L.lookup(params["embed"], tokens).to(dt)
    # match the d^-1/2 embed init
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)


def forward(cfg: ModelConfig, params, tokens, frames, caches=None):
    """Joint encoder+decoder forward. Returns (logits, aux=0, caches|None);
    a given cache tree is filled in place and returned with ``cur_len``."""
    enc_out = encode(cfg, params, frames)
    t = tokens.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    x = _embed_dec(cfg, params, tokens, dtype_of(cfg.dtype))
    x = x + _sinusoid(t, cfg.d_model, x.dtype, x.device)[None]
    x = constrain(x, ("batch", "seq", None))
    body = remat_body(cfg, _apply_dec, caches)
    for g, gp in enumerate(params["dec_blocks"]):
        gc = group_view(caches["blocks"], g) if caches is not None else None
        x = body(gp["b0"], cfg, x, positions, enc_out,
                 cache=gc["b0"] if gc else None)
        x = constrain(x, ("batch", "seq", None))
    x = constrain(L.rms_norm(x, params["final_norm"], cfg.norm_eps),
                  ("batch", None, None))
    # the tied table's gradient comes back on its own placements, as the
    # lookup's does (transformer._logits)
    logits = x @ grad_as_placed(params["embed"]).T.to(x.dtype)
    logits = constrain(logits, ("batch", None, "vocab"))
    new_caches = None
    if caches is not None:
        new_caches = dict(caches, cur_len=torch.full(
            (tokens.shape[0],), t, dtype=torch.int32, device=tokens.device))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), new_caches


def decode_step(cfg: ModelConfig, params, caches, tokens):
    """One decoder token against self+cross caches. tokens [B]."""
    cur_len = caches["cur_len"]
    dt = dtype_of(cfg.dtype)
    x = _embed_dec(cfg, params, tokens[:, None], dt)
    x = x + _sinusoid_at(cur_len, cfg.d_model, dt)[:, None]
    for g, gp in enumerate(params["dec_blocks"]):
        p, c = gp["b0"], group_view(caches["blocks"], g)["b0"]
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        y = attn_decode(p["attn"], cfg, h, c["self"], cur_len, _DEC_SELF)
        x = x + y
        hc = L.rms_norm(x, p["ln_cross"], cfg.norm_eps)
        q = proj_heads(hc, p["cross"]["wq"].to(x.dtype))
        enc_len = torch.full((x.shape[0],), c["cross_k"].shape[1],
                             dtype=torch.int32, device=x.device)
        yc = L.cache_attention(q, c["cross_k"], c["cross_v"], cur_len=enc_len)
        x = x + merge_heads(yc, p["cross"]["wo"].to(x.dtype))
        x, _ = mlp_part(p, cfg, _DEC_SELF, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["embed"].T.to(x.dtype))[:, 0]
    return logits, dict(caches, cur_len=cur_len + 1)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Abstract decoder cache tree (self KV + cross KV per layer)."""
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = dtype_of(cfg.dtype)
    e = cfg.encdec
    per = {
        "self": {"k": _meta((batch, max_len, kh, hd), cdt),
                 "v": _meta((batch, max_len, kh, hd), cdt)},
        "cross_k": _meta((batch, e.enc_seq, kh, hd), cdt),
        "cross_v": _meta((batch, e.enc_seq, kh, hd), cdt),
    }
    per_axes = {
        "self": {"k": ("cache_batch", "cache_seq", "kv_heads", None),
                 "v": ("cache_batch", "cache_seq", "kv_heads", None)},
        "cross_k": ("cache_batch", None, "kv_heads", None),
        "cross_v": ("cache_batch", None, "kv_heads", None),
    }
    s, a = stack_spec(per, per_axes, cfg.num_layers)
    return ({"blocks": {"b0": s}, "cur_len": _meta((batch,), torch.int32)},
            {"blocks": {"b0": a}, "cur_len": ("cache_batch",)})
