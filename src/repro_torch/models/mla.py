"""Multi-head Latent Attention (DeepSeek-V2) with compressed KV cache and
weight-absorbed decode — the port of ``repro.models.mla``.

Train/prefill: queries get per-head nope+rope parts; keys/values are
up-projected from a rank-``kv_lora`` latent ``ckv`` (RMS-normed); a single
shared rope key head rides alongside. Decode caches only ``[ckv, k_rope]``
and absorbs the up-projections into the query/output paths, so the
per-step attention contracts directly against the latent cache.
"""
from __future__ import annotations

import torch

from .config import ModelConfig, MLAConfig
from .layers import (flash_attention, merge_heads, proj_heads, rms_norm,
                     rope as apply_rope)


def mla_init(b, cfg: ModelConfig, m: MLAConfig):
    d, h = cfg.d_model, cfg.n_heads
    b.dense("wq", (d, h, m.nope_head_dim + m.rope_head_dim), ("embed", "heads", None))
    b.dense("wdkv", (d, m.kv_lora_rank + m.rope_head_dim), ("embed", None))
    b.zeros("ckv_norm", (m.kv_lora_rank,), ("kv_lora",))
    b.dense("wukv", (m.kv_lora_rank, h, m.nope_head_dim + m.v_head_dim),
            ("kv_lora", "heads", None))
    b.dense("wo", (h, m.v_head_dim, d), ("heads", None, "embed"))
    return b


def project(p, x, positions, m: MLAConfig, eps: float):
    dt = x.dtype
    q = proj_heads(x, p["wq"].to(dt))
    qn, qr = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    qr = apply_rope(qr, positions)
    kv = x @ p["wdkv"].to(dt)
    ckv, kr = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    ckv = rms_norm(ckv, p["ckv_norm"], eps)
    kr = apply_rope(kr[:, :, None, :], positions)[:, :, 0]      # single rope head
    return qn, qr, ckv, kr


def mla_forward(p, x, positions, cfg: ModelConfig, m: MLAConfig):
    """Full-sequence MLA. Returns (out [B,T,d], (ckv, kr) for cache fill)."""
    dt = x.dtype
    qn, qr, ckv, kr = project(p, x, positions, m, cfg.norm_eps)
    kn_v = proj_heads(ckv, p["wukv"].to(dt))
    kn = kn_v[..., :m.nope_head_dim]
    v = kn_v[..., m.nope_head_dim:]
    h = cfg.n_heads
    k = torch.cat([kn, kr[:, :, None, :].expand(*qr.shape[:2], h,
                                                 m.rope_head_dim)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    attn = flash_attention(
        q, k, v, q_positions=positions, kv_positions=positions, causal=True,
        scale=(m.nope_head_dim + m.rope_head_dim) ** -0.5)
    out = merge_heads(attn, p["wo"].to(dt))
    return out, (ckv, kr)


def mla_decode(p, x, ckv_cache, kr_cache, cur_len, positions,
               cfg: ModelConfig, m: MLAConfig):
    """One-token decode against the compressed latent cache (absorbed form).

    x: [B, 1, d]; ckv_cache: [B, S, r]; kr_cache: [B, S, dr].
    Caller has already written this step's (ckv, kr) into the caches.
    """
    dt = x.dtype
    qn, qr, ckv_new, kr_new = project(p, x, positions, m, cfg.norm_eps)
    wukv = p["wukv"].to(dt)
    wuk = wukv[..., :m.nope_head_dim]                       # [r, H, dn]
    wuv = wukv[..., m.nope_head_dim:]                       # [r, H, dv]
    # absorb k up-projection into the query
    q_lat = torch.einsum("bqhd,rhd->bqhr", qn, wuk)         # [B,1,H,r]
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv_cache.float())
              + torch.einsum("bqhe,bse->bhqs", qr.float(),
                             kr_cache.float())) * scale
    s = ckv_cache.shape[1]
    valid = torch.arange(s, device=x.device)[None, :] < cur_len[:, None]
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhqs,bsr->bqhr", probs.to(dt), ckv_cache)
    vout = torch.einsum("bqhr,rhv->bqhv", lat, wuv)
    out = torch.einsum("bqhv,hvd->bqd", vout, p["wo"].to(dt))
    return out, (ckv_new, kr_new)
