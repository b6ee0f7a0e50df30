"""Mixture-of-Experts with sort-based dispatch (dropping, fixed capacity) —
the port of ``repro.models.moe``.

Tokens are sorted by assigned expert (per sequence row), scattered into a
dense ``[B, E, C, d]`` buffer the expert FFNs consume as one batched
einsum, and combined back with their router weights. The reference's
order is kept where it decides which tokens a full expert drops: top-k
breaks ties toward the lower expert index (a stable descending sort), and
the expert sort is stable. Dropped tokens (slot ``>= C``) go to a sink
slot that is cut off before the FFN and reads back as zero, as the
reference's ``mode="drop"`` scatter and ``mode="fill"`` gather do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain, row_local
from .config import ModelConfig, MoEConfig
from .layers import cast_weights, gelu, mlp_apply, mlp_init


def moe_init(b, cfg: ModelConfig, moe: MoEConfig):
    d = cfg.d_model
    e_axis = "experts" if moe.partition == "expert" else None
    f_axis = "expert_mlp" if moe.partition == "expert" else "mlp"
    b.dense("router", (d, moe.num_experts), ("embed", None), scale=d ** -0.5)
    b.dense("w_gate", (moe.num_experts, d, moe.d_expert), (e_axis, "embed", f_axis))
    b.dense("w_up", (moe.num_experts, d, moe.d_expert), (e_axis, "embed", f_axis))
    b.dense("w_down", (moe.num_experts, moe.d_expert, d), (e_axis, f_axis, "embed"))
    if moe.num_shared:
        mlp_init(b.child("shared"), d, moe.num_shared * moe.d_shared, cfg.act)
    return b


def top_k_lower_index(probs, k: int):
    """``lax.top_k``: the k largest along the last dim, ties toward the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x, probs, k: int, e: int, cap: int):
    """Route each row's tokens (top-k, renormalized) and scatter them into
    the ``[B, E, cap, d]`` expert buffer. Returns the buffer, the combine
    weights ``w·keep``, the sorted experts, slots and tokens (``[B, T*K]``)
    and the per-expert token counts ``[E]`` (float, for the aux loss).
    Row-local: on a mesh it runs on each rank's rows."""
    bsz, t, d = x.shape
    nk = t * k
    dev = x.device
    top_p, top_i = top_k_lower_index(probs, k)                    # [B, T, K]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # ---- row-local sort-based dispatch (all ops batched over B)
    flat_e = top_i.reshape(bsz, nk).to(torch.int64)               # [B, T*K]
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)[None].expand(bsz, nk)
    flat_w = top_p.reshape(bsz, nk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_s = torch.gather(flat_e, -1, order)
    t_s = torch.gather(flat_t, -1, order)
    w_s = torch.gather(flat_w, -1, order)
    seg_start = torch.searchsorted(
        e_s, torch.arange(e, device=dev)[None].expand(bsz, e).contiguous(),
        side="left")                                              # [B, E]
    pos = torch.arange(nk, device=dev)[None] - torch.gather(seg_start, -1, e_s)
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap)                           # cap -> dropped

    b_idx = torch.arange(bsz, device=dev)[:, None].expand(bsz, nk)
    x_disp = x[b_idx, t_s]                                        # [B, T*K, d]
    # The buffer stays expert-replicated (its inputs already are); the
    # E-sharded expert weights localize the FFN per model shard and only
    # the output buffer is gathered back. Slot ``cap`` is the drop sink:
    # written, then cut off.
    buf = torch.zeros((bsz, e, cap + 1, d), dtype=x.dtype, device=dev)
    buf[b_idx, e_s, pos_c] = x_disp
    # a fixed-shape count (bincount's output shape depends on the data);
    # every id is < e, so the counts are bincount's exactly
    ids = flat_e.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, ids, torch.ones_like(ids)).float()
    return buf[:, :, :cap], w_s * keep, e_s, pos_c, t_s, counts


def _combine(out_buf, wk, e_s, pos_c, t_s, t: int):
    """Gather each routed token's expert output back (zero for a dropped
    slot), weight it, and scatter-add it onto its token: ``[B, t, d]``."""
    bsz, _, _, d = out_buf.shape
    nk = e_s.shape[1]
    b_idx = torch.arange(bsz, device=out_buf.device)[:, None].expand(bsz, nk)
    out_pad = F.pad(out_buf, (0, 0, 0, 1))                        # [B, E, cap+1, d]
    gathered = out_pad[b_idx, e_s, pos_c]                         # [B, T*K, d]
    weighted = gathered * wk[..., None].to(out_buf.dtype)
    out = torch.zeros((bsz, t, d), dtype=out_buf.dtype, device=out_buf.device)
    out.index_put_((b_idx, t_s), weighted, accumulate=True)
    return out


def moe_apply(p, x, cfg: ModelConfig, moe: MoEConfig):
    """x: [B, T, d] -> ([B, T, d], aux_loss).

    Row-local dispatch: routing, sort, scatter and combine are batched per
    sequence row; capacity is per row, ``int(T*k/E*cf + 1)``; dropped tokens
    ride the residual.
    """
    bsz, t, d = x.shape
    e, k = moe.num_experts, moe.top_k
    nk = t * k
    cap = int(t * k / e * moe.capacity_factor + 1)
    dt = x.dtype

    logits = (x @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                         # [B, T, E]
    buf, wk, e_s, pos_c, t_s, counts = row_local(
        _dispatch, 6, summed=(5,))(x, probs, k, e, cap)
    buf = constrain(buf, ("batch", None, None, None))

    # ---- expert FFN (batched over rows x experts)
    wg = p["w_gate"].to(dt)
    wu = p["w_up"].to(dt)
    wd = p["w_down"].to(dt)
    if cfg.act == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) \
            * torch.einsum("becd,edf->becf", buf, wu)
    else:
        h = gelu(torch.einsum("becd,edf->becf", buf, wu))
    h = constrain(h, ("batch", "experts", None, None))
    out_buf = torch.einsum("becf,efd->becd", h, wd)
    out_buf = constrain(out_buf, ("batch", None, None, None))  # gather E back

    out = row_local(_combine, 1)(out_buf, wk, e_s, pos_c, t_s, t)

    if moe.num_shared:
        out = out + mlp_apply(cast_weights(p["shared"], dt), x, cfg.act)

    # ---- load-balance auxiliary loss (Switch-style, global means)
    frac_tokens = counts / (bsz * nk)
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs) * moe.router_aux_weight
    return out, aux
