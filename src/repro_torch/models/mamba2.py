"""Mamba-2 (SSD — state-space duality) blocks, chunk-parallel — the port of
``repro.models.mamba2``.

The SSD algorithm splits the sequence into chunks: intra-chunk terms are
dense contractions (quadratic in the chunk) and inter-chunk terms a short
scan over chunk states, O(T·chunk) in all. Decode keeps the O(1) recurrent
state [H, P, N] plus a (conv_width-1)-deep conv tail.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain, merged, row_local, split_last
from .config import ModelConfig, SSMConfig
from .layers import delay, rms_normalized, tail


def dims(cfg: ModelConfig, s: SSMConfig):
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def mamba2_init(b, cfg: ModelConfig, s: SSMConfig):
    d = cfg.d_model
    d_inner, n_heads, conv_dim = dims(cfg, s)
    b.dense("in_proj", (d, 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads),
            ("embed", "rnn"))
    b.dense("conv_w", (s.conv_width, conv_dim), (None, "rnn"), scale=s.conv_width ** -0.5)
    b.zeros("conv_b", (conv_dim,), ("rnn",))
    b.zeros("A_log", (n_heads,), (None,))        # A = -exp(A_log)
    b.zeros("dt_bias", (n_heads,), (None,))
    b.zeros("D", (n_heads,), (None,))
    b.zeros("norm_w", (d_inner,), ("rnn",))
    b.dense("out_proj", (d_inner, d), ("rnn", "embed"))
    return b


def _split_proj(z_x_bc_dt, cfg, s):
    d_inner, n_heads, _ = dims(cfg, s)
    gn = s.n_groups * s.d_state
    z = z_x_bc_dt[..., :d_inner]
    xbc = z_x_bc_dt[..., d_inner:d_inner + d_inner + 2 * gn]
    dt = z_x_bc_dt[..., -n_heads:]
    return z, xbc, dt


def _gated_norm(y, z, w, eps: float):
    """``rms_norm(y * silu(z), w)`` [B, T, d_inner]. On a mesh the product
    gets ``d_inner`` whole and the normalization runs on each rank's rows
    (``row_local``), the weight after it: DTensor's own norm (torch 2.11)
    makes its square's backward add a partial and a split gradient, which
    it cannot (ROADMAP C11). The same ops in the same order as
    :func:`~.layers.rms_norm`."""
    g = constrain(y * F.silu(z), ("batch", None, None))
    return row_local(rms_normalized, 1)(g, eps) * (1.0 + w.to(g.dtype))


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv via shift-adds (width is tiny)."""
    kw = w.shape[0]
    out = xbc * w[kw - 1]
    for i in range(1, kw):
        out = out + delay(xbc, i) * w[kw - 1 - i]
    return F.silu(out + bias)


def _segsum(x):
    """[..., L] -> [..., L, L] lower-triangular segment sums (log-space)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_scan(xh, dtA, b_mat, c_mat, chunk: int, init_state=None):
    """Chunked SSD. xh [B,T,H,P] (already dt-scaled), dtA [B,T,H] (log decay),
    b_mat/c_mat [B,T,N] (single group); fp32 throughout. Returns (y
    [B,T,H,P], final_state [B,H,P,N])."""
    bsz, t, h, p = xh.shape
    n = b_mat.shape[-1]
    q = min(chunk, t)
    tp = -(-t // q) * q
    pad = tp - t
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = tp // q
    xc = xh.reshape(bsz, nc, q, h, p)
    ac = dtA.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)          # [B,H,C,L]
    bc = b_mat.reshape(bsz, nc, q, n)
    cc = c_mat.reshape(bsz, nc, q, n)

    a_cum = torch.cumsum(ac, dim=-1)                             # [B,H,C,L]
    # 1) intra-chunk (diagonal): L = exp(segsum(A))
    l_mat = torch.exp(_segsum(ac))                               # [B,H,C,L,L]
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", cb, l_mat, xc)
    # 2) per-chunk end states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)            # [B,H,C,L]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)
    # 3) inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(a_cum[..., -1])                      # [B,H,C]
    s_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
              if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # [B,C,H,P,N]
    # 4) state -> output contribution
    state_decay = torch.exp(a_cum)                               # [B,H,C,L]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(bsz, tp, h, p)[:, :t]
    return y, s_prev


def mamba2_forward(p, x, cfg: ModelConfig, s: SSMConfig):
    """Full-sequence SSD block. x [B,T,d] -> (y, final_state, conv_tail)."""
    dt_ = x.dtype
    d_inner, n_heads, conv_dim = dims(cfg, s)
    proj = x @ p["in_proj"].to(dt_)
    z, xbc_raw, dt_raw = _split_proj(proj, cfg, s)
    # last (W-1) pre-conv inputs: the decode-time conv window tail
    w = s.conv_width
    conv_tail = tail(xbc_raw, w - 1)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    gn = s.n_groups * s.d_state
    xs = xbc[..., :d_inner]
    b_mat = xbc[..., d_inner:d_inner + gn]
    c_mat = xbc[..., d_inner + gn:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())                           # [H]
    dta = dt * a                                                 # [B,T,H]
    xh = split_last(xs, n_heads, s.headdim)
    xh_dt = xh.float() * dt[..., None]
    # the scan is row-local; on a mesh each rank scans its own rows (its
    # cumsum's backward, a flip, has no DTensor strategy under torch 2.11)
    y, final = row_local(ssd_scan, 2)(xh_dt, dta, b_mat.float(),
                                      c_mat.float(), s.chunk)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = merged(y, 2, 3).to(dt_)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), final, conv_tail


def _ssm_step(state, xh, b_mat, c_mat, dt, decay):
    """One recurrent step of the SSD state [B,H,P,N] and its readout
    [B,H,P]. Row-local: on a mesh each rank steps its own rows (DTensor's
    contractions here flatten a split head dim under a row split over two
    mesh axes, which torch 2.11 refuses on the multi-pod mesh)."""
    state_new = (state * decay[..., None, None]
                 + torch.einsum("bhp,bn,bh->bhpn", xh, b_mat, dt))
    return torch.einsum("bhpn,bn->bhp", state_new, c_mat), state_new


def mamba2_decode(p, x, state, conv_tail, cfg: ModelConfig, s: SSMConfig):
    """One-token recurrent step. x [B,1,d]; state [B,H,P,N]; conv_tail
    [B,conv_width-1,conv_dim]. Returns (y [B,1,d], state', conv_tail')."""
    dt_ = x.dtype
    d_inner, n_heads, conv_dim = dims(cfg, s)
    proj = x @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = _split_proj(proj, cfg, s)                   # [B,1,*]
    # conv over (tail ++ current)
    window = torch.cat([conv_tail, xbc], dim=1)                  # [B,W,convdim]
    w = p["conv_w"].to(dt_)
    conv_out = torch.einsum("bwc,wc->bc", window, w) + p["conv_b"].to(dt_)
    xbc1 = F.silu(conv_out)[:, None]
    new_tail = window[:, 1:]
    gn = s.n_groups * s.d_state
    xs = xbc1[..., :d_inner]
    b_mat = xbc1[..., d_inner:d_inner + gn].float()[:, 0]        # [B,N]
    c_mat = xbc1[..., d_inner + gn:].float()[:, 0]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())[:, 0]  # [B,H]
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * a)                                    # [B,H]
    xh = split_last(xs, n_heads, s.headdim)[:, 0].float()        # [B,H,P]
    y, state_new = row_local(_ssm_step, 2)(state, xh, b_mat, c_mat, dt,
                                           decay)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(-1, 1, d_inner).to(dt_)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), state_new, new_tail
