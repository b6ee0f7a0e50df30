"""RG-LRU recurrent blocks (RecurrentGemma / Griffin) — the port of
``repro.models.rglru``.

The temporal mix is a gated linear recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t).
The reference runs it with ``lax.associative_scan``; the port runs the same
associative combine as a log-step (Hillis-Steele) scan over time, in fp32:
the products associate in another order, so the two agree to fp32
rounding, not bit for bit. Decode is the O(1) single-step update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain
from .config import ModelConfig, RGLRUConfig
from .layers import delay, gelu, tail

_C = 8.0


def rglru_init(b, cfg: ModelConfig, r: RGLRUConfig):
    d = cfg.d_model
    dr = r.d_rnn or d
    b.dense("w_x", (d, dr), ("embed", "rnn"))
    b.dense("w_gate_branch", (d, dr), ("embed", "rnn"))
    b.dense("conv_w", (r.conv_width, dr), (None, "rnn"), scale=r.conv_width ** -0.5)
    b.zeros("conv_b", (dr,), ("rnn",))
    b.dense("w_r", (dr, dr), ("rnn", "rnn"))
    b.zeros("b_r", (dr,), ("rnn",))
    b.dense("w_i", (dr, dr), ("rnn", "rnn"))
    b.zeros("b_i", (dr,), ("rnn",))
    b.zeros("lambda_p", (dr,), ("rnn",))
    b.dense("w_out", (dr, d), ("rnn", "embed"))
    return b


def _gates(p, u):
    dt = u.dtype
    # the products are reduced before the bias joins them: DTensor (torch
    # 2.11) cannot add a split bias to a partial sum
    r_g = torch.sigmoid(constrain(u @ p["w_r"].to(dt), ("batch", None, "rnn"))
                        + p["b_r"].to(dt))
    i_g = torch.sigmoid(constrain(u @ p["w_i"].to(dt), ("batch", None, "rnn"))
                        + p["b_i"].to(dt))
    log_a = -_C * F.softplus(p["lambda_p"].float()) * r_g.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * (i_g.float() * u.float())


def _conv(p, u):
    w = p["conv_w"].to(u.dtype)
    kw = w.shape[0]
    out = u * w[kw - 1]
    for i in range(1, kw):
        out = out + delay(u, i) * w[kw - 1 - i]
    return out + p["conv_b"].to(u.dtype)


def linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` (h_{-1} = 0) along
    dim 1: the combine ``(a1, b1), (a2, b2) -> (a1*a2, b1*a2 + b2)`` in
    ceil(log2 T) steps. Returns h."""
    t = a.shape[1]
    off = 1
    while off < t:
        a_prev, b_prev = a[:, :t - off], b[:, :t - off]
        b = torch.cat([b[:, :off], b_prev * a[:, off:] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a_prev * a[:, off:]], dim=1)
        off *= 2
    return b


def rglru_forward(p, x, cfg: ModelConfig, r: RGLRUConfig):
    """Full-sequence Griffin recurrent block.
    x [B,T,d] -> ([B,T,d], h_T, conv_tail)."""
    dt = x.dtype
    gate = gelu(x @ p["w_gate_branch"].to(dt))
    ux = x @ p["w_x"].to(dt)
    w = r.conv_width
    conv_tail = tail(ux, w - 1)
    u = _conv(p, ux)
    a, b = _gates(p, u)                                         # [B,T,dr] fp32
    h = linear_scan(a, b)
    y = (h.to(dt) * gate) @ p["w_out"].to(dt)
    return y, h[:, h.shape[1] - 1], conv_tail


def rglru_decode(p, x, state, conv_tail, cfg: ModelConfig, r: RGLRUConfig):
    """One-token step. x [B,1,d]; state [B,dr]; conv_tail [B,W-1,dr]."""
    dt = x.dtype
    gate = gelu(x @ p["w_gate_branch"].to(dt))                   # [B,1,dr]
    ux = x @ p["w_x"].to(dt)                                     # [B,1,dr]
    window = torch.cat([conv_tail, ux], dim=1)
    w = p["conv_w"].to(dt)
    u = (torch.einsum("bwc,wc->bc", window, w) + p["conv_b"].to(dt))[:, None]
    new_tail = window[:, 1:]
    a, b = _gates(p, u)                                          # [B,1,dr]
    h = state.float() * a[:, 0] + b[:, 0]                        # [B,dr]
    y = (h[:, None].to(dt) * gate) @ p["w_out"].to(dt)
    return y, h, new_tail
