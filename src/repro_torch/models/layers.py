"""Core neural layers (the port of ``repro.models.layers``): RMSNorm, RoPE,
chunked flash attention (global/local/causal/softcapped), GQA via grouped
einsum, cache attention for decode, and SwiGLU/GELU MLPs.

Everything is a plain function over (params, activations) and keeps the
reference's algorithm, chunking included: attention never forms the full
``[Tq, Tk]`` score matrix — q and kv are both chunked with an
online-softmax accumulator (the reference's ``lax.map``/``lax.scan`` over
chunks are Python loops here). Where the reference asks a contraction for
an fp32 result (``preferred_element_type``), the port contracts fp32
copies of its operands: the products of bf16 values are exact in fp32, so
both accumulate the same terms. The reference's sharding constraints
(``parallel.sharding.constrain``) stand where the reference has them: the
identity on one device, a redistribute of a DTensor on a mesh.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .counting import trips
from ..parallel.sharding import (constrain, current_rules, grad_as_placed,
                                 merged, on_mesh, on_shards, placements,
                                 redistribute, spec_for_array, split_last,
                                 unshard)

_NEG = -1e30
INT32_MAX = 2**31 - 1


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm with an fp32 *reduction* and the data path in ``x.dtype``;
    scales by ``1 + w``."""
    return rms_normalized(x, eps) * (1.0 + w.to(x.dtype))


def rms_normalized(x, eps: float = 1e-6):
    """:func:`rms_norm` before its weight: ``x`` over its fp32 root mean
    square, in ``x.dtype``."""
    ms = x.float().square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps).to(x.dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding, split-half convention, fp32 angles.
    x: [..., T, H, D], positions [..., T]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., :, None, None].float() * freq    # [..., T, 1, half]
    cos, sin = torch.cos(angle), torch.sin(angle)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def proj_heads(x, w):
    """``einsum("btd,dhe->bthe")``: project onto heads. On a mesh it is the
    same contraction onto the flattened ``(h, e)`` dim, split into heads
    after (the einsum views its product into heads inside, which DTensor
    refuses when the split of ``h * e`` cuts heads: 8 kv heads on 16
    ranks). Each flatten and split keeps its gradient on its own
    placements (``sharding.merged``, ``split_last``): the backward's views
    then cut no shard either."""
    if on_mesh(x):
        h, e = w.shape[1:]
        return split_last(x @ merged(w, 1, 2), h, e)
    return torch.einsum("btd,dhe->bthe", x, w)


def merge_heads(o, w):
    """``einsum("bthe,hed->btd")``: the output projection. On a mesh it is
    the same contraction over the flattened ``(h, e)`` dims: the einsum
    flattens them as ``(e, h)``, which DTensor (torch 2.11) refuses when
    the heads are split; as in :func:`proj_heads`, each flatten keeps its
    gradient on its own placements."""
    if on_mesh(o):
        return merged(o, 2, 3) @ merged(w, 0, 1)
    return torch.einsum("bthe,hed->btd", o, w)


def _softcap(s, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(s / cap) * cap
    return s


def _pad_seq(x, n: int, value=0):
    """Pad dim 1 (the sequence) of ``x`` by ``n`` at the end."""
    if n == 0:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, n]
    return F.pad(x, pad, value=value)


def flash_attention(
    q, k, v, *,
    q_positions, kv_positions,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
):
    """Chunked online-softmax attention with GQA grouping.

    q: [B, Tq, H, D]; k, v: [B, Tk, KH, Dk/Dv] with H % KH == 0. Never forms
    [Tq, Tk]; peak score block is [B, KH, G, q_chunk, kv_chunk] fp32.
    Returns [B, Tq, H, Dv]. On a mesh each rank attends its own (batch,
    kv-head) blocks (:func:`kv_blocks`), with no collective inside.
    """
    k, v = kv_for_blocks(q, k, v)
    return on_shards(_flash_attention, kv_blocks(k), 1)(
        q, k, v, q_positions, kv_positions, causal, window, softcap,
        q_chunk, kv_chunk, scale)


def kv_for_blocks(q, k, v):
    """``(k, v)``, on a mesh with their heads repeated up to ``q``'s where
    the query heads split over the mesh and the kv heads do not (8 kv heads
    of 32 on 16 ranks): each rank then attends its own query heads against
    their own kv heads, where it would otherwise attend every head of its
    rows. Head ``j`` of the repeat is kv head ``j // G``, the one query
    head ``j`` reads, so the attention is the same."""
    rules = current_rules()
    if rules is None or not on_mesh(k):
        return k, v
    mesh = k.device_mesh
    kv = spec_for_array(tuple(k.shape), ("batch", None, "kv_heads", None),
                        rules, mesh)
    qh = spec_for_array(tuple(q.shape), ("batch", None, "heads", None),
                        rules, mesh)
    if kv[2] is not None or qh[2] is None:
        return k, v
    g = q.shape[2] // k.shape[2]
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def kv_blocks(k):
    """On a mesh (``k`` a DTensor under active rules): the placements that
    split dim 0 as ``"batch"`` and dim 2 as ``"kv_heads"`` (for ``k``'s
    sizes), the blocks attention needs no collective within; a query's
    heads split with its kv heads (``H = KH·G``, kv-major). ``None`` off a
    mesh."""
    rules = current_rules()
    if rules is None or not on_mesh(k):
        return None
    mesh = k.device_mesh
    return placements(spec_for_array(
        tuple(k.shape), ("batch", None, "kv_heads", None), rules, mesh), mesh)


def _flash_attention(q, k, v, q_positions, kv_positions, causal, window,
                     softcap, q_chunk, kv_chunk, scale):
    b, tq, h, d = q.shape
    _, tk, kh, dk = k.shape
    dv = v.shape[-1]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5

    qc = min(q_chunk, tq)
    kc = min(kv_chunk, tk)
    tq_p = -(-tq // qc) * qc
    tk_p = -(-tk // kc) * kc
    qp = _pad_seq(q, tq_p - tq)
    kp = _pad_seq(k, tk_p - tk)
    vp = _pad_seq(v, tk_p - tk)
    qpos = F.pad(q_positions, (0, tq_p - tq), value=-1)
    kpos = F.pad(kv_positions, (0, tk_p - tk), value=INT32_MAX)

    # [nq, B, KH, G, qc, D] / [nk, B, KH, kc, D]
    qb = qp.reshape(b, tq_p // qc, qc, kh, g, d).permute(1, 0, 3, 4, 2, 5)
    kb = kp.reshape(b, tk_p // kc, kc, kh, dk).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(b, tk_p // kc, kc, kh, dv).permute(1, 0, 3, 2, 4)
    # the reference pins the kv-head sharding on the chunked operands, so
    # the chunk loops need no collective (on a mesh this runs on one
    # (batch, kv-head) block already, and these are the identity)
    qb = constrain(qb, (None, "batch", "kv_heads", None, None, None))
    kb = constrain(kb, (None, "batch", "kv_heads", None, None))
    vb = constrain(vb, (None, "batch", "kv_heads", None, None))
    qpb = qpos.reshape(tq_p // qc, qc)
    kpb = kpos.reshape(tk_p // kc, kc)

    outs = []
    for q_i, qpos_i in zip(qb, qpb):
        q32 = q_i.float()
        m = torch.full((b, kh, g, qc), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, kh, g, qc, dv), dtype=torch.float32, device=q.device)
        for k_j, v_j, kpos_j in trips(zip(kb, vb, kpb), len(kpb)):
            s = torch.einsum("bkgqd,bksd->bkgqs", q32, k_j.float()) * scale
            s = _softcap(s, softcap)
            valid = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                valid &= kpos_j[None, :] <= qpos_i[:, None]
            if window and window > 0:
                valid &= (qpos_i[:, None] - kpos_j[None, :]) < window
            s = torch.where(valid, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p.to(v_j.dtype).float(), v_j.float())
            m = m_new
        outs.append(o / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs)                       # [nq, B, KH, G, qc, Dv]
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, tq_p, h, dv)
    return out[:, :tq].to(q.dtype)


def local_attention(q, k, v, *, window: int, q_positions, softcap: float = 0.0):
    """Banded causal self-attention, O(T·window) FLOPs: w-sized query blocks
    against (previous + own) key blocks; per (batch, kv-head) block on a
    mesh, as :func:`flash_attention`."""
    k, v = kv_for_blocks(q, k, v)
    return on_shards(_local_attention, kv_blocks(k), 1)(
        q, k, v, window, q_positions, softcap)


def _local_attention(q, k, v, window, q_positions, softcap):
    b, t, h, d = q.shape
    w = window
    tp = -(-t // w) * w
    n = tp // w

    def blocks(x):
        return _pad_seq(x, tp - t).reshape(b, n, w, *x.shape[2:])

    qb, kb, vb = blocks(q), blocks(k), blocks(v)
    pos = F.pad(q_positions, (0, tp - t), value=-1).reshape(n, w)
    # key positions pad with +inf so padded keys never pass the causal mask
    # (the -1 query pad is harmless: padded outputs are sliced off)
    posk_all = F.pad(q_positions, (0, tp - t),
                     value=INT32_MAX - 1).reshape(n, w)
    # previous block (zeros/invalid for the first)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    pprev = torch.cat([torch.full((1, w), INT32_MAX - 1, dtype=pos.dtype,
                                  device=pos.device), posk_all[:-1]], dim=0)
    outs = []
    for i in range(n):
        kk = torch.cat([kprev[:, i], kb[:, i]], dim=1)
        vv = torch.cat([vprev[:, i], vb[:, i]], dim=1)
        pk = torch.cat([pprev[i], posk_all[i]], dim=0)
        outs.append(flash_attention(
            qb[:, i], kk, vv, q_positions=pos[i], kv_positions=pk,
            causal=True, window=w, softcap=softcap,
            q_chunk=min(1024, w), kv_chunk=min(1024, 2 * w)))
    out = torch.stack(outs, dim=1).reshape(b, tp, h, -1)
    return out[:, :t].to(q.dtype)


def cache_attention(q, k_cache, v_cache, *, cur_len, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None):
    """Single-token decode attention over a [B, S, KH, D] cache; positions
    ``>= cur_len`` (and, with a window, ``< cur_len - window``) are masked."""
    s = k_cache.shape[1]
    kv_pos = torch.arange(s, device=q.device)
    valid = kv_pos[None, :] < cur_len[:, None]            # [B, S]
    if window and window > 0:
        valid &= kv_pos[None, :] >= (cur_len[:, None] - window)
    return attend_cache(q, k_cache, v_cache, valid, softcap=softcap,
                        scale=scale)


def attend_cache(q, k_cache, v_cache, valid, *, softcap: float = 0.0,
                 scale: Optional[float] = None):
    """Softmax attention of q [B, TQ, H, D] over a [B, S, KH, D] cache at
    the positions ``valid`` [B, S] marks. On a mesh each rank attends over
    the block of the cache it holds (:func:`_attend_cache_blocks`)."""
    b, tq, h, d = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    if on_mesh(k_cache):
        return _attend_cache_blocks(q, k_cache, v_cache, valid, softcap,
                                    scale)
    qg = q.reshape(b, tq, kh, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k_cache.float()) * scale
    scores = _softcap(scores, softcap)
    scores = torch.where(valid[:, None, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, tq, h, -1).to(q.dtype)


def _attend_cache_blocks(q, k_cache, v_cache, valid, softcap, scale):
    """:func:`attend_cache` on a mesh, on the cache's own layout: each rank
    attends over the block it holds (its rows, its stretch of the sequence,
    its kv heads) and the blocks of a row are combined by their softmax
    statistics (the log-sum-exp combine): one max and two sums over the
    ranks that split the sequence, and no cache moves. (DTensor's own
    contraction over a sequence-split cache views its operands in ways
    torch 2.11 refuses.) ``q`` comes to the rows and kv heads the cache
    is split by, whole over the sequence split."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    b, tq, h, _ = q.shape
    cache, qp, okp, top, total, whole = [], [], [], [], [], []
    for p in k_cache.placements:
        dim = p.dim if isinstance(p, Shard) and p.dim in (0, 1, 2) else None
        cache.append(p if dim is not None else Replicate())
        qp.append(Shard(dim) if dim in (0, 2) else Replicate())
        okp.append(Shard(dim) if dim in (0, 1) else Replicate())
        # statistics [B, KH, G, TQ] and outputs [B, KH, G, TQ, D]
        stat = {0: Shard(0), 2: Shard(1)}.get(dim, Replicate())
        top.append(Partial("max") if dim == 1 else stat)
        total.append(Partial("sum") if dim == 1 else stat)
        whole.append(stat)
    cache, qp, okp = tuple(cache), tuple(qp), tuple(okp)
    top, total, whole = tuple(top), tuple(total), tuple(whole)
    if not isinstance(valid, DTensor):
        valid = distribute_tensor(valid, mesh, list(okp), src_data_rank=None)

    def block(q, k, v, ok):
        b, tq, h, d = q.shape
        kh = k.shape[2]
        qg = q.reshape(b, tq, kh, h // kh, d)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
        s = _softcap(s, softcap)
        s = torch.where(ok[:, None, None, None, :], s, _NEG)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(),
                         v.float())
        return m, p.sum(dim=-1), o

    def rescale(m, m_all, l, o):
        w = torch.exp(m - m_all)
        return l * w, o * w[..., None]

    m, l, o = local_map(block, out_placements=(top, total, total),
                        in_placements=(qp, cache, cache, okp),
                        device_mesh=mesh)(
        redistribute(q, qp), redistribute(k_cache, cache),
        redistribute(v_cache, cache), redistribute(valid, okp))
    m_all = m.redistribute(mesh, whole)
    l, o = local_map(rescale, out_placements=(total, total),
                     in_placements=(top, whole, total, total),
                     device_mesh=mesh)(m, m_all, l, o)
    out = o.redistribute(mesh, whole) / l.redistribute(mesh, whole)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, -1).to(q.dtype)


def delay(x, i: int):
    """``x`` [B, T, ...] shifted ``i`` steps later along T, zeros first:
    ``F.pad(x, (.., i, 0))[:, :-i]``, written with ops DTensor can shard
    (a pad and a negative slice fail there under torch 2.11)."""
    t = x.shape[1]
    if i >= t:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:, :i]), x[:, :t - i]], dim=1)


def tail(x, n: int):
    """The last ``n`` steps of ``x`` [B, T, ...] along T, zeros before it
    when T < n: ``F.pad(x, (.., n, 0))[:, -n:]``."""
    t = x.shape[1]
    if t >= n:
        return x[:, t - n:]
    return F.pad(x, [0, 0] * (x.dim() - 2) + [n - t, 0])


def lookup(table, tokens):
    """``table[tokens]``, the embedding gather. On a mesh it is
    ``F.embedding`` on the table with its vocab dim made whole: the index
    op's backward fails under torch 2.11, and the vocab-split embedding's
    masked partial sum fails on a 2-d mesh. The table's gradient comes back
    on its own placements, as a tied head's does (``transformer._logits``):
    torch 2.11 cannot add the two otherwise."""
    if on_mesh(table):
        return F.embedding(tokens, unshard(grad_as_placed(table), 0))
    return table[tokens]


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x, act: str):
    """``p``: the MLP's weights, already in ``x.dtype``."""
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]


def mlp_init(b, d_model: int, d_ff: int, act: str, *, ff_axis: str = "mlp",
             embed_axis: str = "embed"):
    if act == "swiglu":
        b.dense("w_gate", (d_model, d_ff), (embed_axis, ff_axis))
    b.dense("w_up", (d_model, d_ff), (embed_axis, ff_axis))
    b.dense("w_down", (d_ff, d_model), (ff_axis, embed_axis))
    return b


def cast_weights(p, dtype):
    """``{name: weight.to(dtype)}`` for a node's parameters: the reference
    casts each weight at its use."""
    return {n: w.to(dtype) for n, w in p.named_parameters(recurse=False)}
