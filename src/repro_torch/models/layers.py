"""Shared neural-net layers: norms, RoPE/M-RoPE, GQA attention (full /
sliding-window / softcap / qk-norm) with KV-cache decode and paged decode,
gated MLPs and embeddings.

Plain functions on tensors; params are nested dicts built from ParamSpecs.
Compute happens in ``cfg.compute_dtype``; reductions in f32.  The cache
writes of the decode paths are IN PLACE (the reference returns new
buffers): a decode step mutates the cache or page pool it is given and
returns it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import spmd
from .common import ModelConfig, ParamSpec

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float, offset: float = 0.0):
    w = spmd.gathered(w)
    dt = x.dtype
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((offset + w.float()) * x32 * inv).to(dt)


def norm_spec(cfg: ModelConfig, dim=None) -> ParamSpec:
    init = "zeros" if cfg.norm_scale_offset else "ones"
    return ParamSpec((dim or cfg.d_model,), ("embed",), init=init, dtype=cfg.param_dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x, positions, theta: float, mrope_sections=None):
    """x: (B, S, H, dh). positions: (B, S) int, or (3, B, S) for M-RoPE,
    where each section of the frequencies is driven by its own position
    stream (temporal, height, width)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (dh/2,)
    if mrope_sections is None:
        angles = positions[..., None].float() * freqs  # (B, S, dh/2)
    else:
        if positions.ndim != 3:
            raise ValueError("M-RoPE needs positions (3, B, S)")
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(positions[i][..., None].float() * freqs[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)  # (B, S, dh/2)
    cos = torch.cos(angles)[..., None, :]  # (B, S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; full / sliding-window; softcap; qk-norm; cache decode)
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> dict:
    D, Hq, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    specs = {
        "wq": ParamSpec((D, Hq, dh), ("embed", "heads", None), dtype=pd),
        "wk": ParamSpec((D, Hkv, dh), ("embed", "kv_heads", None), dtype=pd),
        "wv": ParamSpec((D, Hkv, dh), ("embed", "kv_heads", None), dtype=pd),
        "wo": ParamSpec((Hq, dh, D), ("heads", None, "embed"), dtype=pd),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((dh,), (None,), init="ones", dtype=pd)
        specs["k_norm"] = ParamSpec((dh,), (None,), init="ones", dtype=pd)
    return specs


def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _proj(x, w, cd):
    """x (B, S, D) @ w (D, H, dh) -> (B, S, H, dh) in the compute dtype."""
    D, H, dh = w.shape
    return (x.to(cd) @ w.to(cd).reshape(D, H * dh)).reshape(*x.shape[:-1], H, dh)


def _qk(cfg: ModelConfig, p, x, positions):
    """Project + rope; returns q (B,S,Hkv,G,dh), k/v (B,S,Hkv,dh)."""
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    q = _proj(x, p["wq"], cd)
    k = _proj(x, p["wk"], cd)
    v = _proj(x, p["wv"], cd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q = q.reshape(B, S, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim)
    return q, k, v


def _scale(cfg: ModelConfig):
    return cfg.query_scale if cfg.query_scale is not None else 1.0 / math.sqrt(cfg.head_dim)


def _out_proj(cfg: ModelConfig, p, out):
    """out (B, S, Hq, dh) @ wo (Hq, dh, D) -> (B, S, D)."""
    cd = cfg.compute_dtype
    B, S = out.shape[:2]
    Hq, dh, D = p["wo"].shape
    return out.to(cd).reshape(B, S, Hq * dh) @ p["wo"].to(cd).reshape(Hq * dh, D)


def attention(
    cfg: ModelConfig,
    p,
    x,
    positions,
    window: Optional[int],
    q_chunk: int = 1024,
    causal: bool = True,
):
    """Training/prefill attention, chunked over query blocks so the (S, S)
    score matrix is never materialised whole.  Causal by default;
    optionally sliding-window (q_pos - k_pos < window).  With
    ``use_flash_kernel`` (and the reference's gate ``S % min(128, S) == 0``)
    it runs through the flash kernel."""
    if spmd.is_dtensor(x):
        return _attention_dt(cfg, p, x, positions, window, q_chunk, causal)
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    q, k, v = _qk(cfg, p, x, positions)
    scale = _scale(cfg)
    # the flash path assumes contiguous arange positions (block masking):
    # M-RoPE batches stay on the chunked path, as in the reference
    if cfg.use_flash_kernel and causal and cfg.mrope_sections is None and S % min(128, S) == 0:
        from repro_torch.kernels.ops import flash_attention as _flash

        qf = q.reshape(B, S, cfg.num_heads, cfg.head_dim).transpose(1, 2).contiguous()
        out = _flash(
            qf, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            causal=True, window=window, softcap=cfg.attn_logit_softcap, scale=scale,
        )
        return _out_proj(cfg, p, out.transpose(1, 2))
    q_chunk = min(q_chunk, S)
    while S % q_chunk:  # largest divisor of S
        q_chunk -= 1
    kpos = positions if positions.ndim == 2 else positions[0]  # (B, S)
    outs = []
    for c in range(S // q_chunk):
        qs = q[:, c * q_chunk:(c + 1) * q_chunk]
        qp = kpos[:, c * q_chunk:(c + 1) * q_chunk]
        s = torch.einsum("bqhgk,bthk->bhgqt", qs.to(cd), k.to(cd)) * scale
        s = _softcap(s.float(), cfg.attn_logit_softcap)
        mask = torch.ones((B, q_chunk, S), dtype=torch.bool, device=x.device)
        if causal:
            mask &= qp[:, :, None] >= kpos[:, None, :]
        if window is not None:
            mask &= (qp[:, :, None] - kpos[:, None, :]) < window
        s = torch.where(mask[:, None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(cd)
        outs.append(torch.einsum("bhgqt,bthk->bqhgk", w, v.to(cd)))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return _out_proj(cfg, p, out.reshape(B, S, cfg.num_heads, cfg.head_dim))


def _attention_dt(cfg: ModelConfig, p, x, positions, window, q_chunk, causal):
    """``attention`` on DTensors: each rank runs the plain attention on its
    rows and its heads (split over ``model`` where the query weights are),
    and the output projection leaves a partial sum over ``model``."""
    plan = spmd.heads_plan(cfg, x, spmd.split_on(p["wk"], 1), spmd.split_on(p["wq"], 1))
    split = spmd.sum_dims(x, plan[4])
    local = attention(cfg.replace(num_heads=plan[0], num_kv_heads=plan[1]),
                      spmd.attn_weights(p, plan, split), spmd.local_rows(x, x, partial=split),
                      spmd.local_rows(positions, x, positions.ndim - 2), window, q_chunk, causal)
    return spmd.out_rows(local, x, plan[4])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, window: Optional[int], dtype, device,
               lead: tuple = ()):
    """KV cache for one attention layer, with leading dims ``lead`` (the
    stacked-layer axis).  Windowed layers use a ring buffer of length
    ``window``."""
    L = min(window, max_seq) if window else max_seq
    shape = lead + (batch, L, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_attention(cfg: ModelConfig, p, x, cache, t, window: Optional[int]):
    """Single-token decode.  x: (B, 1, D); t: current position, a 0-d
    tensor or one per row (B,) — the engine batches slots whose positions
    differ.  Writes this step's k/v into ``cache`` IN PLACE (a full cache
    clamps the write slot at L-1, as the reference's dynamic update does).
    Returns (out (B, 1, D), cache)."""
    if spmd.is_dtensor(x):
        return _decode_attention_dt(cfg, p, x, cache, t, window)
    cd = cfg.compute_dtype
    B = x.shape[0]
    t = torch.as_tensor(t, device=x.device).long()
    tb = t.expand(B) if t.ndim == 0 else t  # (B,)
    pos = tb[:, None]
    if cfg.mrope_sections is not None:  # every stream at t, as the reference broadcasts
        pos = pos[None].expand(3, B, 1)
    q, k, v = _qk(cfg, p, x, pos)
    L = cache["k"].shape[1]
    slot = tb % L if window else tb.clamp(max=L - 1)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    # slot j holds absolute position: full cache -> j; ring -> t - ((t - j) mod L)
    j = torch.arange(L, device=x.device)[None, :]
    kpos = tb[:, None] - ((tb[:, None] - j) % L) if window else j.expand(B, L)
    valid = (kpos >= 0) & (kpos <= tb[:, None])  # (B, L)
    s = torch.einsum("bqhgk,bthk->bhgqt", q.to(cd), cache["k"].to(cd)) * _scale(cfg)
    s = _softcap(s.float(), cfg.attn_logit_softcap)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(cd)
    out = torch.einsum("bhgqt,bthk->bqhgk", w, cache["v"].to(cd))
    out = out.reshape(B, 1, cfg.num_heads, cfg.head_dim)
    return _out_proj(cfg, p, out), cache


def _decode_attention_dt(cfg: ModelConfig, p, x, cache, t, window):
    """``decode_attention`` on DTensors.  A cache split over ``model`` by kv
    heads: each rank decodes its rows and kv heads (with their query
    groups) as plain torch, writing its own cache block in place, and the
    output is a partial sum over ``model``.  A cache split by positions
    (too few kv heads): every rank computes every head, writes the new k/v
    into the block that holds the slot, and attends over its rows of the
    cache gathered along the positions."""
    mi = spmd.model_axis(x)[0]
    pl = cache["k"].placements[mi] if mi is not None else None
    by_pos = pl is not None and pl.is_shard() and pl.dim == 1
    plan = spmd.heads_plan(cfg, x, pl is not None and pl.is_shard() and pl.dim == 2, False)
    cfg_l = cfg.replace(num_heads=plan[0], num_kv_heads=plan[1])
    p_l = spmd.attn_weights(p, plan)
    x_l = spmd.local_rows(x, x)
    t_l = spmd.local_rows(t, x) if t.ndim else spmd.to_layout(t, x.device_mesh, {})
    if not by_pos:  # the rank's kv heads of its rows, whole along the positions
        c_l = spmd.state_rows(cache, x, dims=(2,))
        out, _ = decode_attention(cfg_l, p_l, x_l, c_l, t_l, window)
        spmd.write_back(cache, c_l, x, dims=(2,))
        return spmd.out_rows(out, x, plan[4]), cache
    B = x_l.shape[0]
    tb = t_l.long().expand(B) if t_l.ndim == 0 else t_l.long()
    pos = tb[:, None]
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, B, 1)
    _, k, v = _qk(cfg_l, p_l, x_l, pos)
    L = cache["k"].shape[1]
    slot = tb % L if window else tb.clamp(max=L - 1)
    for name, new in (("k", k), ("v", v)):  # the block that holds the slot writes it
        loc = cache[name].to_local()
        rel = slot - spmd.offset(cache[name], 1)
        inside = (rel >= 0) & (rel < loc.shape[1])
        rows = torch.arange(loc.shape[0], device=loc.device)
        at = rel.clamp(0, loc.shape[1] - 1)
        loc[rows, at] = torch.where(inside[:, None, None], new[:, 0].to(loc.dtype), loc[rows, at])
    full = {name: spmd.state_rows(cache[name], x) for name in ("k", "v")}
    out, _ = decode_attention(cfg_l, p_l, x_l, full, t_l, window)
    return spmd.out_rows(out, x, plan[4]), cache


def paged_decode_attention(cfg: ModelConfig, p, x, pool, block_tables, context_lens, write_block):
    """Single-token decode against a block-paged KV pool.

    x: (S, 1, D) — every engine slot jointly.  pool: {"k","v"} of
    (num_pages, bs, Hkv, dh); block_tables (S, M) int32; context_lens (S,)
    int32 current positions; write_block (S,) int32 destination page for
    this step's k/v (page 0 is the sink: done/free slots write there and
    nothing ever reads it).  The k/v write into the page happens IN PLACE,
    before the attention reads the pool.  Returns (out (S, 1, D), pool)."""
    cd = cfg.compute_dtype
    S = x.shape[0]
    pos = context_lens[:, None].long()  # (S, 1)
    q, k, v = _qk(cfg, p, x, pos)  # q (S,1,Hkv,G,dh), k/v (S,1,Hkv,dh)
    bs = pool["k"].shape[1]
    off = (context_lens.long() % bs)
    wb = write_block.long()
    pool["k"][wb, off] = k[:, 0].to(pool["k"].dtype)
    pool["v"][wb, off] = v[:, 0].to(pool["v"].dtype)
    if cfg.use_flash_kernel and cfg.mrope_sections is None:
        from repro_torch.kernels.ops import paged_attention as _paged

        out = _paged(
            q[:, 0].contiguous(), pool["k"], pool["v"], block_tables, context_lens,
            scale=_scale(cfg), window=None, softcap=cfg.attn_logit_softcap,
        )[:, None]  # (S, 1, Hkv, G, dh)
    else:
        M = block_tables.shape[1]
        tab = block_tables.long()
        kd = pool["k"][tab].reshape(S, M * bs, cfg.num_kv_heads, cfg.head_dim)
        vd = pool["v"][tab].reshape(S, M * bs, cfg.num_kv_heads, cfg.head_dim)
        kpos = torch.arange(M * bs, device=x.device)[None, :]
        valid = kpos <= context_lens[:, None].long()
        s = torch.einsum("bqhgk,bthk->bhgqt", q.to(cd), kd.to(cd)) * _scale(cfg)
        s = _softcap(s.float(), cfg.attn_logit_softcap)
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(cd)
        out = torch.einsum("bhgqt,bthk->bqhgk", w, vd.to(cd))
    out = out.reshape(S, 1, cfg.num_heads, cfg.head_dim)
    return _out_proj(cfg, p, out), pool


def init_page_pool(cfg: ModelConfig, num_pages: int, block_size: int, dtype, device,
                   lead: tuple = ()):
    """Paged KV pool for one attention layer, with leading dims ``lead``: a
    flat page array shared by every sequence, indexed through per-sequence
    block tables."""
    shape = lead + (num_pages, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu}


def mlp_specs(cfg: ModelConfig, d_ff=None) -> dict:
    D, Fd, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.param_dtype
    specs = {
        "w_up": ParamSpec((D, Fd), ("embed", "mlp"), dtype=pd),
        "w_down": ParamSpec((Fd, D), ("mlp", "embed"), dtype=pd),
    }
    if cfg.mlp_gated:
        specs["w_gate"] = ParamSpec((D, Fd), ("embed", "mlp"), dtype=pd)
    return specs


def mlp(cfg: ModelConfig, p, x):
    if spmd.is_dtensor(x):  # hidden units split over ``model`` where the weights are
        split = spmd.split_on(p["w_up"], 1)
        f = p["w_up"].shape[1] // (spmd.model_axis(x)[1] if split else 1)
        lo = spmd.model_axis(x)[2] * f if split else 0
        dims = spmd.sum_dims(x, split)
        p_l = {k: spmd.part(w, 0 if k == "w_down" else 1, lo, f, dims) for k, w in p.items()}
        return spmd.out_rows(mlp(cfg, p_l, spmd.local_rows(x, x, partial=dims)), x, split)
    cd = cfg.compute_dtype
    act = _ACTS[cfg.act]
    xc = x.to(cd)
    if cfg.mlp_gated:
        h = act(xc @ p["w_gate"].to(cd)) * (xc @ p["w_up"].to(cd))
    else:
        h = act(xc @ p["w_up"].to(cd))
    return h @ p["w_down"].to(cd)


# ---------------------------------------------------------------------------
# Embeddings + logits
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    specs = {
        "table": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=0.02, dtype=pd)
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dtype=pd
        )
    return specs


def embed(cfg: ModelConfig, p, tokens):
    """The token rows of the table, in the compute dtype.  Under
    ``cfg.embed_onehot`` the lookup is the reference's contraction
    ``one_hot(tokens) @ table``, meant for a vocabulary-sharded table (a
    local product and one reduction, where a gather moves the whole
    table); the values are the gather's."""
    p = spmd.gathered(p)
    cd = cfg.compute_dtype
    if spmd.is_dtensor(p["table"]):
        x = spmd.take_rows(p["table"], tokens.long(), cd if cfg.embed_onehot else None).to(cd)
    elif cfg.embed_onehot:
        x = F.one_hot(tokens.long(), cfg.vocab_size).to(cd) @ p["table"].to(cd)
    else:
        x = p["table"][tokens.long()].to(cd)
    if cfg.embed_scale == "sqrt_d":
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
    return x


def _logits_chunk(cfg: ModelConfig, p, x):
    cd = cfg.compute_dtype
    w = p["table"].to(cd).T if cfg.tie_embeddings else p["unembed"].to(cd)
    logits = spmd.vocab_product(x.to(cd), w) if spmd.is_dtensor(x) else x.to(cd) @ w
    return _softcap(logits.float(), cfg.final_logit_softcap)


def final_logits(cfg: ModelConfig, p, x_last):
    """Logits for the last position only: x_last (B, 1, D) -> (B, 1, V)."""
    return _logits_chunk(cfg, spmd.gathered(p), x_last)


def chunked_xent(cfg: ModelConfig, p, x, labels, mask=None):
    """sum_t NLL(labels_t) over sequence chunks of ``cfg.xent_chunk``, so
    only one chunk's (B, C, V) logits exist at a time (and are kept for the
    backward pass).  Returns (sum_nll, token_count) as 0-d f32 tensors."""
    B, S, D = x.shape
    C = min(cfg.xent_chunk, S)
    p = spmd.gathered(p)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    sum_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, C):
        logits = _logits_chunk(cfg, p, x[:, s0:s0 + C])  # (B, C, V) f32
        lse = spmd.logsumexp(logits)
        gold = spmd.take_last(logits, labels[:, s0:s0 + C].long())
        sum_nll = sum_nll + torch.sum((lse - gold) * mask[:, s0:s0 + C].float())
    return sum_nll, torch.sum(mask.float())
