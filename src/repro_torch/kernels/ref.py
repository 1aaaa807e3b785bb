"""Plain PyTorch versions of every hand-written kernel: what the CPU path
runs, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.  Counterparts of ``repro/kernels/ref.py``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# --- flash attention ---------------------------------------------------------


def attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q: (B, Hq, S, d); k/v: (B, Hkv, S, d); GQA by head broadcast.
    Full-materialisation reference; returns q's dtype."""
    B, Hq, S, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qr = q.reshape(B, Hkv, G, S, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qr * scale, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(B, Hq, S, d).to(q.dtype)


# --- paged attention (single-token decode) -----------------------------------


def gather_pages(pages, block_tables):
    """(num_pages, bs, Hkv, d) pool + (B, M) int32 tables -> the dense
    per-sequence cache (B, M*bs, Hkv, d) a slot-resident engine would hold."""
    B, M = block_tables.shape
    _, bs, Hkv, d = pages.shape
    return pages[block_tables.long()].reshape(B, M * bs, Hkv, d)


def paged_attention(
    q, k_pages, v_pages, block_tables, context_lens,
    *, scale=None, window=None, softcap=None,
):
    """Dense full-materialisation reference for the paged decode kernel:
    gather every page into a contiguous cache, then masked softmax in f32.
    q: (B, Hkv, G, d); context_lens (B,) is the INCLUSIVE current position.
    Returns (B, Hkv, G, d) in q's dtype."""
    B, Hkv, G, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = gather_pages(k_pages, block_tables).float()  # (B, T, Hkv, d)
    v = gather_pages(v_pages, block_tables).float()
    s = torch.einsum("bhgd,bthd->bhgt", q.float() * scale, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]  # (1, T)
    ctx = context_lens[:, None].long()
    mask = kpos <= ctx
    if window is not None:
        mask &= (ctx - kpos) < window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgt,bthd->bhgd", w, v).to(q.dtype)


# --- fused BMA mixture + selection -------------------------------------------


def bma_select(logits, gumbel, *, mode, temperature, top_k):
    """Unfused version of the bma_select kernel: mixture via the serving
    helper, selection via argmax over (scaled, top-k-masked) + Gumbel.
    ``gumbel`` (S, V) f32 is ignored (and may be None) when
    ``temperature <= 0``.  Returns (tokens (S,) int32, logp (S, V) f32)."""
    from repro_torch.serve.engine.bma import mixture_logprobs
    from repro_torch.serve.sampling import _top_k_mask

    logp = mixture_logprobs(logits, mode)  # (S, V) f32
    if temperature <= 0.0:
        return torch.argmax(logp, dim=-1).to(torch.int32), logp
    sel = logp / float(temperature)
    if top_k:
        sel = _top_k_mask(sel, top_k)
    tok = torch.argmax(sel + gumbel.float(), dim=-1).to(torch.int32)
    return tok, logp
