"""Whisper-style encoder-decoder backbone (the audio family).

As in the reference, the conv/mel frontend is a stub: callers hand in
precomputed frame embeddings (B, T_enc, d_model).  The transformer
backbone is real: a bidirectional encoder, and a causal decoder with
cross-attention.  Norms are RMS and positions are absolute (sinusoids on
the encoder, learned ``dec_pos`` rows on the decoder; no RoPE).

The decoder's causal self-attention goes through ``layers.attention``, so
its prefill reaches the flash kernel under ``use_flash_kernel``; the
encoder is non-causal and stays on the plain chunked path.  The cross K/V
are computed once at prefill and cached (``cross_k``, ``cross_v``).
Decode writes the self-attention cache IN PLACE and returns it.
"""
from __future__ import annotations

import torch

from . import layers as L
from . import spmd
from .common import ModelConfig, ParamSpec, tree_map
from .transformer import _norm, checkpointed, stack_specs

DEC_POS_ROWS = 36864  # learned decoder positions, sized for the largest decode cell


def _xattn_specs(cfg: ModelConfig) -> dict:
    D, Hq, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    return {
        "wq": ParamSpec((D, Hq, dh), ("embed", "heads", None), dtype=pd),
        "wk": ParamSpec((D, Hkv, dh), ("embed", "kv_heads", None), dtype=pd),
        "wv": ParamSpec((D, Hkv, dh), ("embed", "kv_heads", None), dtype=pd),
        "wo": ParamSpec((Hq, dh, D), ("heads", None, "embed"), dtype=pd),
    }


def _enc_block_specs(cfg):
    return {
        "ln1": L.norm_spec(cfg),
        "attn": L.attn_specs(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def _dec_block_specs(cfg):
    return {
        "ln1": L.norm_spec(cfg),
        "attn": L.attn_specs(cfg),
        "ln_x": L.norm_spec(cfg),
        "xattn": _xattn_specs(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def param_specs(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    return {
        "embed": L.embed_specs(cfg),
        "dec_pos": ParamSpec((DEC_POS_ROWS, cfg.d_model), (None, "embed"), scale=0.02, dtype=pd),
        "enc_layers": stack_specs(_enc_block_specs(cfg), cfg.enc_layers),
        "enc_norm": L.norm_spec(cfg),
        "dec_layers": stack_specs(_dec_block_specs(cfg), cfg.num_layers),
        "final_norm": L.norm_spec(cfg),
    }


def _layers(stack, n: int):
    """The n layers of a stacked param tree, each leaf unbound once (so a
    backward pass writes each leaf's gradient in one stack), as they lie
    (a layer gathers its own at use)."""
    per = tree_map(lambda a: a.unbind(0), stack)
    return [tree_map(lambda a: a[i], per) for i in range(n)]


def _sinusoid(T: int, D: int, device):
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None]
    ang = pos / (10000.0 ** (2 * dim / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(cfg: ModelConfig, params, frame_embeds):
    """frame_embeds: (B, T_enc, D) from the stubbed frontend."""
    cd = cfg.compute_dtype
    B, T, D = frame_embeds.shape
    x = frame_embeds.to(cd) + _sinusoid(T, D, frame_embeds.device).to(cd)[None]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)

    def layer(x, p):
        p = spmd.gathered(p)
        x = x + L.attention(cfg, p["attn"], _norm(cfg, x, p["ln1"]), positions, None,
                            causal=False)
        return x + L.mlp(cfg, p["mlp"], _norm(cfg, x, p["ln2"]))

    for p in _layers(params["enc_layers"], cfg.enc_layers):
        x = checkpointed(layer, x, p)
    return _norm(cfg, x, params["enc_norm"])


def _cross_attention(cfg, p, x, enc_kv):
    """x: (B, S, D) decoder side; enc_kv: (k, v) each (B, T, Hkv, dh)."""
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    q = L._proj(x, p["wq"], cd).reshape(B, S, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim)
    k, v = enc_kv
    s = torch.einsum("bqhgk,bthk->bhgqt", q, k.to(cd)) * L._scale(cfg)
    w = torch.softmax(s.float(), dim=-1).to(cd)
    out = torch.einsum("bhgqt,bthk->bqhgk", w, v.to(cd))
    return L._out_proj(cfg, p, out.reshape(B, S, cfg.num_heads, cfg.head_dim))


def _enc_kv(cfg, p, enc_out):
    cd = cfg.compute_dtype
    return L._proj(enc_out, p["wk"], cd), L._proj(enc_out, p["wv"], cd)


def _decoder(cfg, params, tokens, enc_out, cache=None):
    """The decoder over a whole prompt from position 0.  With ``cache``
    (from :func:`make_cache`), each layer's self k/v and cross k/v are
    written into it in place, as the prefill needs.  Every layer, as every
    encoder layer, is checkpointed whatever ``cfg.remat`` says (the
    reference's ``jax.checkpoint`` around both scans)."""
    cd = cfg.compute_dtype
    B, S = tokens.shape
    x = L.embed(cfg, params["embed"], tokens)
    pos_ids = torch.arange(S, dtype=torch.int32, device=x.device)
    x = x + params["dec_pos"][pos_ids.long()].to(cd)[None]
    positions = pos_ids[None].expand(B, S)

    def layer(x, p, i):
        p = spmd.gathered(p)
        xin = _norm(cfg, x, p["ln1"])
        if cache is not None:
            _, k, v = L._qk(cfg, p["attn"], xin, positions)
            cache["self_k"][i, :, :S] = k.to(cache["self_k"].dtype)
            cache["self_v"][i, :, :S] = v.to(cache["self_v"].dtype)
        x = x + L.attention(cfg, p["attn"], xin, positions, None)
        kv = _enc_kv(cfg, p["xattn"], enc_out)
        if cache is not None:
            cache["cross_k"][i].copy_(kv[0])
            cache["cross_v"][i].copy_(kv[1])
        x = x + _cross_attention(cfg, p["xattn"], _norm(cfg, x, p["ln_x"]), kv)
        return x + L.mlp(cfg, p["mlp"], _norm(cfg, x, p["ln2"]))

    for i, p in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
        x = checkpointed(lambda x_, p_, i=i: layer(x_, p_, i), x, p)
    return _norm(cfg, x, params["final_norm"])


def train_nll(cfg: ModelConfig, params, batch):
    """batch: frame_embeds (B, T_enc, D), tokens and labels (B, S), optional
    mask.  Returns (sum_nll, token_count).  On DTensors (the family runs
    data-parallel) each rank runs its rows with the weights whole."""
    if spmd.is_dtensor(batch["tokens"]):
        return spmd.rows_local(lambda p_, b_: train_nll(cfg, p_, b_), batch["tokens"], params,
                               batch)
    enc_out = encode(cfg, params, batch["frame_embeds"])
    x = _decoder(cfg, params, batch["tokens"], enc_out)
    return L.chunked_xent(cfg, params["embed"], x, batch["labels"], batch.get("mask"))


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device="cuda"):
    """Self-attention k/v (num_layers, batch, max_seq, Hkv, dh), cross k/v
    (num_layers, batch, enc_seq, Hkv, dh), and ``t``, the next position."""
    Hkv, dh, Ld = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    self_shape = (Ld, batch, max_seq, Hkv, dh)
    cross_shape = (Ld, batch, cfg.enc_seq, Hkv, dh)
    mk = lambda s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return {
        "self_k": mk(self_shape),
        "self_v": mk(self_shape),
        "cross_k": mk(cross_shape),
        "cross_v": mk(cross_shape),
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_axes(cfg: ModelConfig):
    """Logical-axis tree matching ``make_cache`` (the reference's)."""
    kv = (None, "batch", "kvseq", "kv_heads", None)
    return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv, "t": ()}


def prefill(cfg: ModelConfig, params, batch, max_seq: int, cache_dtype=None, cache=None):
    """Encode the frames and run the decoder prompt, building the self and
    cross caches (filling ``cache`` when given, an all-zero cache of
    ``make_cache``'s structure); returns (last_token_logits (B, 1, V),
    cache)."""
    if spmd.is_dtensor(batch["tokens"]):
        logits = spmd.rows_local(
            lambda p_, b_, c_: prefill(cfg, p_, b_, max_seq, cache_dtype, cache=c_)[0],
            batch["tokens"], params, batch, states=(cache,))
        return logits, cache
    enc_out = encode(cfg, params, batch["frame_embeds"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cache is None:
        cache = make_cache(cfg, B, max_seq, cache_dtype or cfg.compute_dtype, tokens.device)
    x = _decoder(cfg, params, tokens, enc_out, cache)
    cache["t"] = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    return L.final_logits(cfg, params["embed"], x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """tokens: (B, 1) at the 0-d position ``cache["t"]`` -> (logits (B, 1,
    V), cache); the self k/v are written in place (at the last slot when
    the cache is full, as the reference's dynamic update clamps), and
    ``t`` is replaced by t + 1."""
    if spmd.is_dtensor(tokens):
        logits = spmd.rows_local(lambda p_, tok, c_: decode_step(cfg, p_, c_, tok)[0], tokens,
                                 params, tokens, states=(cache,))
        return logits, cache
    cd = cfg.compute_dtype
    t = cache["t"]
    B = tokens.shape[0]
    dh = cfg.head_dim
    x = L.embed(cfg, params["embed"], tokens)
    x = x + params["dec_pos"].index_select(0, t.long().reshape(1))[None].to(cd)
    S_max = cache["self_k"].shape[2]
    slot = t.long().clamp(max=S_max - 1).reshape(1)
    valid = torch.arange(S_max, device=x.device) <= t
    pos = t.long().expand(B)[:, None]
    for i, p in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
        p = spmd.gathered(p)
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        q, k, v = L._qk(cfg, p["attn"], _norm(cfg, x, p["ln1"]), pos)
        sk.index_copy_(1, slot, k.to(sk.dtype))
        sv.index_copy_(1, slot, v.to(sv.dtype))
        s = torch.einsum("bqhgk,bthk->bhgqt", q.to(cd), sk.to(cd)) * L._scale(cfg)
        s = torch.where(valid[None, None, None, None, :], s.float(), L.NEG_INF)
        w = torch.softmax(s, dim=-1).to(cd)
        out = torch.einsum("bhgqt,bthk->bqhgk", w, sv.to(cd)).reshape(B, 1, cfg.num_heads, dh)
        x = x + L._out_proj(cfg, p["attn"], out)
        kv = (cache["cross_k"][i], cache["cross_v"][i])
        x = x + _cross_attention(cfg, p["xattn"], _norm(cfg, x, p["ln_x"]), kv)
        x = x + L.mlp(cfg, p["mlp"], _norm(cfg, x, p["ln2"]))
    cache["t"] = t + 1
    x = _norm(cfg, x, params["final_norm"])
    return L.final_logits(cfg, params["embed"], x), cache
