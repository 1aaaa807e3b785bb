"""Decoder-only LM: the dense family (attention blocks), the MoE family
(attention blocks whose FFN is a mixture of experts, olmoe and grok), the
hybrid family (RG-LRU blocks between local-attention blocks,
recurrentgemma), the ssm family (mLSTM and sLSTM blocks, xlstm) and the
vlm backbone (qwen2-vl: M-RoPE position streams, precomputed patch
embeddings prepended to the text).

Layers follow a repeating block *pattern*: params for pattern position i
are stacked with a leading (num_periods,) axis, exactly as in the
reference package, so weights cross one to one; the forward passes loop
over periods where the reference scans.  Remainder layers (depth %
period) are applied after the loop.

Entry points per model:
  train_nll(cfg, params, batch)            -> (sum_nll, token_count)
  prefill(cfg, params, batch, max_seq)     -> (last_logits, cache)
  decode_step(cfg, params, cache, tokens)  -> (logits, cache)
  paged_decode_step(cfg, params, pools, tokens, tables, ctx, write_block)
                                           -> (logits, pools)
Decode steps write their caches and pools IN PLACE and return them.
"""
from __future__ import annotations

import dataclasses

import torch

from . import layers as L
from . import moe as M
from . import recurrent as R
from . import spmd
from .common import LayerKind, ModelConfig, ParamSpec, tree_leaves, tree_map, tree_unflatten


_XLSTM = ("mlstm", "slstm")
_STATE_INIT = {"rglru": R.rglru_init_state, "mlstm": R.mlstm_init_state,
               "slstm": R.slstm_init_state}


# ---------------------------------------------------------------------------
# Spec stacking
# ---------------------------------------------------------------------------


def stack_specs(specs, n: int):
    return tree_map(lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=(None,) + s.axes),
                    specs)


def _block_specs(cfg: ModelConfig, kind: LayerKind) -> dict:
    if kind.kind == "rglru":
        return {"ln1": L.norm_spec(cfg), "mix": R.rglru_specs(cfg), "ln2": L.norm_spec(cfg),
                "mlp": L.mlp_specs(cfg)}
    if kind.kind in _XLSTM:  # the block carries its own projections: no FFN
        mix = R.mlstm_specs(cfg) if kind.kind == "mlstm" else R.slstm_specs(cfg)
        return {"ln1": L.norm_spec(cfg), "mix": mix}
    if kind.kind != "attn":
        raise ValueError(kind.kind)
    sp = {"ln1": L.norm_spec(cfg), "attn": L.attn_specs(cfg), "ln2": L.norm_spec(cfg),
          "mlp": M.moe_specs(cfg) if kind.moe else L.mlp_specs(cfg)}
    if cfg.sandwich_norm:
        sp["post_ln1"] = L.norm_spec(cfg)
        sp["post_ln2"] = L.norm_spec(cfg)
    return sp


def _layout(cfg: ModelConfig):
    """(pattern P, num_periods, remainder kinds)."""
    P = len(cfg.pattern)
    n_periods = cfg.num_layers // P
    rem_kinds = cfg.layer_kinds[n_periods * P:]
    return P, n_periods, rem_kinds


def param_specs(cfg: ModelConfig) -> dict:
    P, n_periods, rem_kinds = _layout(cfg)
    specs = {
        "embed": L.embed_specs(cfg),
        "layers": {
            str(i): stack_specs(_block_specs(cfg, cfg.pattern[i]), n_periods)
            for i in range(P)
        },
        "final_norm": L.norm_spec(cfg),
    }
    if rem_kinds:
        specs["rem"] = {str(i): _block_specs(cfg, k) for i, k in enumerate(rem_kinds)}
    return specs


def _blocks(cfg: ModelConfig, tree):
    """(kind, subtree) per layer in execution order: period n, pattern
    position i reads ``tree["layers"][str(i)]`` at index n; then the
    remainder layers."""
    P, n_periods, rem_kinds = _layout(cfg)
    for n in range(n_periods):
        for i in range(P):
            yield cfg.pattern[i], tree_map(lambda a: a[n], tree["layers"][str(i)])
    for i, kind in enumerate(rem_kinds):
        yield kind, tree["rem"][str(i)]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _norm(cfg, x, w):
    return L.rms_norm(x, w, cfg.norm_eps, cfg.norm_scale_offset)


def _ffn_tail(cfg, kind, p, x, h):
    """The attention block after its mixer: residual, then the dense or
    MoE FFN (the one place either runs for every entry point)."""
    if cfg.sandwich_norm:
        h = _norm(cfg, h, p["post_ln1"])
    x = x + h
    h_in = _norm(cfg, x, p["ln2"])
    h = M.moe_ffn(cfg, p["mlp"], h_in) if kind.moe else L.mlp(cfg, p["mlp"], h_in)
    if cfg.sandwich_norm:
        h = _norm(cfg, h, p["post_ln2"])
    return x + h


def _rglru_tail(cfg, p, x, h):
    x = x + h
    return x + L.mlp(cfg, p["mlp"], _norm(cfg, x, p["ln2"]))


def _rglru_layer(cfg, p, x):
    """An RG-LRU block on the full sequence: (x out, the mixer's final state)."""
    h, state = R.rglru_block(cfg, p["mix"], _norm(cfg, x, p["ln1"]))
    return _rglru_tail(cfg, p, x, h), state


def apply_block(cfg: ModelConfig, kind: LayerKind, p, x, positions):
    p = spmd.gathered(p)  # FSDP: a DTensor block's weights whole at use
    return spmd.rows(_apply_block(cfg, kind, p, spmd.rows(x), positions))


def _apply_block(cfg: ModelConfig, kind: LayerKind, p, x, positions):
    if kind.kind == "attn":
        h = L.attention(cfg, p["attn"], _norm(cfg, x, p["ln1"]), positions, kind.window)
        return _ffn_tail(cfg, kind, p, x, h)
    if kind.kind == "rglru":
        return _rglru_layer(cfg, p, x)[0]
    if kind.kind == "mlstm":
        return x + R.mlstm_block(cfg, p["mix"], _norm(cfg, x, p["ln1"]))
    if kind.kind == "slstm":
        return x + R.slstm_block(cfg, p["mix"], _norm(cfg, x, p["ln1"]))[0]
    raise ValueError(kind.kind)


def decode_block(cfg: ModelConfig, kind: LayerKind, p, x, cache, t):
    p = spmd.gathered(p)  # FSDP: a DTensor block's weights whole at use
    return spmd.rows(_decode_block(cfg, kind, p, spmd.rows(x), cache, t))


def _decode_block(cfg: ModelConfig, kind: LayerKind, p, x, cache, t):
    if kind.kind == "attn":
        h, _ = L.decode_attention(cfg, p["attn"], _norm(cfg, x, p["ln1"]), cache["attn"], t,
                                  kind.window)
        return _ffn_tail(cfg, kind, p, x, h)
    if kind.kind == "rglru":
        h, _ = R.rglru_decode(cfg, p["mix"], _norm(cfg, x, p["ln1"]), cache["mix"])
        return _rglru_tail(cfg, p, x, h)
    if kind.kind == "mlstm":
        return x + R.mlstm_decode(cfg, p["mix"], _norm(cfg, x, p["ln1"]), cache["mix"])[0]
    if kind.kind == "slstm":
        return x + R.slstm_decode(cfg, p["mix"], _norm(cfg, x, p["ln1"]), cache["mix"])[0]
    raise ValueError(kind.kind)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device="cuda"):
    """Dense decode cache, plus ``t``, the next position (0-d).  Per
    pattern layer: attention k/v leaves (n_periods, batch, L, Hkv, dh), or
    a recurrent state with batch after the n_periods axis: RG-LRU h
    (.., R) f32 and conv (.., W-1, R); mLSTM C (.., NH, dh, dh), n, m f32
    and conv (.., 3, up); sLSTM h, c, n, m (.., NH, dh) f32.  Remainder
    layers drop the n_periods axis."""
    P, n_periods, rem_kinds = _layout(cfg)

    def one(kind, lead):
        if kind.kind == "attn":
            return {"attn": L.init_cache(cfg, batch, max_seq, kind.window, dtype, device, lead)}
        if kind.kind not in _STATE_INIT:
            raise ValueError(kind.kind)
        return {"mix": _STATE_INIT[kind.kind](cfg, batch, dtype, device, lead)}

    cache = {
        "layers": {str(i): one(cfg.pattern[i], (n_periods,)) for i in range(P)},
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }
    if rem_kinds:
        cache["rem"] = {str(i): one(k, ()) for i, k in enumerate(rem_kinds)}
    return cache


def _block_cache_axes(kind: LayerKind, stacked: bool):
    lead = (None,) if stacked else ()
    if kind.kind == "attn":
        kv = lead + ("batch", "kvseq", "kv_heads", None)
        return {"attn": {"k": kv, "v": kv}}
    if kind.kind == "rglru":
        return {"mix": {"h": lead + ("batch", "rnn"), "conv": lead + ("batch", None, "rnn")}}
    if kind.kind == "mlstm":
        return {"mix": {"C": lead + ("batch", "heads", None, None),
                        "n": lead + ("batch", "heads", None), "m": lead + ("batch", "heads"),
                        "conv": lead + ("batch", None, "mlp")}}
    if kind.kind == "slstm":
        ax = lead + ("batch", "heads", None)
        return {"mix": {"h": ax, "c": ax, "n": ax, "m": ax}}
    raise ValueError(kind.kind)


def cache_axes(cfg: ModelConfig):
    """Logical-axis tree matching ``make_cache``'s structure (the sharding
    rules' input), the reference's leaf for leaf."""
    P, n_periods, rem_kinds = _layout(cfg)
    out = {"layers": {str(i): _block_cache_axes(cfg.pattern[i], True) for i in range(P)},
           "t": ()}
    if rem_kinds:
        out["rem"] = {str(i): _block_cache_axes(k, False) for i, k in enumerate(rem_kinds)}
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _positions(cfg: ModelConfig, batch, B, S, device):
    """``batch["positions"]`` when given ((B, S), or (3, B, S) for
    M-RoPE), else the arange, broadcast to the 3 streams under M-RoPE."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, B, S)
    return pos


def _embed_inputs(cfg: ModelConfig, params, batch):
    """Token embeddings, with precomputed patch embeddings (vlm) prepended."""
    x = L.embed(cfg, params["embed"], batch["tokens"])
    if "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def checkpointed(fn, x, tree):
    """``fn(x, tree)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant: ``torch.autograd.grad``
    takes it), when autograd would record it: grad mode on and ``x`` or a
    leaf of ``tree`` requiring grad.  Otherwise ``fn`` runs as it is, so
    serving never enters the checkpoint.  ``tree``'s leaves are the
    checkpoint's inputs: a DTensor block's sharded weights, gathered inside
    ``fn``, so the gathered copies are not kept for the backward pass.  No
    forward of the models draws random numbers, so the RNG state is not
    saved (a card's RNG state cannot be captured under fake tensors)."""
    leaves = tree_leaves(tree)
    grads = x.requires_grad or any(t.requires_grad for t in leaves)
    if not (torch.is_grad_enabled() and grads):
        return fn(x, tree)
    if torch._C._are_functorch_transforms_active():
        raise RuntimeError(
            "rematerialisation (cfg.remat='full', and every whisper layer) runs "
            "torch.utils.checkpoint, which torch.func transforms (core.chainwise) do not "
            "support: build the config with remat='none' to take gradients under torch.func")
    from torch.utils.checkpoint import checkpoint

    return checkpoint(lambda x_, *ls: fn(x_, tree_unflatten(tree, ls)), x, *leaves,
                      use_reentrant=False, preserve_rng_state=False)


def backbone(cfg: ModelConfig, params, x, positions, remat: bool | None = None):
    """Every block, then the final norm.  With ``remat`` (None: ``cfg.remat
    == "full"``) each period of the P pattern layers is checkpointed: its
    forward is recomputed in the backward pass and nothing inside it is
    kept, as the reference wraps its scanned period in
    ``jax.checkpoint(..., policy=nothing_saveable)``; the remainder layers
    are not.  The values are the same bit for bit either way.  The stacked
    layer leaves are unbound once, so the backward pass writes each leaf's
    gradient in one stack (indexing per layer would build one full-size
    gradient per layer)."""
    P, n_periods, rem_kinds = _layout(cfg)
    if remat is None:
        remat = cfg.remat == "full"

    def period(x, pslice):
        for i in range(P):
            x = apply_block(cfg, cfg.pattern[i], pslice[str(i)], x, positions)
        return x

    per = [tree_map(lambda a: a.unbind(0), params["layers"][str(i)]) for i in range(P)]
    for n in range(n_periods):
        pslice = {str(i): tree_map(lambda a: a[n], per[i]) for i in range(P)}
        x = checkpointed(period, x, pslice) if remat else period(x, pslice)
    for i, kind in enumerate(rem_kinds):
        x = apply_block(cfg, kind, params["rem"][str(i)], x, positions)
    return _norm(cfg, x, params["final_norm"])


def train_nll(cfg: ModelConfig, params, batch):
    """batch: tokens (B, S), labels (B, S), optional mask/positions, and
    optional patch_embeds (B, P, D) prepended to the tokens (the labels
    cover the text only).  Returns (sum_nll, token_count)."""
    x = _embed_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(cfg, batch, B, S, x.device)
    x = backbone(cfg, params, x, positions)
    n_prefix = S - batch["labels"].shape[1]
    if n_prefix:
        x = x[:, n_prefix:]
    return L.chunked_xent(cfg, params["embed"], x, batch["labels"], batch.get("mask"))


def _prefill_block(cfg, kind, p, x, cache, positions):
    """apply_block + fill this layer's cache (a view, written in place)
    from the full-sequence pass.  An RG-LRU or sLSTM layer's state comes
    out of its one scan; an mLSTM layer's from the decode recurrence run
    over the prompt."""
    p = spmd.gathered(p)
    if kind.kind == "rglru":
        x, state = _rglru_layer(cfg, p, x)
        for key, val in state.items():
            spmd.copy_(cache["mix"][key], val)
        return x
    if kind.kind == "mlstm":
        return x + R.mlstm_block(cfg, p["mix"], _norm(cfg, x, p["ln1"]), cache["mix"])
    if kind.kind == "slstm":
        out, state = R.slstm_block(cfg, p["mix"], _norm(cfg, x, p["ln1"]))
        for key, val in state.items():
            spmd.copy_(cache["mix"][key], val)
        return x + out
    if kind.kind != "attn":
        raise ValueError(kind.kind)
    xin = _norm(cfg, x, p["ln1"])
    if spmd.is_dtensor(xin):
        # every head's k/v on the rank's rows into a zero cache of those
        # rows, then each rank keeps its block of it
        p_l = spmd.attn_weights(p["attn"], spmd.heads_plan(cfg, xin, False, False))
        _, k, v = L._qk(cfg, p_l, spmd.local_rows(xin, xin),
                        spmd.local_rows(positions, xin, positions.ndim - 2))
        c_l = {name: torch.zeros(k.shape[:1] + leaf.shape[1:], dtype=leaf.dtype,
                                 device=k.device) for name, leaf in cache["attn"].items()}
        _fill_attn_cache(kind, k, v, c_l["k"], c_l["v"])
        spmd.write_back(cache["attn"], c_l, xin)
    else:
        _, k, v = L._qk(cfg, p["attn"], xin, positions)
        _fill_attn_cache(kind, k, v, cache["attn"]["k"], cache["attn"]["v"])
    return apply_block(cfg, kind, p, x, positions)


def _fill_attn_cache(kind, k, v, ck, cv):
    """A prefill's k/v (B, S, Hkv, dh) into an attention layer's cache."""
    Lc = ck.shape[1]
    S = k.shape[1]
    if S >= Lc:  # window (or exactly-full) cache: keep the last Lc entries
        kk, vv = k[:, S - Lc:], v[:, S - Lc:]
        if kind.window and S > Lc:
            # ring-buffer alignment: slot j holds pos with pos % Lc == j
            kk, vv = torch.roll(kk, S % Lc, dims=1), torch.roll(vv, S % Lc, dims=1)
        ck.copy_(kk)
        cv.copy_(vv)
    else:
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)


def prefill(cfg: ModelConfig, params, batch, max_seq: int, cache_dtype=None, cache=None):
    """Run the full prompt (patch embeddings first, where given), building
    the decode cache (filling ``cache`` when given, an all-zero cache of
    ``make_cache``'s structure); returns (last_token_logits (B,1,V),
    cache)."""
    x = _embed_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(cfg, batch, B, S, x.device)
    if cache is None:
        cache = make_cache(cfg, B, max_seq, cache_dtype or cfg.compute_dtype, x.device)
    for (kind, p), (_, c) in zip(_blocks(cfg, params), _blocks(cfg, cache)):
        x = _prefill_block(cfg, kind, p, x, c, positions)
    cache["t"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    x = _norm(cfg, x, params["final_norm"])
    logits = L.final_logits(cfg, params["embed"], x[:, -1:])
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B,1,V), cache).  One new position per
    row; ``cache["t"]`` is 0-d or (B,) (per-row positions).  The k/v leaves
    are written in place; ``t`` is replaced by t + 1."""
    t = cache["t"]
    x = L.embed(cfg, params["embed"], tokens)
    for (kind, p), (_, c) in zip(_blocks(cfg, params), _blocks(cfg, cache)):
        x = decode_block(cfg, kind, p, x, c, t)
    cache["t"] = t + 1
    x = _norm(cfg, x, params["final_norm"])
    return L.final_logits(cfg, params["embed"], x), cache


# ---------------------------------------------------------------------------
# Paged decode (block-paged KV pools)
# ---------------------------------------------------------------------------


def check_paged_support(cfg: ModelConfig) -> None:
    """Paged pools hold absolute-position pages, so every layer must be
    non-windowed attention and RoPE must be single-stream."""
    for kind in cfg.layer_kinds:
        if kind.kind != "attn":
            raise ValueError(f"paged decode supports attn-only models, got {kind.kind!r}")
        if kind.window:
            raise ValueError("paged decode does not support sliding-window layers")
    if cfg.mrope_sections is not None:
        raise ValueError("paged decode does not support M-RoPE position streams")


def make_paged_pools(cfg: ModelConfig, num_pages: int, block_size: int, dtype, device="cuda"):
    """Flat page pools mirroring the make_cache layer structure: leaves
    (n_periods, num_pages, bs, Hkv, dh) for pattern layers (page 0 is the
    reserved sink).  No "t" leaf: positions live in the engine's per-slot
    context lengths."""
    check_paged_support(cfg)
    P, n_periods, rem_kinds = _layout(cfg)

    def one(lead):
        return {"attn": L.init_page_pool(cfg, num_pages, block_size, dtype, device, lead)}

    pools = {"layers": {str(i): one((n_periods,)) for i in range(P)}}
    if rem_kinds:
        pools["rem"] = {str(i): one(()) for i in range(len(rem_kinds))}
    return pools


def _scatter_pages(pool_leaf, cache_leaf, table_row, block_size, stacked):
    """Write one slot's dense prefill cache (.., 1, L, Hkv, dh) into its
    table row's pages, in place.  L is ceil-padded to M*bs; overflow blocks
    land in whatever table_row maps them to — the sink for unallocated
    tails."""
    M = table_row.shape[0]
    c = cache_leaf[:, 0] if stacked else cache_leaf[0]  # (P?, L, Hkv, dh)
    seq_ax = 1 if stacked else 0
    pad = M * block_size - c.shape[seq_ax]
    if pad:
        widths = [0, 0] * (c.ndim - seq_ax - 1) + [0, pad]
        c = torch.nn.functional.pad(c, widths)
    blocks = c.reshape(c.shape[:seq_ax] + (M, block_size) + c.shape[seq_ax + 1:])
    idx = table_row.long()
    if stacked:
        pool_leaf[:, idx] = blocks.to(pool_leaf.dtype)
    else:
        pool_leaf[idx] = blocks.to(pool_leaf.dtype)
    return pool_leaf


def paged_prefill_write(cfg: ModelConfig, pools, slot_cache, table_row, block_size: int):
    """Scatter a freshly prefilled slot cache (from :func:`prefill` with
    batch=1) into the paged pools along ``table_row`` (M,) int32, in place.
    Shared prefix pages are rewritten with bit-identical content."""
    P, n_periods, rem_kinds = _layout(cfg)
    for i in range(P):
        for kk in ("k", "v"):
            _scatter_pages(pools["layers"][str(i)]["attn"][kk],
                           slot_cache["layers"][str(i)]["attn"][kk],
                           table_row, block_size, stacked=True)
    for i in range(len(rem_kinds)):
        for kk in ("k", "v"):
            _scatter_pages(pools["rem"][str(i)]["attn"][kk],
                           slot_cache["rem"][str(i)]["attn"][kk],
                           table_row, block_size, stacked=False)
    return pools


def paged_decode_step(cfg: ModelConfig, params, pools, tokens, block_tables,
                      context_lens, write_block):
    """All-slots-jointly decode: tokens (S, 1), block_tables (S, M) int32,
    context_lens (S,) int32 current positions, write_block (S,) int32
    destination pages.  Returns (logits (S, 1, V), pools) with the pools
    written in place."""
    x = L.embed(cfg, params["embed"], tokens)
    for (kind, p), (_, pool) in zip(_blocks(cfg, params), _blocks(cfg, pools)):
        h, _ = L.paged_decode_attention(
            cfg, p["attn"], _norm(cfg, x, p["ln1"]), pool["attn"],
            block_tables, context_lens, write_block,
        )
        x = _ffn_tail(cfg, kind, p, x, h)
    x = _norm(cfg, x, params["final_norm"])
    return L.final_logits(cfg, params["embed"], x), pools
