"""Model registry: family -> ModelDef (the uniform model interface).  The
audio family is the encoder-decoder (``encdec``, dense decode only); every
other family is the decoder-only LM (``transformer``), whose paged
surface's ``check_support`` refuses recurrent layers (RG-LRU, mLSTM,
sLSTM), windowed attention and M-RoPE, as the reference's does."""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import encdec, transformer
from .common import ModelConfig


class PagedDef(NamedTuple):
    """Paged-KV decode surface; attn-only models."""

    check_support: Callable  # (cfg) -> None or raises ValueError
    make_pools: Callable  # (cfg, num_pages, block_size, dtype, device) -> pools
    prefill_write: Callable  # (cfg, pools, slot_cache, table_row, block_size) -> pools
    decode_step: Callable  # (cfg, params, pools, tokens, tables, ctx, write_block) -> (logits, pools)


class ModelDef(NamedTuple):
    param_specs: Callable  # (cfg) -> spec tree
    train_nll: Callable  # (cfg, params, batch) -> (sum_nll, count)
    prefill: Callable  # (cfg, params, batch, max_seq, cache_dtype) -> (logits, cache)
    decode_step: Callable  # (cfg, params, cache, tokens) -> (logits, cache)
    make_cache: Callable  # (cfg, batch, max_seq, dtype, device) -> cache; "meta": abstract
    cache_axes: Callable  # (cfg) -> logical-axis tree matching make_cache
    paged: PagedDef | None = None  # block-paged decode; None => dense-only


_LM = ModelDef(
    param_specs=transformer.param_specs,
    train_nll=transformer.train_nll,
    prefill=transformer.prefill,
    decode_step=transformer.decode_step,
    make_cache=transformer.make_cache,
    cache_axes=transformer.cache_axes,
    paged=PagedDef(
        check_support=transformer.check_paged_support,
        make_pools=transformer.make_paged_pools,
        prefill_write=transformer.paged_prefill_write,
        decode_step=transformer.paged_decode_step,
    ),
)


_ENCDEC = ModelDef(
    param_specs=encdec.param_specs,
    train_nll=encdec.train_nll,
    prefill=encdec.prefill,
    decode_step=encdec.decode_step,
    make_cache=encdec.make_cache,
    cache_axes=encdec.cache_axes,
)


def get_model(cfg: ModelConfig) -> ModelDef:
    return _ENCDEC if cfg.family == "audio" else _LM
