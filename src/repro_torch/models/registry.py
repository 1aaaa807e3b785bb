"""Model registry: family -> ModelDef (the uniform model interface).  The
dense, MoE and hybrid (recurrentgemma) families are ported; the paged
surface's ``check_support`` refuses the hybrid family's RG-LRU layers and
windowed attention, as the reference's does."""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import transformer
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
    make_cache: Callable  # (cfg, batch, max_seq, dtype, device) -> cache
    paged: PagedDef | None = None  # block-paged decode; None => dense-only


_LM = ModelDef(
    param_specs=transformer.param_specs,
    train_nll=transformer.train_nll,
    prefill=transformer.prefill,
    decode_step=transformer.decode_step,
    make_cache=transformer.make_cache,
    paged=PagedDef(
        check_support=transformer.check_paged_support,
        make_pools=transformer.make_paged_pools,
        prefill_write=transformer.paged_prefill_write,
        decode_step=transformer.paged_decode_step,
    ),
)


def get_model(cfg: ModelConfig) -> ModelDef:
    if cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported; only 'dense', 'moe' and 'hybrid'")
    return _LM
