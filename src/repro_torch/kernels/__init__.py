"""Hand-written CUDA kernels for Hopper (sm_90a), each with its plain
PyTorch version in ``ref``:

* flash_attention — causal blocked prefill attention
* paged_attention — single-token decode against a block-paged KV pool
* bma_select — BMA mixture over K members + temperature/top-k selection
* fused_ecsghmc — the one-pass Eq. 6 chain update of EC-SGHMC, with a
  scalar mass or a streamed diagonal M^-1 (the adaptive tier), and
  Box-Muller noise from given bits or in-kernel Philox

``ops`` dispatches: CPU tensors to ``ref``, CUDA tensors to the kernels.
"""
from . import ref
from .ops import (
    flash_attention,
    fused_bma_select,
    fused_ec_update,
    fused_ec_update_tree,
    fused_precond_ec_update,
    fused_precond_ec_update_tree,
    launches,
    paged_attention,
    reset_launches,
)

__all__ = [
    "flash_attention",
    "fused_bma_select",
    "fused_ec_update",
    "fused_ec_update_tree",
    "fused_precond_ec_update",
    "fused_precond_ec_update_tree",
    "launches",
    "paged_attention",
    "ref",
    "reset_launches",
]
