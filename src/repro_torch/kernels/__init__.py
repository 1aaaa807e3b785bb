"""Hand-written CUDA kernels for Hopper (sm_90a) on the serving path, each
with its plain PyTorch version in ``ref``:

* flash_attention — causal blocked prefill attention
* paged_attention — single-token decode against a block-paged KV pool
* bma_select — BMA mixture over K members + temperature/top-k selection

``ops`` dispatches: CPU tensors to ``ref``, CUDA tensors to the kernels.
"""
from . import ref
from .ops import flash_attention, fused_bma_select, launches, paged_attention, reset_launches

__all__ = [
    "flash_attention",
    "fused_bma_select",
    "launches",
    "paged_attention",
    "ref",
    "reset_launches",
]
