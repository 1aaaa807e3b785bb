"""Posterior-predictive serving engine of the port: continuous batching over
a fixed slot axis, dense or block-paged KV pools, and Bayesian model
averaging over K ensemble members (optionally through the fused bma_select
kernel)."""
from .bma import BMA_MODES, fused_mixture_select, mixture_logprobs, reference_bma_decode
from .cache_pool import BlockAllocator, CachePool, PagedCachePool, PagedParked, ParkedCache
from .engine import ServeEngine, ServeReport
from .registry import SnapshotRegistry
from .scheduler import FCFSQueue, Request, RequestResult, synthetic_trace

__all__ = [
    "BMA_MODES",
    "BlockAllocator",
    "CachePool",
    "FCFSQueue",
    "PagedCachePool",
    "PagedParked",
    "ParkedCache",
    "Request",
    "RequestResult",
    "ServeEngine",
    "ServeReport",
    "SnapshotRegistry",
    "fused_mixture_select",
    "mixture_logprobs",
    "reference_bma_decode",
    "synthetic_trace",
]
