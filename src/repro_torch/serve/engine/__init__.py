"""Posterior-predictive serving engine of the port: continuous batching over
a fixed slot axis, dense or block-paged KV pools, Bayesian model averaging
over K ensemble members (optionally through the fused bma_select kernel),
and live snapshot refresh from a background coupled-sampler run gated by
ensemble-spread diagnostics — synchronous (``ChainRefresher``) or
overlapped with decode on a side CUDA stream (``RefreshScheduler``)."""
from .bma import BMA_MODES, fused_mixture_select, mixture_logprobs, reference_bma_decode
from .cache_pool import BlockAllocator, CachePool, PagedCachePool, PagedParked, ParkedCache
from .engine import ServeEngine, ServeReport
from .refresh import RefreshScheduler
from .registry import ChainRefresher, SnapshotRegistry
from .scheduler import FCFSQueue, Request, RequestResult, synthetic_trace

__all__ = [
    "BMA_MODES",
    "BlockAllocator",
    "CachePool",
    "ChainRefresher",
    "FCFSQueue",
    "PagedCachePool",
    "PagedParked",
    "ParkedCache",
    "RefreshScheduler",
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
