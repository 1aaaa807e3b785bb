"""Convergence diagnostics of the port:

- ``moments``   — streaming Welford accumulators over trees of tensors;
- ``streaming`` — batch-means ESS that rides the executor's carry;
- ``ess``       — FFT ESS and split-R̂ (host numpy, a copy of the
  reference's);
- ``spread``    — cross-chain / ensemble dispersion scalars.

The exact Gaussian oracle stays in the reference package: the port's
tests gate against it, and ``chip_smoke.py`` carries its numbers.
"""
from .ess import (
    autocorrelation,
    coupled_ess,
    coupled_ess_nd,
    effective_sample_size,
    effective_sample_size_nd,
    split_rhat,
    split_rhat_nd,
)
from .moments import (
    ChainSummary,
    MomentState,
    chain_summary,
    welford_add,
    welford_init,
    welford_mean,
    welford_merge,
    welford_std,
    welford_var,
)
from .spread import (
    chain_center_rms,
    cross_chain_spread,
    ensemble_spread,
    ensemble_spread_device,
    pooled_moments,
)
from .streaming import BatchMeansState, batch_ess_add, batch_ess_estimate, batch_ess_init

__all__ = [
    "BatchMeansState",
    "ChainSummary",
    "MomentState",
    "autocorrelation",
    "batch_ess_add",
    "batch_ess_estimate",
    "batch_ess_init",
    "chain_center_rms",
    "chain_summary",
    "coupled_ess",
    "coupled_ess_nd",
    "cross_chain_spread",
    "effective_sample_size",
    "effective_sample_size_nd",
    "ensemble_spread",
    "ensemble_spread_device",
    "pooled_moments",
    "split_rhat",
    "split_rhat_nd",
    "welford_add",
    "welford_init",
    "welford_mean",
    "welford_merge",
    "welford_std",
    "welford_var",
]
