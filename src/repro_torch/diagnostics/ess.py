"""Effective sample size and split-R̂ (host-side numpy, post-hoc): a copy
of ``repro/diagnostics/ess.py``, which imports no framework.

Implements the Stan/Vehtari-et-al. estimators: per-chain autocorrelation
via FFT, cross-chain pooling through the between/within decomposition, and
Geyer's initial monotone positive sequence for truncation.  Inputs are
``(num_chains, num_samples)`` arrays (a 1-D array is treated as one chain);
``*_nd`` variants map the estimator over trailing sample dimensions.

These run on trajectories AFTER sampling — they are numpy on purpose (no
tracing, no device transfers beyond the trajectory itself).
"""
from __future__ import annotations

import numpy as np


def _as_chains(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"expected (chains, samples) or (samples,), got {x.shape}")
    return x


def autocorrelation(x) -> np.ndarray:
    """Per-chain autocorrelation function via FFT.  (M, N) -> (M, N),
    rho[:, 0] == 1.  Constant chains return zeros past lag 0."""
    x = _as_chains(x)
    m, n = x.shape
    x = x - x.mean(axis=1, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n] / n
    var0 = acov[:, :1]
    safe = np.where(var0 > 0, var0, 1.0)
    rho = acov / safe
    rho[:, 0] = 1.0
    return np.where(var0 > 0, rho, np.concatenate([np.ones((m, 1)), np.zeros((m, n - 1))], 1))


def effective_sample_size(x) -> float:
    """Multi-chain ESS (Vehtari et al. 2021 / Stan).  Cross-chain mean
    disagreement deflates ESS through the between-chain variance term, so
    unconverged chains report honestly small values."""
    x = _as_chains(x)
    m, n = x.shape
    if n < 4:
        return float(m * n)
    chain_var = x.var(axis=1, ddof=1)
    w = chain_var.mean()
    var_plus = w * (n - 1) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0 or w <= 0:
        return float(m * n)

    # mean-over-chains autocovariance at each lag, pooled rho_t
    acov = autocorrelation(x) * chain_var[:, None] * (n - 1) / n
    rho = 1.0 - (w - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0

    # Geyer: pair sums, truncate at first negative pair, enforce monotone
    n_pairs = len(rho) // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
    tau = 0.0
    running_min = np.inf
    for k, p in enumerate(pairs):
        if p < 0 and k > 0:
            break
        running_min = min(running_min, max(p, 0.0))
        tau += 2.0 * running_min
    tau = max(tau - 1.0, 1.0 / (m * n))  # -1: lag-0 double count in pair sums
    return float(min(m * n / tau, m * n * np.log10(max(m * n, 10))))


def coupled_ess(x) -> float:
    """Conservative ESS for COUPLED chains.  The multi-chain estimator
    above assumes independent chains and overstates ESS by up to K× when
    chains co-move — which is elastic coupling's whole point.  Collapsing
    to the chain-mean series treats the K chains as a single chain: a
    lower bound that is tight when coupling is strong.  Use this (or
    report both) whenever the chains interact."""
    x = _as_chains(x)
    return effective_sample_size(x.mean(axis=0))


def coupled_ess_nd(x) -> np.ndarray:
    """Per-dimension conservative ESS for (chains, samples, *dims)."""
    return _map_trailing(coupled_ess, x)


def split_rhat(x) -> float:
    """Split-R̂: each chain halved, potential scale reduction across the 2M
    half-chains.  ~1.0 at convergence; > ~1.01 flags trouble."""
    x = _as_chains(x)
    m, n = x.shape
    half = n // 2
    if half < 2:
        return float("nan")
    halves = np.concatenate([x[:, :half], x[:, n - half :]], axis=0)  # (2M, half)
    w = halves.var(axis=1, ddof=1).mean()
    b = half * halves.mean(axis=1).var(ddof=1)
    if w <= 0:
        # frozen chains: identical constants are (vacuously) converged, but
        # DISTINCT constants are the starkest possible divergence
        return 1.0 if b <= 0 else float("inf")
    var_plus = (half - 1) / half * w + b / half
    return float(np.sqrt(var_plus / w))


def _map_trailing(fn, x):
    """Apply a (chains, samples) estimator over trailing dims of
    (M, N, *dims) — returns an array shaped ``dims``."""
    x = np.asarray(x, np.float64)
    if x.ndim < 2:
        raise ValueError(f"need at least (chains, samples), got {x.shape}")
    m, n = x.shape[:2]
    flat = x.reshape(m, n, -1)
    out = np.array([fn(flat[:, :, d]) for d in range(flat.shape[2])])
    return out.reshape(x.shape[2:]) if x.ndim > 2 else out.reshape(())


def effective_sample_size_nd(x) -> np.ndarray:
    """Per-dimension ESS for (chains, samples, *dims) trajectories."""
    return _map_trailing(effective_sample_size, x)


def split_rhat_nd(x) -> np.ndarray:
    """Per-dimension split-R̂ for (chains, samples, *dims) trajectories."""
    return _map_trailing(split_rhat, x)
