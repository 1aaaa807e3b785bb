"""Streaming effective-sample-size estimation via batch means.

The FFT estimators in ``ess`` need the whole trajectory on the host.  The
accumulator below rides the executor's carry next to the Welford moments
and yields an ESS estimate in O(1) memory with no host sync.

Method, non-overlapping batch means (Glynn & Whitt): split the series into
batches of length ``b``; ``b`` times the variance of the batch means
estimates the spectral density at zero, sigma^2; then

    ESS = n * Var(x) / sigma^2_bm ,    sigma^2_bm = b * Var_m(batch means).

Elementwise over the probe array.  Moment arithmetic is f32 on the probe's
device; the counters are host ints (the step loop is on the host).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BatchMeansState(NamedTuple):
    """Running batch-means ESS accumulator for one probe array."""

    batch_len: int
    count: int  # samples seen
    batch_sum: torch.Tensor  # (probe shape) f32: sum within the open batch
    # Welford over completed batch means
    m_count: int
    m_mean: torch.Tensor
    m_m2: torch.Tensor
    # Welford over raw samples (for Var(x))
    x_mean: torch.Tensor
    x_m2: torch.Tensor


def batch_ess_init(template, batch_len: int) -> BatchMeansState:
    z = lambda: torch.zeros(template.shape, dtype=torch.float32, device=template.device)
    return BatchMeansState(batch_len=int(batch_len), count=0, batch_sum=z(), m_count=0,
                           m_mean=z(), m_m2=z(), x_mean=z(), x_m2=z())


def batch_ess_add(state: BatchMeansState, x) -> BatchMeansState:
    """One streaming update."""
    x = x.float()
    n = state.count + 1
    d = x - state.x_mean
    x_mean = state.x_mean + d / float(n)
    x_m2 = state.x_m2 + d * (x - x_mean)
    batch_sum = state.batch_sum + x
    m_count, m_mean, m_m2 = state.m_count, state.m_mean, state.m_m2
    if n % state.batch_len == 0:  # close the batch: fold its mean in
        bm = batch_sum / float(state.batch_len)
        m_count += 1
        dm = bm - m_mean
        m_mean = m_mean + dm / float(m_count)
        m_m2 = m_m2 + dm * (bm - m_mean)
        batch_sum = torch.zeros_like(batch_sum)
    return BatchMeansState(batch_len=state.batch_len, count=n, batch_sum=batch_sum,
                           m_count=m_count, m_mean=m_mean, m_m2=m_m2, x_mean=x_mean, x_m2=x_m2)


def batch_ess_estimate(state: BatchMeansState) -> torch.Tensor:
    """Elementwise ESS estimate (shaped like the probe): the raw sample
    count until two batches have closed, clipped to [1, n]."""
    n = float(state.count)
    m = float(state.m_count)
    var_x = state.x_m2 / max(n - 1.0, 1.0)
    var_bm = state.m_m2 / max(m - 1.0, 1.0)
    sigma2 = float(state.batch_len) * var_bm
    ess = n * var_x / torch.clamp(sigma2, min=1e-30)
    ess = torch.clamp(ess, min=1.0, max=max(n, 1.0))
    ready = (var_x > 0.0) & (m >= 2.0)
    return torch.where(ready, ess, torch.full_like(ess, max(n, 1.0)))
