"""Streaming moment accumulation over trees of tensors (Welford / Chan).

The accumulator holds tensors on the samples' device, so a run can
accumulate stationary moments for millions of steps without a trajectory
and without a host sync.  All arithmetic is f32 regardless of the sample
dtype.  Leaves may carry a leading chain axis of size K: ``welford_*`` are
elementwise and agnostic to it; ``chain_summary`` pools over axis 0.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


class MomentState(NamedTuple):
    """Running (count, mean, M2) per element of the template tree."""

    count: torch.Tensor  # 0-d f32 (shared across leaves)
    mean: Any  # tree, f32
    m2: Any  # tree, f32: sum of squared deviations


def welford_init(template) -> MomentState:
    leaves = tree_leaves(template)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return MomentState(count=torch.zeros((), dtype=torch.float32, device=dev),
                       mean=tree_map(zeros, template), m2=tree_map(zeros, template))


def welford_add(state: MomentState, sample) -> MomentState:
    """One streaming update; O(1) memory."""
    n = state.count + 1.0
    means, m2s = [], []
    for mean, m2, x in zip(tree_leaves(state.mean), tree_leaves(state.m2), tree_leaves(sample)):
        x = x.float()
        delta = x - mean
        mean_new = mean + delta / n
        means.append(mean_new)
        m2s.append(m2 + delta * (x - mean_new))
    return MomentState(count=n, mean=tree_unflatten(state.mean, means),
                       m2=tree_unflatten(state.m2, m2s))


def welford_merge(a: MomentState, b: MomentState) -> MomentState:
    """Chan et al. parallel combine of two accumulators."""
    n = a.count + b.count
    wb = b.count / torch.clamp(n, min=1.0)
    means, m2s = [], []
    for ma, m2a, mb, m2b in zip(tree_leaves(a.mean), tree_leaves(a.m2),
                                tree_leaves(b.mean), tree_leaves(b.m2)):
        delta = mb - ma
        means.append(ma + delta * wb)
        m2s.append(m2a + m2b + delta * delta * (a.count * wb))
    return MomentState(count=n, mean=tree_unflatten(a.mean, means),
                       m2=tree_unflatten(a.m2, m2s))


def welford_mean(state: MomentState):
    return state.mean


def welford_var(state: MomentState, ddof: int = 0):
    """Per-element variance tree.  Zeros until count > ddof."""
    denom = torch.clamp(state.count - ddof, min=1.0)
    valid = (state.count > ddof).float()
    return tree_map(lambda m2: valid * m2 / denom, state.m2)


def welford_std(state: MomentState, ddof: int = 0):
    return tree_map(torch.sqrt, welford_var(state, ddof))


class ChainSummary(NamedTuple):
    """Chain-axis pooling of a MomentState whose leaves carry a leading
    chain axis."""

    pooled_mean: Any
    pooled_var: Any  # law of total variance
    between_chain_var: Any
    within_chain_var: Any


def chain_summary(state: MomentState, ddof: int = 0) -> ChainSummary:
    var = welford_var(state, ddof)
    quads = []
    for m, v in zip(tree_leaves(state.mean), tree_leaves(var)):
        between = torch.var(m, dim=0, unbiased=False)
        within = torch.mean(v, dim=0)
        quads.append((torch.mean(m, dim=0), within + between, between, within))
    unf = lambda i: tree_unflatten(state.mean, [q[i] for q in quads])
    return ChainSummary(pooled_mean=unf(0), pooled_var=unf(1), between_chain_var=unf(2),
                        within_chain_var=unf(3))
