"""Cross-chain / ensemble dispersion summaries.  Every function reduces a
chain-stacked nested dict (leading axis K on every leaf) to a handful of
scalars."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_leaves


def cross_chain_spread(tree) -> torch.Tensor:
    """Element-weighted mean over all parameters of the per-element
    variance across the leading chain axis.  0 ⇔ all chains identical."""
    num, den = None, 0
    for leaf in tree_leaves(tree):
        v = torch.var(leaf.float(), dim=0, unbiased=False)
        s = torch.sum(v)
        num = s if num is None else num + s
        den += int(v.numel())
    return num / max(den, 1)


def ensemble_spread_device(params_stack) -> dict:
    """Reduce a (K, ...)-stacked ensemble to 0-d tensors on its device (no
    host sync): chain spread, mean parameter norm and the scale-free
    ``rel_spread`` (per-element cross-chain std over the RMS parameter)."""
    leaves = tree_leaves(params_stack)
    k = int(leaves[0].shape[0])
    n_per_chain = max(sum(int(l.numel()) for l in leaves) // max(k, 1), 1)
    spread = cross_chain_spread(params_stack)
    sq = sum(torch.sum(l.float() ** 2, dim=tuple(range(1, l.ndim))) for l in leaves)
    norms = torch.sqrt(sq)  # (K,)
    rms_param = torch.mean(norms) / n_per_chain ** 0.5
    return {
        "chain_spread": spread,
        "mean_param_norm": torch.mean(norms),
        "rel_spread": torch.sqrt(spread) / torch.clamp(rms_param, min=1e-12),
    }


def ensemble_spread(params_stack) -> dict:
    """Serving-side ensemble health as host floats: how dispersed the K
    posterior samples are (a collapsed ensemble is a silent BMA no-op).
    ``rel_spread`` is scale-free: per-element cross-chain std over the RMS
    parameter magnitude.  Host-syncing wrapper around
    :func:`ensemble_spread_device`."""
    leaves = tree_leaves(params_stack)
    out = {k: float(v) for k, v in ensemble_spread_device(params_stack).items()}
    out["num_chains"] = int(leaves[0].shape[0])
    return out


def chain_center_rms(tree, center) -> torch.Tensor:
    """RMS distance of chains from a center tree (leaves without the chain
    axis): sqrt(mean_i,elem (θⁱ - c)²), the elastic-coupling energy scale."""
    num, den = None, 0
    for leaf, c in zip(tree_leaves(tree), tree_leaves(center)):
        d = leaf.float() - c.float()[None]
        s = torch.sum(d * d)
        num = s if num is None else num + s
        den += int(d.numel())
    return torch.sqrt(num / max(den, 1))


def pooled_moments(trajectory) -> tuple[np.ndarray, np.ndarray]:
    """(mean, var) per trailing dimension of a (chains, samples, *dims)
    trajectory, pooled over chains and samples: the estimate the stationary
    battery compares against the oracle."""
    x = np.asarray(trajectory, np.float64)
    flat = x.reshape(-1, *x.shape[2:])
    return flat.mean(axis=0), flat.var(axis=0)
