"""Stochastic Gradient Langevin Dynamics (Welling & Teh, 2011).

    theta_{t+1} = theta_t - eps * grad Ũ(theta_t) + N(0, 2 eps)

First-order baseline; with identity preconditioning ``preconditioned_sgld``
reproduces it bit for bit.  Scalars are formed in float32 as the
reference forms them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .schedules import as_schedule
from .tree_util import leaf_normals, tree_leaves, tree_unflatten
from .types import Sampler

F32 = np.float32


class SGLDState(NamedTuple):
    step: int


def sgld(step_size, temperature: float = 1.0) -> Sampler:
    """Diagonal preconditioning lives in ``preconditioned_sgld``; this is
    the bare Welling-Teh update.  ``update(..., noise=tree)`` takes the
    standard normals (shaped like the gradients) instead of drawing them
    from ``rng``."""
    schedule = as_schedule(step_size)

    def init(params):
        del params
        return SGLDState(step=0)

    def update(grads, state, params=None, rng=None, noise=None):
        del params
        eps = F32(schedule(state.step))
        sigma = float(np.sqrt(F32(2.0) * eps * F32(temperature)))
        neg = float(-eps)
        updates = tree_unflatten(grads, [neg * g.float() + sigma * n for g, n in
                                         zip(tree_leaves(grads), leaf_normals(noise, rng, grads))])
        return updates, SGLDState(step=state.step + 1)

    return Sampler(init, update)
