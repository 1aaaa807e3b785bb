"""Preconditioned SGLD (Li et al., 2016, pSGLD) with burn-in-frozen
diagonal RMSProp/Adam preconditioning:

    theta_{t+1} = theta_t − ε M⁻¹ ∇Ũ(theta_t) + N(0, 2 ε T M⁻¹)

The Γ(θ) curvature-drift term of the full pSGLD update is omitted: it is
O(1 − decay) while M⁻¹ adapts and exactly zero once adaptation freezes
(step ≥ burnin).  With identity preconditioning (``decay=1.0,
precond_eps=0.0``) the trajectory is bit for bit plain ``sgld``'s: the same
noise draw and the same term grouping.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng as rnglib
from .preconditioner import PrecondState, get_preconditioner
from .scale_adapted import _v_mean
from .schedules import as_schedule
from .tree_util import tree_leaves, tree_random_normal, tree_unflatten
from .types import Sampler

F32 = np.float32


class PSGLDState(NamedTuple):
    precond: PrecondState


def preconditioned_sgld(
    step_size,
    temperature: float = 1.0,
    burnin: int = 1000,
    decay: float = 0.99,
    precond_eps: float = 1e-8,
    precond: str = "rmsprop",
) -> Sampler:
    """``precond``: "rmsprop" (pSGLD's choice) or "adam" (bias-corrected
    second moment; ``decay`` is β₂ there).  Both freeze at ``burnin``.
    ``update(..., noise=tree)`` takes the standard normals (shaped like the
    gradients) instead of drawing them from ``rng``."""
    schedule = as_schedule(step_size)
    pre = get_preconditioner(precond, burnin=burnin, decay=decay, eps=precond_eps)

    def init(params):
        return PSGLDState(precond=pre.init(params))

    def update(grads, state, params=None, rng=None, noise=None):
        del params
        step = state.precond.step
        eps = F32(schedule(step))
        if noise is None:
            dev = tree_leaves(grads)[0].device
            noise = tree_random_normal(rnglib.generator(rng, dev), grads, torch.float32)
        # grouping as sgld's: (-eps·m)·g and sqrt((2 eps T)·m)·n, so that
        # m == 1.0 reproduces the plain-SGLD arithmetic bit for bit
        neg, var = float(-eps), float(F32(2.0) * eps * F32(temperature))
        updates = []
        for g, v, n in zip(*map(tree_leaves, (grads, state.precond.v, noise))):
            m, _ = pre.update_leaf(v, g, step)
            updates.append((m * neg) * g.float() + torch.sqrt(m * var) * n)
        return (tree_unflatten(grads, updates),
                PSGLDState(precond=state.precond._replace(step=step + 1)))

    def stats(state, params):
        del params
        return {"step": state.precond.step, "precond_v_mean": _v_mean(state.precond)}

    return Sampler(init, update, stats=stats)
