"""Stochastic Gradient Hamiltonian Monte Carlo, paper Eq. (4).

    theta_{t+1} = theta_t + eps * M^{-1} p_t
    p_{t+1}     = p_t - eps * grad Ũ(theta_t) - eps * V M^{-1} p_t
                      + N(0, 2 eps V)            [noise_convention="eq4"]

V plays the double role of friction and injected-noise scale.  ``mass`` is
the (scalar) diagonal of M; ``temperature`` scales the noise covariance.
Scalars are formed in float32 as the reference forms them, so given the
same noise the update matches ``repro.core.sghmc`` to float32 rounding.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import rng as rnglib
from .schedules import as_schedule
from .tree_util import global_norm, tree_leaves, tree_map, tree_random_normal
from .types import Sampler

F32 = np.float32


class SGHMCState(NamedTuple):
    momentum: Any
    step: int


def _noise_scale(eps, friction, extra, convention: str):
    """Std-dev of injected noise, a numpy float32.  eq4: N(0, 2 eps V);
    eq6: N(0, 2 eps^2 (V+C))."""
    v = friction + extra
    if convention == "eq4":
        return F32(np.sqrt(F32(2.0) * F32(eps) * F32(v)))
    elif convention == "eq6":
        return F32(F32(eps) * np.sqrt(F32(2.0 * v)))
    raise ValueError(f"unknown noise convention {convention!r}")


def sghmc(
    step_size,
    friction: float = 1.0,
    mass: float = 1.0,
    temperature: float = 1.0,
    noise_convention: str = "eq4",
    grad_noise_estimate: float = 0.0,
    state_dtype=torch.float32,
) -> Sampler:
    """Plain SGHMC (single chain, or K independent chains when params carry
    a leading chain axis).  ``grad_noise_estimate`` is the B̂ term of Chen
    et al. (2014).  ``state_dtype``: momentum storage dtype; arithmetic is
    f32 with cast-on-store.  ``update(..., noise=tree)`` takes the momentum
    noise (standard normal, shaped like the momentum) instead of drawing
    it from ``rng``.  ``update`` writes the new momentum into the state's
    tensors in place: the state passed in is consumed."""
    schedule = as_schedule(step_size)
    minv = 1.0 / mass

    def init(params):
        return SGHMCState(momentum=tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params),
                          step=0)

    def update(grads, state, params=None, rng=None, noise=None):
        del params
        eps = F32(schedule(state.step))
        em = float(eps * F32(minv))
        updates = tree_map(lambda p: em * p.float(), state.momentum)
        sigma = float(F32(temperature**0.5) * _noise_scale(
            eps, friction - grad_noise_estimate, 0.0, noise_convention))
        if noise is None:
            dev = tree_leaves(state.momentum)[0].device
            noise = tree_random_normal(rnglib.generator(rng, dev), state.momentum, torch.float32)
        decay = float(F32(1.0) - eps * F32(friction) * F32(minv))
        e = float(eps)

        for p, g, n in zip(*map(tree_leaves, (state.momentum, grads, noise))):
            # decay form (1 - eps V M^-1) p, the association of the fused
            # kernel, so the coupled sampler's unfused path agrees at alpha=0
            p.copy_(decay * p.float() - e * g.float() + sigma * n)
        return updates, state._replace(step=state.step + 1)

    def stats(state, params):
        del params
        return {"step": state.step, "momentum_norm": global_norm(state.momentum)}

    return Sampler(init, update, stats=stats)
