"""EASGD family (Zhang et al. 2015) and the paper's §5 alternative.

Three deterministic optimizers over K-stacked params:

* ``easgd``   — plain elastic averaging SGD (no momentum);
* ``eamsgd``  — EASGD with momentum as rewritten in the paper's Eq. (10):
                the coupling force acts on the POSITION and the center has
                no momentum;
* ``ec_msgd`` — the paper's Eq. (9): the deterministic limit of EC-SGHMC
                (coupling through the momentum, the center carries
                momentum), equal to ``ec_sghmc(temperature=0)`` under the
                §5 variable substitution.

``easgd`` and ``eamsgd`` take ``sync_every`` (s): Zhang et al. update the
center and apply the coupling terms only every s steps.  Scalars are formed
in float32 as the reference forms them, so the port matches it to f32
rounding.  The updates and new states are new tensors; ``rng`` and
``noise`` are accepted and ignored.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .schedules import as_schedule
from .tree_util import tree_map
from .types import Sampler

F32 = np.float32


def _center(params):
    return tree_map(lambda p: torch.mean(p.float(), dim=0), params)


class EASGDState(NamedTuple):
    center: Any
    step: int


def easgd(step_size, alpha: float = 1.0, sync_every: int = 1) -> Sampler:
    schedule = as_schedule(step_size)
    s = int(sync_every)

    def init(params):
        return EASGDState(center=_center(params), step=0)

    def update(grads, state, params, rng=None, noise=None):
        eps = F32(schedule(state.step))
        e = float(eps)
        if state.step % s != 0:  # no coupling between syncs
            return tree_map(lambda g: -e * g.float(), grads), state._replace(step=state.step + 1)
        ea = float(eps * F32(alpha))
        updates = tree_map(lambda g, th, c: -e * g.float() - ea * (th.float() - c[None]),
                           grads, params, state.center)
        center = tree_map(lambda c, th: c + ea * (torch.mean(th.float(), dim=0) - c),
                          state.center, params)
        return updates, EASGDState(center=center, step=state.step + 1)

    return Sampler(init, update)


class EAMSGDState(NamedTuple):
    velocity: Any  # (K, ...)
    center: Any
    step: int


def eamsgd(step_size, alpha: float = 1.0, xi: float = 0.1, sync_every: int = 1) -> Sampler:
    """Paper Eq. (10): momentum EASGD, coupling applied to positions."""
    schedule = as_schedule(step_size)
    s = int(sync_every)

    def init(params):
        return EAMSGDState(velocity=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                             params),
                           center=_center(params), step=0)

    def update(grads, state, params, rng=None, noise=None):
        eps = F32(schedule(state.step))
        e, x = float(eps), float(F32(xi))
        if state.step % s == 0:
            ea = float(eps * F32(alpha))
            # theta_{t+1} = theta_t + v_t - eps*alpha*(theta_t - c_t)
            updates = tree_map(lambda v, th, c: v - ea * (th.float() - c[None]),
                               state.velocity, params, state.center)
            # c_{t+1} = c_t - eps*alpha*(1/K) sum_i (c_t - theta^i_t)
            center = tree_map(lambda c, th: c - ea * (c - torch.mean(th.float(), dim=0)),
                              state.center, params)
        else:
            updates = tree_map(torch.clone, state.velocity)
            center = state.center
        # v_{t+1} = v_t - eps*grad - xi*v_t
        velocity = tree_map(lambda v, g: v - e * g.float() - x * v, state.velocity, grads)
        return updates, EAMSGDState(velocity, center, state.step + 1)

    return Sampler(init, update)


class ECMSGDState(NamedTuple):
    velocity: Any  # v^i : (K, ...)
    center: Any  # c
    center_velocity: Any  # h
    step: int


def ec_msgd(step_size, alpha: float = 1.0, xi: float = 0.1) -> Sampler:
    """Paper Eq. (9): the physics-respecting momentum EASGD suggested by the
    deterministic limit of EC-SGHMC (the s = 1 synchronous form)."""
    schedule = as_schedule(step_size)

    def init(params):
        center = _center(params)
        return ECMSGDState(
            velocity=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            center=center,
            center_velocity=tree_map(torch.zeros_like, center),
            step=0,
        )

    def update(grads, state, params, rng=None, noise=None):
        eps = F32(schedule(state.step))
        e, x, ea = float(eps), float(F32(xi)), float(eps * F32(alpha))
        updates = tree_map(torch.clone, state.velocity)  # theta += v_t
        center = tree_map(torch.add, state.center, state.center_velocity)
        # v_{t+1} = v_t - eps*grad - xi*v_t - eps*alpha*(theta - c)
        velocity = tree_map(lambda v, g, th, c: v - e * g.float() - x * v
                            - ea * (th.float() - c[None]),
                            state.velocity, grads, params, state.center)
        # h_{t+1} = h_t - xi*h_t - eps*alpha*(1/K) sum_i (c - theta^i)
        center_velocity = tree_map(
            lambda h, c, th: h - x * h - ea * (c - torch.mean(th.float(), dim=0)),
            state.center_velocity, state.center, params)
        return updates, ECMSGDState(velocity, center, center_velocity, state.step + 1)

    return Sampler(init, update)
