"""Elastic coupling applied to SGLD.  The paper notes (§3, last paragraph)
that the coupling idea is independent of the base Hamiltonian and applies
to any SG-MCMC variant; with first-order Langevin dynamics the center keeps
a momentum r but the chains are momentum-free:

    theta^i_{t+1} = theta^i_t - eps [ grad Ũ(theta^i_t) + alpha (theta^i_t - c̃_t) ]
                    + N(0, 2 eps)
    c_{t+1}       = c_t + eps M^-1 r_t
    r_{t+1}       = r_t - eps C M^-1 r_t - eps alpha (c_t - mean_thetã_t)
                    + N(0, 2 eps^2 C)

This is also the bridge to plain EASGD (paper §5): removing all noise and
the center momentum recovers EASGD exactly.

``update`` writes the center trees and stale snapshots IN PLACE (the
values are the reference's) and returns the state with ``step + 1``.
``chain_axis`` and ``per_chain_noise`` split the chains over ranks as in
``ec_sghmc`` (one all-reduce per sync, the center noise the same on every
rank, the chains' noise keyed by the global chain index).
``update(..., noise=...)`` takes ``{"theta": tree, "r": tree}``, standard
normals shaped like the gradients and like the center, instead of drawing
them from ``rng``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.diagnostics.spread import chain_center_rms
from repro_torch.distributed.collectives import axis

from . import rng as rnglib
from .ec_sghmc import mean_buffer, stale_exchange
from .schedules import as_schedule
from .tree_util import global_norm, leaf_normals, tree_leaves, tree_map, tree_unflatten
from .types import Sampler

F32 = np.float32


class ECSGLDState(NamedTuple):
    center: Any
    center_momentum: Any
    center_stale: Any
    mean_theta_stale: Any
    step: int


def ec_sgld(
    step_size,
    alpha: float = 1.0,
    center_friction: float = 1.0,
    mass: float = 1.0,
    sync_every: int = 1,
    temperature: float = 1.0,
    chain_axis: str | None = None,
    per_chain_noise: bool | None = None,
) -> Sampler:
    """``chain_axis``: the bound axis the chains are split over (see
    ``ec_sghmc``); ``init`` takes the global chains.  ``per_chain_noise``
    (default: on under ``chain_axis``) keys each chain's noise by its
    global index, so the stream does not depend on the layout.  Without it
    under ``chain_axis`` the rank's index is folded into the chains' key,
    as in the reference."""
    schedule = as_schedule(step_size)
    minv = 1.0 / mass
    s = int(sync_every)
    if per_chain_noise is None:
        per_chain_noise = chain_axis is not None

    def init(params):
        center = tree_map(lambda p: torch.mean(p.float(), dim=0), params)
        return ECSGLDState(
            center=center,
            center_momentum=tree_map(torch.zeros_like, center),
            center_stale=tree_map(torch.clone, center),
            mean_theta_stale=mean_buffer(center),
            step=0,
        )

    def update(grads, state, params, rng=None, noise=None):
        eps = F32(schedule(state.step))
        k_t = k_r = None
        if noise is None:
            k_t, k_r = rnglib.split(rng)
        offset = None
        if per_chain_noise:
            offset = 0
            if chain_axis is not None:
                offset = axis(chain_axis).rank * int(tree_leaves(grads)[0].shape[0])
        elif chain_axis is not None and k_t is not None:
            k_t = rnglib.fold_in(k_t, axis(chain_axis).rank)
        sig_t = float(np.sqrt(F32(2.0) * eps * F32(temperature)))
        sig_r = float(F32(temperature**0.5) * eps * np.sqrt(F32(2.0 * center_friction)))
        e, ea = float(eps), float(F32(alpha))

        updates = tree_unflatten(grads, [
            -e * (g.float() + ea * (th.float() - ct)) + sig_t * n
            for g, th, ct, n in zip(
                *map(tree_leaves, (grads, params, state.center_stale)),
                leaf_normals(None if noise is None else noise["theta"], k_t, grads, offset))])

        em = float(eps * F32(minv))
        r_decay = float(eps * F32(center_friction) * F32(minv))
        r_coupling = float(eps * F32(alpha))
        for c, r, mth, n in zip(
                *map(tree_leaves, (state.center, state.center_momentum, state.mean_theta_stale)),
                leaf_normals(None if noise is None else noise["r"], k_r, state.center_momentum)):
            r_new = r - r_decay * r - r_coupling * (c - mth) + sig_r * n
            c.copy_(c + em * r)
            r.copy_(r_new)

        if (state.step + 1) % s == 0:
            stale_exchange(state, params, updates, chain_axis)
        return updates, state._replace(step=state.step + 1)

    def stats(state, params):
        return {
            "step": state.step,
            "center_momentum_norm": global_norm(state.center_momentum),
            "chain_center_rms": chain_center_rms(params, state.center),
        }

    return Sampler(init, update, stats=stats)
