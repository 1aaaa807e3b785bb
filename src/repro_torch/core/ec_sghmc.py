"""Elastically-Coupled SGHMC, the paper's contribution (Eq. 5/6).

K chains (theta^i, p^i) are coupled through a center variable c with its
own momentum r (Eq. 6, communication period ``s``):

    theta^i_{t+1} = theta^i_t + eps M^-1 p^i_t
    c_{t+1}       = c_t       + eps M^-1 r_t
    p^i_{t+1} = p^i_t - eps grad Ũ(theta^i_t) - eps V M^-1 p^i_t
                      - eps alpha (theta^i_t - c̃_t) + N(0, 2 eps^2 (V+C))
    r_{t+1}   = r_t   - eps C M^-1 r_t
                      - eps alpha (c_t - mean_thetã_t) + N(0, 2 eps^2 C)

where c̃ is the stale center snapshot the workers last received and
mean_thetã the stale chain average the server last received, both
refreshed every ``s`` steps.  Every leaf of params/grads/momentum carries
a leading chain axis of size K; center states do not.

The s-periodic sync is a Python ``if`` on the host-side step (the
reference's ``lax.cond``).  ``update`` writes the new momenta, center
trees and stale snapshots IN PLACE into the state's tensors (the values
are the reference's) and returns the state with ``step + 1``: the state
passed in is consumed, and a caller that still holds it costs no memory.
With ``fused=True`` the momentum update runs through the hand-written
kernel (``kernels.ops.fused_ec_update_tree``), which writes p' over p.

Noise: ``update(..., noise=...)`` takes ``{"p": tree, "r": tree}``, where
``"p"`` holds standard normals shaped like the momentum (unfused) or
``(bits1, bits2)`` int32 tensors per leaf (fused, the kernel's parity
mode), and ``"r"`` standard normals shaped like the center.  Without it
the unfused path draws from ``rng`` through ``torch.Generator``s and the
fused path generates Philox noise inside the kernel, keyed by ``rng`` and
countered by the leaf, the step and the element.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.diagnostics.spread import chain_center_rms
from repro_torch.kernels import ref as kref

from . import rng as rnglib
from .schedules import as_schedule
from .sghmc import _noise_scale
from .tree_util import (count_params, global_norm, leaf_normals, tree_leaves, tree_map,
                        tree_unflatten)
from .types import Sampler

F32 = np.float32


def p_step(p, g, theta, c_tilde, noise, *, eps, friction, minv, alpha, sigma_p,
           out_dtype=torch.float32):
    """Eq. 6 momentum line, one leaf:  p' = (1 - eps V M^-1) p - eps g
    - eps alpha (theta - c̃) + sigma_p n.  ``minv`` is a scalar M^-1 or an
    f32 tensor (a diagonal M^-1, shaped like p).  The scalars come from
    ``kernels.ref.ec_scalars`` (scalar M^-1) or ``ref.precond_scalars``
    (tensor M^-1, grouped as (1 - (eps V) M^-1) p), and the terms are
    grouped as the fused kernels group them, so given the same noise the
    two agree bit for bit in f32."""
    if isinstance(minv, torch.Tensor):
        e, ef, coupling, sp = kref.precond_scalars(eps, friction, alpha, sigma_p)
        decay = 1.0 - ef * minv
    else:
        _, decay, e, coupling, sp = kref.ec_scalars(eps, friction, minv, alpha, sigma_p)
    out = (
        decay * p.float()
        - e * g.float()
        - coupling * (theta.float() - c_tilde.float())
        + sp * noise
    )
    return out.to(out_dtype)


class ECSGHMCState(NamedTuple):
    momentum: Any  # p^i : (K, ...) per leaf
    center: Any  # c : (...) per leaf
    center_momentum: Any  # r : (...)
    center_stale: Any  # c̃ : worker-side stale snapshot of c
    mean_theta_stale: Any  # server-side stale mean_i theta^i
    step: int


def ec_sghmc(
    step_size,
    alpha: float = 1.0,
    friction: float = 1.0,  # V
    center_friction: float = 1.0,  # C
    mass: float = 1.0,
    sync_every: int = 1,  # s
    temperature: float = 1.0,
    noise_convention: str = "eq6",
    center_noise_in_p: bool = True,
    compression=None,
    fused: bool = False,
    state_dtype=torch.float32,
    chain_axis: str | None = None,
    per_chain_noise: bool | None = None,
) -> Sampler:
    """``center_noise_in_p``: Eq. 6 as printed injects N(0, 2eps^2 (V+C))
    into p; False injects only the V part.  ``compression``, ``chain_axis``
    and ``per_chain_noise`` (the multi-device exchange) are not ported and
    raise ``NotImplementedError``."""
    if compression is not None or chain_axis is not None or per_chain_noise:
        raise NotImplementedError(
            "compression / chain_axis / per_chain_noise wait for distributed/ in the port")
    schedule = as_schedule(step_size)
    minv = 1.0 / mass
    s = int(sync_every)

    def init(params):
        center = tree_map(lambda p: torch.mean(p.to(state_dtype), dim=0), params)
        return ECSGHMCState(
            momentum=tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params),
            center=center,
            center_momentum=tree_map(torch.zeros_like, center),
            center_stale=tree_map(torch.clone, center),
            mean_theta_stale=tree_map(torch.clone, center),
            step=0,
        )

    def update(grads, state, params, rng=None, noise=None):
        eps = F32(schedule(state.step))
        sigma_p = F32(F32(temperature**0.5) * _noise_scale(
            eps, friction, center_friction if center_noise_in_p else 0.0, noise_convention))
        sigma_r = float(F32(temperature**0.5) * _noise_scale(eps, center_friction, 0.0,
                                                             noise_convention))
        em = float(eps * F32(minv))

        # -- position update (pre-update momenta; Eq. 6 line 1) --------------
        updates = tree_map(lambda p: em * p.float(), state.momentum)

        # -- momentum updates (they read the old c~) -------------------------
        k_p = k_r = None
        if noise is None:
            k_p, k_r = rnglib.split(rng)
        if fused:
            from repro_torch.kernels.ops import fused_ec_update_tree

            # one launch per leaf writes p' over p; the kernel's theta' is
            # dropped, since updates (above) already carry eps*M^-1*p (the
            # reference's `del new_theta_f`)
            fused_ec_update_tree(
                params, state.momentum, grads, state.center_stale,
                eps=eps, friction=friction, mass=mass, alpha=alpha, sigma_p=sigma_p,
                stochastic_round=True, bits=None if noise is None else noise["p"],
                seed=k_p, step=state.step,
            )
        else:
            for p, g, th, ct, n in zip(
                    *map(tree_leaves, (state.momentum, grads, params, state.center_stale)),
                    leaf_normals(None if noise is None else noise["p"], k_p, state.momentum)):
                p.copy_(p_step(p, g, th, ct, n, eps=eps, friction=friction, minv=minv,
                               alpha=alpha, sigma_p=sigma_p, out_dtype=state_dtype))

        # -- center (Eq. 6 line 2) and its momentum, from the old c and r ------
        r_decay = float(eps * F32(center_friction) * F32(minv))
        r_coupling = float(eps * F32(alpha))
        for c, r, mth, n in zip(
                *map(tree_leaves, (state.center, state.center_momentum, state.mean_theta_stale)),
                leaf_normals(None if noise is None else noise["r"], k_r, state.center_momentum)):
            r32 = r.float()
            r_new = r32 - r_decay * r32 - r_coupling * (c.float() - mth.float()) + sigma_r * n
            c.copy_(c.float() + em * r32)
            r.copy_(r_new)

        if (state.step + 1) % s == 0:
            stale_exchange(state, params, updates)
        return updates, state._replace(step=state.step + 1)

    def stats(state, params):
        return ec_stats(state, params, alpha)

    return Sampler(init, update, stats=stats)


def stale_exchange(state, params, updates) -> None:
    """The s-periodic exchange, in place: workers push theta^i (post-update,
    theta + u), the server replies with c.  Leaf by leaf, so theta + u
    never exists whole."""
    for ct, c in zip(tree_leaves(state.center_stale), tree_leaves(state.center)):
        ct.copy_(c)
    for mth, th, u in zip(*map(tree_leaves, (state.mean_theta_stale, params, updates))):
        mth.copy_(torch.mean(th.float() + u, dim=0))


def ec_stats(state, params, alpha: float) -> dict:
    """Scalar diagnostics of a coupled sampler's state as 0-d tensors (no
    host sync)."""
    n_elem = max(count_params(params), 1)
    rms = chain_center_rms(params, state.center)
    k = int(tree_leaves(params)[0].shape[0])
    return {
        "step": state.step,
        "momentum_norm": global_norm(state.momentum),
        "center_momentum_norm": global_norm(state.center_momentum),
        "chain_center_rms": rms,
        # the Eq. 5 coupling energy (1/K) sum_i (alpha/2)||theta^i - c||^2
        "coupling_energy": 0.5 * alpha * rms * rms * (n_elem / k),
    }


def resample_chain_from_center(state: ECSGHMCState, alpha: float, rng, num_chains: int):
    """Elastic-K scaling / chain recovery: draw fresh chains from the
    stationary conditional  theta^i | c  ~  N(c, (alpha/K)^-1 I)  implied by
    the coupling term of Eq. 5, with zero momentum.  Returns (params, state)
    for the new chain count."""
    k = num_chains
    scale = (k / max(alpha, 1e-8)) ** 0.5
    leaves = tree_leaves(state.center)
    keys = rnglib.split(rng, len(leaves))
    drawn = [
        c[None] + scale * torch.randn((k,) + tuple(c.shape), dtype=c.dtype, device=c.device,
                                      generator=rnglib.generator(kk, c.device))
        for c, kk in zip(leaves, keys)
    ]
    params = tree_unflatten(state.center, drawn)
    new_state = ECSGHMCState(
        momentum=tree_map(torch.zeros_like, params),
        center=state.center,
        center_momentum=state.center_momentum,
        center_stale=tree_map(torch.clone, state.center),  # updated in place apart from c
        mean_theta_stale=tree_map(lambda x: torch.mean(x, dim=0), params),
        step=state.step,
    )
    return params, new_state
