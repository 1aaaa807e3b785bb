"""Scale-adapted SGHMC (Springenberg et al., 2016) and its elastically
coupled composition: diagonal preconditioning from an online
gradient-variance estimate, adapted during burn-in, then FROZEN so that the
stationary distribution stays valid.

    M⁻¹ = 1 / (√V̂ + ε),   V̂ = EMA[g²]

With a frozen diagonal M the augmented Hamiltonian has the same
θ-marginal for any fixed masses, so both samplers keep the injected noise
MASS-INDEPENDENT (``sghmc._noise_scale``) while friction damps at rate
εVM⁻¹, and the coupling force −εα(θⁱ − c̃) is not M-scaled.

``scale_adapted_ec_sghmc`` preconditions each chain's kinetic term from the
chain's own gradients (per-chain diagonal Mᵢ⁻¹) and gives the center the
chain-mean mass M_c⁻¹ = meanᵢ Mᵢ⁻¹.  Its update walks the leaves once; for
each leaf it runs the EMA, forms the leaf's M⁻¹ and M_c⁻¹, the position
update ε·M⁻¹·p from the old momentum, the new center from the old r, the
momentum update (the fused kernel with ``fused=True``, writing p' over p;
its θ' is dropped, as the reference's ``del new_theta_f``) and r' from the
old c.  So no whole M⁻¹ tree ever exists: at qwen3-0.6b the largest
transients are one leaf's M⁻¹ and g² − V̂.  Then comes the s-periodic
exchange of ``ec_sghmc``.  State tensors are written in place and the
state is returned with ``step + 1``, as in ``ec_sghmc``; ``noise=`` takes
the same ``{"p": ..., "r": ...}`` draws.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import rng as rnglib
from .ec_sghmc import ec_stats, p_step, stale_exchange
from .preconditioner import PrecondState, rmsprop_preconditioner
from .schedules import as_schedule
from .sghmc import _noise_scale
from .tree_util import (global_norm, leaf_normals, tree_leaves, tree_map, tree_random_normal,
                        tree_unflatten)
from .types import Sampler

F32 = np.float32


class ScaleAdaptedState(NamedTuple):
    momentum: Any
    precond: PrecondState
    step: int


def _v_mean(precond: PrecondState):
    """Mean of V̂ per leaf, averaged over leaves: adaptation health (it
    plateaus at the freeze)."""
    leaves = tree_leaves(precond.v)
    return sum(torch.mean(v) for v in leaves) / max(len(leaves), 1)


def scale_adapted_sghmc(
    step_size,
    friction: float = 1.0,
    temperature: float = 1.0,
    burnin: int = 1000,
    decay: float = 0.99,
    precond_eps: float = 1e-8,
    noise_convention: str = "eq4",
    state_dtype=torch.float32,
) -> Sampler:
    """Preconditioned SGHMC:

        θ' = θ + ε M⁻¹ p
        p' = p − ε g − ε V M⁻¹ p + N(0, 2εV·T)        ["eq4"]

    ``update(..., noise=tree)`` takes the momentum noise (standard
    normals shaped like the momentum) instead of drawing it from ``rng``."""
    schedule = as_schedule(step_size)
    pre = rmsprop_preconditioner(decay=decay, eps=precond_eps, burnin=burnin)

    def init(params):
        return ScaleAdaptedState(
            momentum=tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params),
            precond=pre.init(params),
            step=0,
        )

    def update(grads, state, params=None, rng=None, noise=None):
        del params
        eps = F32(schedule(state.step))
        sigma = float(F32(temperature**0.5) * _noise_scale(eps, friction, 0.0, noise_convention))
        if noise is None:
            dev = tree_leaves(state.momentum)[0].device
            noise = tree_random_normal(rnglib.generator(rng, dev), state.momentum, torch.float32)
        e, ef = float(eps), float(eps * F32(friction))
        updates = []
        for p, g, v, n in zip(*map(tree_leaves, (state.momentum, grads, state.precond.v, noise))):
            m, _ = pre.update_leaf(v, g, state.precond.step)
            p32 = p.float()
            updates.append((m * e) * p32)
            # mass-independent noise: fluctuation-dissipation
            p.copy_((1.0 - ef * m) * p32 - e * g.float() + sigma * n)
        precond = state.precond._replace(step=state.precond.step + 1)
        return (tree_unflatten(state.momentum, updates),
                state._replace(precond=precond, step=state.step + 1))

    def stats(state, params):
        del params
        return {"step": state.step, "momentum_norm": global_norm(state.momentum)}

    return Sampler(init, update, stats=stats)


class ScaleAdaptedECState(NamedTuple):
    """EC-SGHMC state plus the per-chain preconditioner.  Chain leaves carry
    the leading (K, ...) axis; center leaves do not."""

    momentum: Any  # pⁱ : (K, ...) per leaf
    precond: PrecondState  # per-chain V̂ : (K, ...) per leaf
    center: Any  # c : (...)
    center_momentum: Any  # r : (...)
    center_stale: Any  # c̃ : worker-side stale snapshot of c
    mean_theta_stale: Any  # server-side stale meanᵢ θⁱ
    step: int


def _chain_mean(x):
    """Mean over the leading chain axis as a sum in chain order times the
    f32 of 1/K: how XLA computes the reference's ``jnp.mean`` on the CPU
    (it multiplies by the reciprocal), and the same on every device."""
    acc = x[0].clone()
    for k in range(1, x.shape[0]):
        acc.add_(x[k])
    return acc.mul_(float(F32(1.0 / x.shape[0])))


def scale_adapted_ec_sghmc(
    step_size,
    alpha: float = 1.0,
    friction: float = 1.0,  # V
    center_friction: float = 1.0,  # C
    sync_every: int = 1,  # s
    temperature: float = 1.0,
    burnin: int = 1000,
    decay: float = 0.99,
    precond_eps: float = 1e-8,
    noise_convention: str = "eq6",
    center_noise_in_p: bool = True,
    fused: bool = False,
    state_dtype=torch.float32,
) -> Sampler:
    """Eq. 6 elastic coupling with per-chain diagonal preconditioning:

        θⁱ' = θⁱ + ε Mᵢ⁻¹ pⁱ
        c'  = c + ε M_c⁻¹ r,        M_c⁻¹ = meanᵢ Mᵢ⁻¹
        pⁱ' = pⁱ − ε g − ε V Mᵢ⁻¹ pⁱ − ε α (θⁱ − c̃) + σ_p N(0, I)
        r'  = r − ε C M_c⁻¹ r − ε α (c − m̃θ) + σ_r N(0, I)

    with the s-periodic stale exchange of ``ec_sghmc`` and its noise
    scales.  The momentum line is ``p_step`` with a tensor M⁻¹ (or, with
    ``fused=True``, the preconditioned kernel), so with identity
    preconditioning (``decay=1.0, precond_eps=0.0``) the trajectory is bit
    for bit ``ec_sghmc(mass=1.0)``'s.  The reference has no chain-axis
    sharding or compressed exchange for this sampler, and neither does the
    port."""
    schedule = as_schedule(step_size)
    s = int(sync_every)
    pre = rmsprop_preconditioner(decay=decay, eps=precond_eps, burnin=burnin)

    def init(params):
        center = tree_map(lambda p: torch.mean(p.to(state_dtype), dim=0), params)
        return ScaleAdaptedECState(
            momentum=tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params),
            precond=pre.init(params),
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
        e = float(eps)
        r_friction = float(eps * F32(center_friction))
        r_coupling = float(eps * F32(alpha))
        k_p = k_r = None
        if noise is None:
            k_p, k_r = rnglib.split(rng)
        leaves = list(zip(*map(tree_leaves, (
            params, state.momentum, grads, state.precond.v, state.center, state.center_momentum,
            state.center_stale, state.mean_theta_stale))))
        if fused:
            from repro_torch.kernels.ops import fused_precond_ec_update
        if fused and noise is None:  # Philox noise in the kernel
            p_noise = [None] * len(leaves)
        else:  # normals, or the kernel's (bits1, bits2) per leaf
            p_noise = leaf_normals(None if noise is None else noise["p"], k_p, state.momentum)
        r_noise = leaf_normals(None if noise is None else noise["r"], k_r, state.center_momentum)
        updates = []
        for i, ((th, p, g, v, c, r, ct, mth), pn, rn) in enumerate(zip(leaves, p_noise, r_noise)):
            m, _ = pre.update_leaf(v, g, state.precond.step)
            mc = _chain_mean(m)
            updates.append((m * e).mul_(p.float()))  # from the old momentum
            r32 = r.float()
            new_c = c.float() + (mc * e) * r32  # from the old r
            if fused:
                fused_precond_ec_update(th, p, g, ct, m, eps=eps, friction=friction, alpha=alpha,
                                        sigma_p=sigma_p, stochastic_round=True, bits=pn,
                                        seed=k_p if pn is None else None, leaf=i,
                                        step=state.step, p_out=p)
            else:
                p.copy_(p_step(p, g, th, ct, pn, eps=eps, friction=friction, minv=m, alpha=alpha,
                               sigma_p=sigma_p, out_dtype=state_dtype))
            del m
            r_new = r32 - (mc * r_friction) * r32 - r_coupling * (c.float() - mth.float()) \
                + sigma_r * rn
            c.copy_(new_c)
            r.copy_(r_new)
        updates = tree_unflatten(params, updates)
        if (state.step + 1) % s == 0:
            stale_exchange(state, params, updates)
        precond = state.precond._replace(step=state.precond.step + 1)
        return updates, state._replace(precond=precond, step=state.step + 1)

    def stats(state, params):
        out = ec_stats(state, params, alpha)
        out["precond_v_mean"] = _v_mean(state.precond)
        return out

    return Sampler(init, update, stats=stats)
