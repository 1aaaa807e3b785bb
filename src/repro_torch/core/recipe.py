"""The Ma et al. (2015) "complete recipe" for SG-MCMC, the theory layer.

Any diffusion of the form

    dz = f(z) dt + sqrt(2 D(z)) dW_t,
    f(z) = -(D(z) + Q(z)) ∇H(z) + Γ(z),     Γ_i = Σ_j ∂/∂z_j (D_ij + Q_ij)

with D ⪰ 0 and Q skew-symmetric has exp(-H(z)) as its stationary
distribution.  This module provides a dense-matrix simulator for
low-dimensional z, used by the toy experiments and by tests that verify
SGHMC (Eq. 4) and EC-SGHMC (Eq. 6) are instances of the recipe with the
D/Q matrices the paper claims (§1.1.1 and Prop. 3.1).  Matrices are f32
tensors, built on ``device`` (the card unless the caller asks for the
CPU).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import rng as rnglib

F32 = np.float32


class Recipe(NamedTuple):
    grad_H: Callable  # (z) -> ∇H(z), shape (m,)
    D: torch.Tensor  # (m, m) PSD
    Q: torch.Tensor  # (m, m) skew-symmetric


def validate(recipe: Recipe, atol: float = 1e-6) -> None:
    D, Q = recipe.D, recipe.Q
    if not torch.allclose(Q, -Q.T, atol=atol):
        raise ValueError("Q must be skew-symmetric")
    eig = torch.linalg.eigvalsh(0.5 * (D + D.T))
    if not bool(torch.all(eig >= -atol)):
        raise ValueError("D must be PSD")


def step(recipe: Recipe, z, eps, rng=None, noise=None):
    """One Euler–Maruyama step of Eq. (3) (constant D, Q, so Γ = 0).
    ``noise``: the step's standard normals (shaped like z), or None to draw
    them from ``rng`` (a ``core.rng`` key or a ``torch.Generator``)."""
    if noise is None:
        gen = rng if isinstance(rng, torch.Generator) else rnglib.generator(rng, z.device)
        noise = torch.randn(z.shape, generator=gen, dtype=torch.float32, device=z.device)
    return _step(recipe, z, eps, _noise_factor(recipe, z.device), noise)


def _noise_factor(recipe: Recipe, device):
    """N(0, 2 eps D) needs a square root of the PSD D: the Cholesky factor of
    D + jitter."""
    m = recipe.D.shape[0]
    return torch.linalg.cholesky(recipe.D + 1e-12 * torch.eye(m, device=device))


def _step(recipe: Recipe, z, eps, chol, noise):
    drift = -(recipe.D + recipe.Q) @ recipe.grad_H(z)
    return z + float(F32(eps)) * drift + float(np.sqrt(F32(2.0 * eps))) * (chol @ noise)


def simulate(recipe: Recipe, z0, eps, num_steps: int, rng=None, noise=None):
    """The trajectory of ``num_steps`` steps from z0, (num_steps, m): a loop
    over one ``torch.Generator`` seeded from the key ``rng``, or over the
    rows of ``noise`` (num_steps, m) when it is given.  D and Q are
    constant, so the noise factor is computed once."""
    gen = None if noise is not None else rnglib.generator(rng, z0.device)
    chol = _noise_factor(recipe, z0.device)
    z, traj = z0, []
    for t in range(num_steps):
        n = noise[t] if noise is not None else torch.randn(
            z.shape, generator=gen, dtype=torch.float32, device=z.device)
        z = _step(recipe, z, eps, chol, n)
        traj.append(z)
    return torch.stack(traj)


def sghmc_recipe(grad_U: Callable, dim: int, friction: float = 1.0, mass: float = 1.0,
                 device="cuda") -> Recipe:
    """Eq. (4) as a recipe instance: z = [θ, p], H = U(θ) + pᵀM⁻¹p/2,
    D = diag([0, V]), Q = [[0, -I], [I, 0]] (the paper prints a V in Q's
    corner; the dynamics it derives correspond to this canonical symplectic
    Q)."""
    eye = torch.eye(dim, device=device)
    zero = torch.zeros((dim, dim), device=device)
    D = torch.cat([torch.cat([zero, zero], 1), torch.cat([zero, float(friction) * eye], 1)])
    Q = torch.cat([torch.cat([zero, -eye], 1), torch.cat([eye, zero], 1)])

    def grad_H(z):
        theta, p = z[:dim], z[dim:]
        return torch.cat([grad_U(theta), p / float(mass)])

    return Recipe(grad_H, D, Q)


def ec_sghmc_recipe(
    grad_U: Callable,
    dim: int,
    num_chains: int,
    alpha: float = 1.0,
    friction: float = 1.0,
    center_friction: float = 1.0,
    mass: float = 1.0,
    device="cuda",
) -> Recipe:
    """Prop. 3.1: z = [θ¹..θᴷ, c, p¹..pᴷ, r] with
    H(z) = Σ U(θⁱ) + Σ pⁱᵀM⁻¹pⁱ + (1/K)Σ (α/2)‖θⁱ−c‖² + rᵀM⁻¹r,
    D = diag([0, V·I_K, 0, C]), Q = canonical symplectic block."""
    K, d = num_chains, dim
    m = (K + 1) * d  # positions; the same count of momenta
    zero = torch.zeros((m, m), device=device)
    eye = torch.eye(m, device=device)
    dmom = torch.diag(torch.cat([torch.full((K * d,), float(friction), device=device),
                                 torch.full((d,), float(center_friction), device=device)]))
    D = torch.cat([torch.cat([zero, zero], 1), torch.cat([zero, dmom], 1)])
    Q = torch.cat([torch.cat([zero, -eye], 1), torch.cat([eye, zero], 1)])
    ak = alpha / K

    def grad_H(z):
        pos, mom = z[:m], z[m:]
        thetas = pos[: K * d].reshape(K, d)
        c = pos[K * d:]
        dU = torch.stack([grad_U(th) for th in thetas])  # (K, d)
        d_theta = dU + ak * (thetas - c[None])
        d_c = ak * torch.sum(c[None] - thetas, dim=0)
        return torch.cat([d_theta.reshape(-1), d_c, mom / float(mass)])

    return Recipe(grad_H, D, Q)
