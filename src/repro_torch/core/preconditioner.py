"""Diagonal mass-matrix adaptation (RMSProp/Adam-style, as in scale-adapted
SGHMC and pSGLD).

A running second-moment estimate V̂ = E[g²] per parameter gives
M⁻¹ = 1/(√V̂ + ε), which the samplers use in place of the scalar
``mass``.  Adaptation is FROZEN after ``burnin`` steps, so that the sampler
targets a fixed Hamiltonian afterwards: for every step ≥ burnin the
returned M⁻¹ is bit-identical, the contract the frozen-preconditioner
oracle rests on.

A preconditioner is a ``Preconditioner(init, update, update_leaf)``:

    pre = rmsprop_preconditioner(decay=0.99, burnin=1000)
    pstate = pre.init(params)
    minv, pstate = pre.update(pstate, grads)     # a tree like params, > 0
    minv_leaf, v_leaf = pre.update_leaf(v_leaf, g_leaf, pstate.step)

``update`` is the reference's tree form.  ``update_leaf`` is the same rule
for one leaf: it writes the new V̂ into ``v`` IN PLACE and returns the
leaf's M⁻¹, so a sampler that walks the leaves never holds a whole M⁻¹
tree.  The step counter is a host int.  Arithmetic is f32 in the
reference's order, v + (adapt·(1 − decay))·(g² − v) with ``1 − decay`` a
Python float rounded once to f32; after the freeze the EMA, whose
increment is then 0·(g² − v), is not computed: V̂ stays bit-identical for
finite gradients, as in the reference.

Identity preconditioning for equivalence tests: ``decay=1.0`` holds V̂ at
its all-ones init and ``eps=0.0`` makes M⁻¹ exactly 1.0.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .tree_util import tree_leaves, tree_map, tree_unflatten

F32 = np.float32


class PrecondState(NamedTuple):
    """``v``: the running E[g²] tree (f32 leaves shaped like params);
    ``step``: the adaptation counter of the burn-in freeze."""

    v: Any
    step: int


class Preconditioner(NamedTuple):
    init: Callable  # params -> PrecondState
    update: Callable  # (PrecondState, grads) -> (minv tree, PrecondState)
    update_leaf: Callable  # (v, g, step) -> (minv, v), v written in place


def _ema_(v, g, step, rate, burnin):
    """v <- v + f32(rate)·(g² − v) in place while step < burnin."""
    if step < burnin:
        d = torch.square(g.float()) - v
        v.add_(d.mul_(float(F32(rate))))
    return v


def _tree_update(update_leaf):
    def update(state, grads):
        out = [update_leaf(v.clone(), g, state.step)
               for v, g in zip(tree_leaves(state.v), tree_leaves(grads))]
        minv = tree_unflatten(state.v, [m for m, _ in out])
        return minv, PrecondState(v=tree_unflatten(state.v, [v for _, v in out]),
                                  step=state.step + 1)

    return update


def rmsprop_preconditioner(decay: float = 0.99, eps: float = 1e-8,
                           burnin: int = 1000) -> Preconditioner:
    """M⁻¹ = 1/(√V̂ + ε) with V̂ an exponential moving average of g²
    (Springenberg et al.'s scale-adapted choice).  ``decay=1.0`` freezes V̂
    at the all-ones init (identity preconditioning when ``eps=0``)."""

    def init(params):
        return PrecondState(v=tree_map(lambda p: torch.ones_like(p, dtype=torch.float32), params),
                            step=0)

    def update_leaf(v, g, step):
        _ema_(v, g, step, 1 - decay, burnin)
        return torch.sqrt(v).add_(eps).reciprocal_(), v

    return Preconditioner(init, _tree_update(update_leaf), update_leaf)


def adam_preconditioner(beta2: float = 0.999, eps: float = 1e-8,
                        burnin: int = 1000) -> Preconditioner:
    """Adam-style second moment with bias correction:

        M⁻¹ = 1 / (√(V̂ / (1 − β₂^t)) + ε)

    The correction counter saturates at ``burnin`` together with V̂
    (t = min(step + 1, burnin)), so the post-freeze M⁻¹ is bit-frozen like
    the RMSProp variant's."""

    def init(params):
        return PrecondState(v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                            step=0)

    def update_leaf(v, g, step):
        _ema_(v, g, step, 1 - beta2, burnin)
        t_eff = F32(min(step + 1, burnin))
        correction = float(F32(1.0) - np.power(F32(beta2), t_eff))
        return torch.sqrt(v / correction).add_(eps).reciprocal_(), v

    return Preconditioner(init, _tree_update(update_leaf), update_leaf)


def get_preconditioner(name: str, *, burnin: int, decay: float, eps: float) -> Preconditioner:
    """Resolve a preconditioner family by name ("rmsprop" | "adam").
    ``decay`` maps to the EMA coefficient (β₂ for adam)."""
    if name == "rmsprop":
        return rmsprop_preconditioner(decay=decay, eps=eps, burnin=burnin)
    if name == "adam":
        return adam_preconditioner(beta2=decay, eps=eps, burnin=burnin)
    raise ValueError(f"unknown preconditioner {name!r} (want 'rmsprop' or 'adam')")


def frozen_mass_inv(pstate: PrecondState, *, eps: float = 1e-8):
    """The M⁻¹ implied by a (frozen) RMSProp preconditioner state, by
    ``rmsprop_preconditioner``'s formula."""
    return tree_map(lambda v: torch.sqrt(v).add_(eps).reciprocal_(), pstate.v)
