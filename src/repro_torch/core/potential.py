"""Potential energy U(θ) constructors, the bridge between models and samplers.

The paper's target:  p(θ|D) ∝ exp(-U(θ)),
    U(θ)  = - Σ_{x∈D} log p(x|θ) - log p(θ)
    Ũ(θ)  = - (N/|B|) Σ_{x∈B} log p(x|θ) - log p(θ)     (minibatch estimate)

``make_potential`` wraps ``nll_fn(params, batch) -> (sum_nll, batch_size)``
and a prior into value/grad functions; ``batch_size`` is a host int (the
count of examples in the batch), so the N/|B| scale is an f32 host scalar
and no count is copied to the card.  Gradients come from
``torch.autograd``.  ``chainwise`` lifts a potential over a leading chain
axis with ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .tree_util import tree_leaves, tree_unflatten


class Prior(NamedTuple):
    # potential contribution (-log p(θ) up to a constant) and nothing else
    energy: Callable


def gaussian_prior(weight_decay: float = 1e-5) -> Prior:
    """-log p(θ) = λ ||θ||²  (the paper's prior with λ = 1e-5 for MNIST)."""

    def energy(params):
        return weight_decay * sum(torch.sum(torch.square(x.float())) for x in tree_leaves(params))

    return Prior(energy)


def flat_prior() -> Prior:
    return Prior(lambda params: torch.zeros((), dtype=torch.float32))


class Potential(NamedTuple):
    value: Callable  # (params, batch) -> Ũ(θ) 0-d tensor
    grad: Callable  # (params, batch) -> ∇Ũ(θ) tree
    value_and_grad: Callable
    nll: Callable  # (params, batch) -> mean per-example NLL


def value_and_grad(fn: Callable, has_aux: bool = False) -> Callable:
    """``fn(params, *args)`` -> ``((value[, aux]), grads)`` with the grads a
    tree like ``params``, by ``torch.autograd.grad`` on detached leaves
    (the params themselves are not touched)."""

    def vag(params, *args):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        out = fn(tree_unflatten(params, leaves), *args)
        value = out[0] if has_aux else out
        if _is_dtensor(value):
            from repro_torch.models.spmd import _moved

            # a DTensor param's gradient is brought to its layout as soon as
            # it is complete (FSDP's reduce-scatter after the gather at use)
            for x in leaves:
                x.register_hook(lambda g, pl=x.placements: _moved(g, pl))
            value = value.full_tensor()
        grads = torch.autograd.grad(value, leaves)
        out = (value.detach(), out[1]) if has_aux else value.detach()
        return out, tree_unflatten(params, list(grads))

    return vag


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def make_potential(nll_fn: Callable, n_data: int, prior: Prior | None = None) -> Potential:
    prior = prior or flat_prior()

    def count(bsz: int) -> np.float32:
        return np.float32(max(bsz, 1))

    def value(params, batch):
        sum_nll, bsz = nll_fn(params, batch)
        return float(np.float32(n_data) / count(bsz)) * sum_nll + prior.energy(params)

    def mean_nll(params, batch):
        sum_nll, bsz = nll_fn(params, batch)
        return sum_nll / float(count(bsz))

    vag = value_and_grad(value)
    return Potential(value=value, grad=lambda p, b: vag(p, b)[1], value_and_grad=vag, nll=mean_nll)


def chainwise(potential: Potential) -> Potential:
    """Lift a Potential over a leading chain axis K on params (the batch
    carries a matching leading axis: each chain sees its own minibatch).
    Values stack to (K,); grads stack to the params' shapes.  The chains
    run as one batched pass through ``torch.func.vmap`` (the reference's
    ``jax.vmap``), so the model must be a pure function of its tensors."""
    from torch.func import grad, grad_and_value, vmap

    gv = vmap(grad_and_value(potential.value))

    def value_and_grad_(params, batch):
        grads, values = gv(params, batch)
        return values, grads

    return Potential(value=vmap(potential.value), grad=vmap(grad(potential.value)),
                     value_and_grad=value_and_grad_, nll=vmap(potential.nll))
