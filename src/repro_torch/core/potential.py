"""Potential energy U(θ) constructors, the bridge between models and samplers.

The paper's target:  p(θ|D) ∝ exp(-U(θ)),
    U(θ)  = - Σ_{x∈D} log p(x|θ) - log p(θ)
    Ũ(θ)  = - (N/|B|) Σ_{x∈B} log p(x|θ) - log p(θ)     (minibatch estimate)

``make_potential`` wraps ``nll_fn(params, batch) -> (sum_nll, batch_size)``
and a prior into value/grad functions; gradients come from
``torch.autograd``.  ``chainwise`` lifts a potential over a leading chain
axis by looping over the chains.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .tree_util import tree_leaves, tree_map, tree_unflatten


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
        grads = torch.autograd.grad(value, leaves)
        out = (value.detach(), out[1]) if has_aux else value.detach()
        return out, tree_unflatten(params, list(grads))

    return vag


def make_potential(nll_fn: Callable, n_data: int, prior: Prior | None = None) -> Potential:
    prior = prior or flat_prior()

    def value(params, batch):
        sum_nll, bsz = nll_fn(params, batch)
        scale = torch.tensor(float(n_data), dtype=torch.float32) / torch.clamp(
            torch.as_tensor(bsz, dtype=torch.float32), min=1.0)
        return scale.to(sum_nll.device) * sum_nll + prior.energy(params)

    def mean_nll(params, batch):
        sum_nll, bsz = nll_fn(params, batch)
        return sum_nll / torch.clamp(torch.as_tensor(bsz, dtype=torch.float32), min=1.0)

    vag = value_and_grad(value)
    return Potential(value=value, grad=lambda p, b: vag(p, b)[1], value_and_grad=vag, nll=mean_nll)


def _chain(tree, k):
    return tree_map(lambda x: x[k], tree)


def chainwise(potential: Potential) -> Potential:
    """Lift a Potential over a leading chain axis K on params (the batch
    carries a matching leading axis: each chain sees its own minibatch).
    Values stack to (K,); grads stack to the params' shapes."""

    def k_of(params):
        return int(tree_leaves(params)[0].shape[0])

    def value(params, batch):
        return torch.stack([potential.value(_chain(params, k), _chain(batch, k))
                            for k in range(k_of(params))])

    def value_and_grad_(params, batch):
        outs = [potential.value_and_grad(_chain(params, k), _chain(batch, k))
                for k in range(k_of(params))]
        values = torch.stack([o[0] for o in outs])
        grads = tree_map(lambda *gs: torch.stack(gs), *[o[1] for o in outs])
        return values, grads

    def nll(params, batch):
        return torch.stack([potential.nll(_chain(params, k), _chain(batch, k))
                            for k in range(k_of(params))])

    return Potential(value=value, grad=lambda p, b: value_and_grad_(p, b)[1],
                     value_and_grad=value_and_grad_, nll=nll)
