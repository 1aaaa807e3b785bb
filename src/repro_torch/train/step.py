"""train_step constructor: model + sampler -> one posterior-sampling step.

Params and grads carry a leading chain axis K.  The reference vmaps the
model over it; the port writes the chain axis out as a loop of K
forward/backward passes, each writing its gradients into one stacked
(K, ...) buffer.  That keeps one chain's activations and gradients alive
at a time, which is the smaller peak (``torch.func.vmap`` would hold all
K chains' activations and a second stacked gradient tree).  Because the
chains are independent in the likelihood, this equals the gradient of the
summed potential, as in the reference.

* ``make_grad_fn`` — ``(targets, batch) -> (grads, metrics)``, the piece
  an executor in sampler mode drives;
* ``make_train_step`` — ``(params, state, batch, rng) -> (params, state,
  metrics)``, honouring ``Sampler.grad_targets``, for the executor's
  ``step_fn`` mode (what ``train/loop.py`` runs).  Params are advanced in
  place.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import apply_updates, gaussian_prior
from repro_torch.core.potential import value_and_grad
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map


def make_grad_fn(cfg: ModelConfig, model, n_data: int, weight_decay: float = 1e-5):
    """Gradient-of-potential closure: (targets, batch) -> (grads, metrics)."""
    prior = gaussian_prior(weight_decay)

    def per_chain(p, b):
        sum_nll, count = model.train_nll(cfg, p, b)
        scale = float(n_data) / torch.clamp(count, min=1.0)
        return scale * sum_nll + prior.energy(p), (sum_nll.detach(), count)

    vag = value_and_grad(per_chain, has_aux=True)

    def grad_fn(targets, batch):
        k_chains = int(tree_leaves(targets)[0].shape[0])
        grads = tree_map(torch.empty_like, targets)
        us, nlls, counts = [], [], []
        for k in range(k_chains):
            (u, (sum_nll, count)), g = vag(tree_map(lambda x: x[k], targets),
                                           tree_map(lambda x: x[k], batch))
            for dst, src in zip(tree_leaves(grads), tree_leaves(g)):
                dst[k].copy_(src)
            del g
            us.append(u)
            nlls.append(sum_nll)
            counts.append(count)
        metrics = {
            "potential": torch.sum(torch.stack(us)),
            "nll_per_token": torch.sum(torch.stack(nlls))
            / torch.clamp(torch.sum(torch.stack(counts)), min=1.0),
        }
        return grads, metrics

    return grad_fn


def make_train_step(cfg: ModelConfig, model, sampler, n_data: int, weight_decay: float = 1e-5,
                    noise_fn: Callable | None = None):
    """``noise_fn(step) -> noise`` hands each step's sampler noise in (the
    parity seam of ``Sampler.update``); None lets the sampler draw its own
    from the step's key."""
    grad_fn = make_grad_fn(cfg, model, n_data, weight_decay)

    def train_step(params, state, batch, rng):
        targets = sampler.grad_targets(state, params) if sampler.grad_targets else params
        grads, metrics = grad_fn(targets, batch)
        noise = noise_fn(state.step) if noise_fn is not None else None
        updates, new_state = sampler.update(grads, state, params, rng, noise=noise)
        del grads
        return apply_updates(params, updates), new_state, metrics

    return train_step
