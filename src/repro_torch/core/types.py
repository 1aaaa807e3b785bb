"""Core type definitions of the port's SG-MCMC samplers.

Samplers follow the reference's optax-style ``(init, update)`` transform
API, over nested dicts of tensors (or a bare tensor):

    sampler = ec_sghmc(step_size=1e-2, alpha=1.0, ...)
    state   = sampler.init(params)
    updates, state = sampler.update(grads, state, params, rng)
    params  = apply_updates(params, updates)

``grads`` are gradients of the potential energy U(θ) (the negative log
posterior); the sampler descends U.  For elastically coupled samplers
every leaf of ``params``/``grads`` carries a leading chain axis of size K.
``rng`` is a key of ``core.rng`` (a 64-bit integer); ``update`` also takes
``noise=``, the draws a parity test hands in instead (see each sampler).
``state.step`` is a host-side int.

This 4-tuple is also the protocol ``run.ChainExecutor`` drives.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

Params = Any  # nested dict of tensors
State = Any
Updates = Any  # same structure as Params


class Sampler(NamedTuple):
    """A stateful parameter-update transform.

    ``grad_targets`` (optional): (state, params) -> tree at which the
    caller must evaluate gradients before calling ``update``; ``None``
    means "at params".

    ``stats`` (optional): (state, params) -> dict of 0-d tensors of
    diagnostics (no host sync).  ``None`` means the sampler exposes
    nothing.
    """

    init: Callable[[Params], State]
    # update(grads, state, params, rng, noise=None) -> (updates, new_state)
    update: Callable[..., tuple[Updates, State]]
    grad_targets: Callable[[State, Params], Params] | None = None
    stats: Callable[[State, Params], dict] | None = None
