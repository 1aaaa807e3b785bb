"""Naive asynchronous SGHMC, the paper's "approach I" baseline (§2).

A parameter server holds a SINGLE chain (theta, p).  K workers each hold a
stale snapshot thetã^k of the server parameters, pulled when they last
pushed.  Every step, the workers whose round-robin phase matches
``t mod s`` push a stochastic gradient computed at their stale snapshot
and pull fresh parameters; the server averages the O arrived gradients
and advances Eq. 4 with them:

    ĝ_t = (1/O) sum_{k arrived} grad Ũ(thetã^k_t)      (staleness = s steps)

With s = 1 every worker arrives every step, which is synchronous-parallel
SGHMC; for s > 1 the stale gradients act as extra noise, the regime where
the paper shows this scheme breaks down while EC-SGHMC holds up (Fig. 2
left, s = 8).

Information pattern (as in the reference): ``grad_targets`` returns all K
snapshots, so the caller computes every worker's gradient, and only the
arrived ones enter ĝ.  ``state.step`` is a host int, so the arrivals are
known on the host: workers k = t mod s, t mod s + s, ..., a strided view of
the worker axis.  A step where no worker arrives (s > K) leaves the server
idle: updates are zero and p is unchanged, but the step's noise is still
drawn.  ``update`` writes p and the arrived snapshots IN PLACE; the state
passed in is consumed.  ``update(..., noise=tree)`` takes the standard
normals (shaped like the momentum) instead of drawing them from ``rng``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .schedules import as_schedule
from .sghmc import _noise_scale
from .tree_util import leaf_normals, tree_leaves, tree_map
from .types import Sampler

F32 = np.float32


class AsyncSGHMCState(NamedTuple):
    momentum: Any  # server-side p : (...)
    snapshots: Any  # worker-side thetã^k : (K, ...), f32
    step: int


def async_sghmc(
    step_size,
    num_workers: int,
    friction: float = 1.0,
    mass: float = 1.0,
    sync_every: int = 1,  # s : staleness / communication period
    temperature: float = 1.0,
    noise_convention: str = "eq4",
) -> Sampler:
    schedule = as_schedule(step_size)
    minv = 1.0 / mass
    s = int(sync_every)
    K = int(num_workers)

    def init(params):
        return AsyncSGHMCState(
            momentum=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            snapshots=tree_map(lambda p: p.float()[None].repeat((K,) + (1,) * p.ndim), params),
            step=0,
        )

    def grad_targets(state, params):
        del params
        return state.snapshots

    def update(grads, state, params, rng=None, noise=None):
        """``grads`` have a leading worker axis K (evaluated at the snapshots)."""
        eps = F32(schedule(state.step))
        # worker k reports at the steps t with t % s == k % s: the workers
        # k = r, r + s, r + 2s, ... (r = t mod s), a strided view of the
        # worker axis, so neither the mean nor the pull needs an index tensor
        arrived_rows = slice(state.step % s, None, s)
        n_arrived = len(range(K)[arrived_rows])
        sigma = float(F32(temperature**0.5) * _noise_scale(eps, friction, 0.0, noise_convention))
        normals = leaf_normals(noise, rng, state.momentum)
        if n_arrived == 0:  # idle server: the identity step; the noise is drawn all the same
            for _ in normals:
                pass
            updates = tree_map(torch.zeros_like, state.momentum)
            return updates, state._replace(step=state.step + 1)

        em = float(eps * F32(minv))
        decay = float(F32(1.0) - eps * F32(friction) * F32(minv))
        e = float(eps)
        updates = tree_map(lambda p: em * p, state.momentum)
        for p, g, n in zip(tree_leaves(state.momentum), tree_leaves(grads), normals):
            # the f32 mean of the arrived workers' gradients
            ghat = torch.sum(g[arrived_rows].float(), dim=0) / float(n_arrived)
            # sghmc's association (1 - eps V M^-1) p, so that one worker at
            # s = 1 is the port's SGHMC bit for bit
            p.copy_(decay * p - e * ghat + sigma * n)
        # arrived workers pull the post-update server params
        for snap, th, u in zip(*map(tree_leaves, (state.snapshots, params, updates))):
            snap[arrived_rows] = th.float() + u
        return updates, state._replace(step=state.step + 1)

    return Sampler(init, update, grad_targets)
