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
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map, tree_unflatten

CHAIN_AXES = ("pod", "chain")  # the mesh axes a DTensor chain stack is split over


def _chain_axes(mesh) -> list:
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n in CHAIN_AXES]


def _local_chain(x, k: int):
    """Local chain ``k`` of a (K, ...)-stacked DTensor: this rank's block
    of it, as a DTensor on the mesh without the chain axes (the chain axes
    shard dim 0, every other mesh dim a later dim or none)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    rest = [i for i in range(mesh.ndim) if i not in _chain_axes(mesh)]
    sub = mesh[tuple(mesh.mesh_dim_names[i] for i in rest)]
    pl = tuple(Shard(x.placements[i].dim - 1) if x.placements[i].is_shard()
               else x.placements[i] for i in rest)
    return shd.as_dtensor(x.to_local()[k], pl, sub, tuple(x.shape[1:]))


def _chain_total(values, like):
    """The sum over every chain of per-chain 0-d values: over the local
    chains, then (DTensors) over the chain axes of ``like``'s mesh."""
    if not shd.is_dtensor(like):
        return torch.sum(torch.stack(values))
    from torch.distributed.tensor import Partial, Replicate

    mesh = like.device_mesh
    local = torch.sum(torch.stack([v.full_tensor() if shd.is_dtensor(v) else v for v in values]))
    chains = [i for i in _chain_axes(mesh) if like.placements[i].is_shard()]
    pl = tuple(Partial() if i in chains else Replicate() for i in range(mesh.ndim))
    total = shd.as_dtensor(local, pl, mesh, ())
    return total.to_local() if mesh.size() == 1 else total.redistribute(
        mesh, (Replicate(),) * mesh.ndim).to_local()


def make_grad_fn(cfg: ModelConfig, model, n_data: int, weight_decay: float = 1e-5):
    """Gradient-of-potential closure: (targets, batch) -> (grads, metrics).
    On DTensors (the dry-run cells) the loop runs over this rank's local
    chains, each on the mesh without the chain axes, and the stack is
    never gathered."""
    prior = gaussian_prior(weight_decay)

    def per_chain(p, b):
        sum_nll, count = model.train_nll(cfg, p, b)
        scale = float(n_data) / torch.clamp(count, min=1.0)
        return scale * sum_nll + prior.energy(p), (sum_nll.detach(), count)

    vag = value_and_grad(per_chain, has_aux=True)

    def grad_fn(targets, batch):
        first = tree_leaves(targets)[0]
        dt = shd.is_dtensor(first)
        k_chains = int((first.to_local() if dt else first).shape[0])
        chain = _local_chain if dt else (lambda x, k: x[k])
        grads = tree_map(torch.empty_like, targets)
        us, nlls, counts = [], [], []
        for k in range(k_chains):
            (u, (sum_nll, count)), g = vag(tree_map(lambda x: chain(x, k), targets),
                                           tree_map(lambda x: chain(x, k), batch))
            for dst, src in zip(tree_leaves(grads), tree_leaves(g)):
                if dt:
                    dst.to_local()[k].copy_(src.to_local())
                else:
                    dst[k].copy_(src)
            del g
            us.append(u)
            nlls.append(sum_nll)
            counts.append(count)
        metrics = {
            "potential": _chain_total(us, first),
            "nll_per_token": _chain_total(nlls, first)
            / torch.clamp(_chain_total(counts, first), min=1.0),
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
        if shd.is_dtensor(tree_leaves(params)[0]):
            return params, _update_blocks(sampler, grads, state, params, rng, noise), metrics
        updates, new_state = sampler.update(grads, state, params, rng, noise=noise)
        del grads
        return apply_updates(params, updates), new_state, metrics

    return train_step


CENTER_FIELDS = ("center", "center_momentum", "center_stale", "mean_theta_stale")


def _chainless(th) -> dict:
    """The layout of a center leaf beside its chain stack ``th``: the stack's
    layout without its chain dim (every chain axis replicates it)."""
    return {i: p.dim - 1 for i, p in enumerate(th.placements) if p.is_shard() and p.dim > 0}


def _update_blocks(sampler, grads, state, params, rng, noise):
    """The sampler's update on DTensors, run on each rank's blocks: the
    stacks (params, momenta, grads) as they lie, each center leaf brought to
    its stack's layout without the chain dim (and written back after).  The
    sampler is built with ``chain_axis="chain"``: its chain mean is one
    all-reduce over the chain axes (``distributed.collectives``), as in
    ``run_sharded``.  Params are advanced in place; returns the state."""
    from repro_torch.distributed import collectives
    from repro_torch.models import spmd

    first = tree_leaves(params)[0]
    mesh = first.device_mesh
    local = lambda tree: tree_map(lambda x: x.to_local(), tree)  # noqa: E731
    centers = {f: [spmd.to_layout(c, mesh, _chainless(th)) for c, th in
                   zip(tree_leaves(getattr(state, f)), tree_leaves(params))]
               for f in CENTER_FIELDS if hasattr(state, f)}
    state_l = state._replace(
        momentum=local(state.momentum),
        **{f: tree_unflatten(getattr(state, f), v) for f, v in centers.items()})
    if noise is not None:
        th_l = tree_leaves(params)
        noise = {"p": tree_unflatten(noise["p"], [
                     shd.block(n, th.placements, mesh) for n, th in
                     zip(tree_leaves(noise["p"]), th_l)])} | (
            {"r": tree_unflatten(noise["r"], [
                spmd.to_layout(n, mesh, _chainless(th)) for n, th in
                zip(tree_leaves(noise["r"]), th_l)])} if "r" in noise else {})
    chains = _chain_axes(mesh)
    rest = [i for i in range(mesh.ndim) if i not in chains]
    coord = mesh.get_coordinate()
    block_id = 0
    for i in rest:  # distinct noise per block of the elements, the same per chain replica
        block_id = block_id * mesh.size(i) + coord[i]
    if block_id and rng is not None:
        from repro_torch.core import rng as rnglib

        rng = rnglib.fold_in(rng, block_id)
    with collectives.bind_axis("chain", chain_binding(mesh)):
        updates, new_state = sampler.update(local(grads), state_l, local(params), rng,
                                            noise=noise)
    apply_updates(local(params), updates)
    for f in centers:
        for c, c_l, th in zip(tree_leaves(getattr(state, f)), tree_leaves(getattr(new_state, f)),
                              tree_leaves(params)):
            if c.to_local().untyped_storage()._cdata != c_l.untyped_storage()._cdata:
                spmd.copy_(c, spmd.wrap(c_l, mesh, _chainless(th)))
    return state._replace(step=new_state.step)


_BINDINGS: dict = {}  # id(mesh) -> (mesh, binding)


def chain_binding(mesh):
    """The chain axes of ``mesh`` as one axis (a flattened group for pod
    and chain), made once per mesh: ``build_cell`` makes it, since a group
    cannot be made under ``FakeTensorMode``."""
    from repro_torch.distributed.collectives import AxisBinding

    hit = _BINDINGS.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    names = tuple(mesh.mesh_dim_names[i] for i in _chain_axes(mesh))
    if not names:
        raise ValueError(f"a train cell's mesh needs a chain axis, got {mesh.mesh_dim_names}")
    sub = mesh[names] if len(names) == 1 else mesh[names]._flatten()
    binding = AxisBinding(sub.get_group(), int(sub.get_local_rank()), int(sub.size()))
    _BINDINGS[id(mesh)] = (mesh, binding)
    return binding
