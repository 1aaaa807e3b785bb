"""Rank functions of the port's multi-rank CPU tests.

``repro_torch.launch.mesh.spawn_local`` runs them in spawned processes of
one gloo process group, so this module imports torch, numpy and
``repro_torch`` only (no jax: the children stay light).  Each returns
numpy arrays and plain Python values, which the parent compares with the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import core
from repro_torch.core import rng
from repro_torch.distributed import (
    bind_axis,
    collective_counts,
    compressed_tree_mean,
    gather_chains,
    int8_codec,
    local_chains,
    mesh_axis,
    reset_collective_counts,
)
from repro_torch.launch.mesh import make_chain_mesh
from repro_torch.models.common import tree_leaves
from repro_torch.run import ChainExecutor

K, SYNC, STEPS = 4, 4, 48
MU = 1.5
CASES = {  # case -> ec_sghmc keywords (compression as a flag)
    "unfused_a0": dict(alpha=0.0),
    "fused_a0": dict(alpha=0.0, fused=True),
    "unfused_a1": dict(alpha=1.0),
    "fused_a1": dict(alpha=1.0, fused=True),
    "int8_a1": dict(alpha=1.0, compression=True),
}


def params0(k=K, seed=0):
    """A two-leaf tree of k chains; no center leaf has a leading dim of 1,
    2 or 4 (the chain counts per rank), so the shape rule splits only the
    chain tensors."""
    r = np.random.default_rng(seed)
    return {"a": torch.from_numpy((MU + r.normal(size=(k, 3, 5))).astype(np.float32)),
            "b": {"w": torch.from_numpy((MU + r.normal(size=(k, 7))).astype(np.float32))}}


def sampler(case, chain_axis):
    kw = dict(CASES[case])
    compression = int8_codec() if kw.pop("compression", False) else None
    per_chain = None if chain_axis is not None else not kw.get("fused", False)
    return core.ec_sghmc(step_size=1e-2, sync_every=SYNC, noise_convention="eq6",
                         chain_axis=chain_axis, per_chain_noise=per_chain,
                         compression=compression, **kw)


def executor(samp):
    return ChainExecutor(sampler=samp, grad_fn=lambda t, _b: core.tree_util.tree_map(
        lambda x: x - MU, t), moments=True, chunk_steps=16, key_mode="fold")


def _np(tree):
    return [x.detach().cpu().numpy().copy() for x in tree_leaves(tree)]


def _state_np(st):
    return {name: _np(getattr(st, name)) for name in
            ("momentum", "center", "center_momentum", "center_stale", "mean_theta_stale")}


def _sharded_case(case, mesh, steps=STEPS):
    samp = sampler(case, "chain")
    p_g = params0()
    s_g = samp.init(p_g)
    reset_collective_counts()
    res = executor(samp).run_sharded(local_chains(p_g, mesh, K), local_chains(s_g, mesh, K),
                                     num_steps=steps, key=rng.key(7), mesh=mesh)
    counts = collective_counts()
    return {"counts": counts, "local": _np(res.params), "state": _state_np(res.state),
            "params": _np(gather_chains(res.params, mesh, K)),
            "moments_mean": _np(res.moments.mean)}


def _unsharded_case(case, steps=STEPS):
    samp = sampler(case, None)
    p = params0()
    res = executor(samp).run(p, samp.init(p), num_steps=steps, key=rng.key(7))
    return {"params": _np(res.params), "state": _state_np(res.state)}


def _per_step_counts(mesh, case):
    """The collectives of each single-step run_sharded call over 2 sync
    periods and one step more."""
    samp = sampler(case, "chain")
    p_g = params0()
    p, s = local_chains(p_g, mesh, K), local_chains(samp.init(p_g), mesh, K)
    ex, counts = executor(samp), []
    for t in range(2 * SYNC + 1):
        reset_collective_counts()
        res = ex.run_sharded(p, s, num_steps=1, key=rng.key(7), mesh=mesh, start_step=t)
        p, s = res.params, res.state
        counts.append(collective_counts())
    return counts


def _rejections(world):
    from torch.distributed.device_mesh import init_device_mesh

    samp = sampler("unfused_a1", "chain")
    p = params0(3)
    out = {}
    for name, mesh, k in (("axis", init_device_mesh("cpu", (world,), mesh_dim_names=("data",)), 3),
                          ("divisible", make_chain_mesh(world), 3)):
        try:
            executor(samp).run_sharded(p, samp.init(p), num_steps=2, key=rng.key(0), mesh=mesh,
                                       num_chains=k)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _coupled(mesh, world):
    """2048 steps of K = 4 chains on a 2-D Gaussian, raw and compressed."""
    out = {}
    mu = torch.tensor([2.0, -1.0])
    for comp in (False, True):
        samp = core.ec_sghmc(step_size=1e-2, alpha=1.0, sync_every=SYNC, noise_convention="eq6",
                             chain_axis="chain", compression=int8_codec() if comp else None)
        ex = ChainExecutor(sampler=samp, grad_fn=lambda t, _b: t - mu, moments=True,
                           moments_from=512, chunk_steps=512, key_mode="fold")
        p_g = torch.tensor([-2.0, 3.0]).expand(K, 2).clone()
        reset_collective_counts()
        res = ex.run_sharded(local_chains(p_g, mesh, K), local_chains(samp.init(p_g), mesh, K),
                             num_steps=2048, key=rng.key(0), mesh=mesh)
        counts = collective_counts()
        out["int8" if comp else "raw"] = {
            "counts": counts, "params": gather_chains(res.params, mesh, K).numpy(),
            "mean": res.moments.mean.numpy().mean(axis=0)}
    return out


def sharding_checks(rank, world):
    """Everything ``tests/test_torch_sharding.py`` reads, for one world
    size: every case sharded; at W = 1 the unsharded runs too; at W = 2
    the per-step collective counts and the rejections; at W = 4 the
    coupled long runs."""
    torch.manual_seed(0)
    mesh = make_chain_mesh(world)
    out = {"rank": rank, "cases": {c: _sharded_case(c, mesh) for c in CASES}}
    if world == 1:
        out["unsharded"] = {c: _unsharded_case(c) for c in CASES}
    if world == 2:
        out["per_step"] = {c: _per_step_counts(mesh, c) for c in ("unfused_a1", "int8_a1")}
        out["rejected"] = _rejections(world)
    if world == 4:
        out["coupled"] = _coupled(mesh, world)
    return out


def compressed_mean_rank(rank, world, local_trees):
    """``compressed_tree_mean`` and ``tree_mean_axis0`` over the chain axis
    of this rank's tree of local chains, each with its collectives."""
    mesh = make_chain_mesh(world)
    tree = {k: torch.from_numpy(v) for k, v in local_trees[rank].items()}
    out = []
    with bind_axis("chain", mesh_axis(mesh, "chain")):
        for mean in (compressed_tree_mean, core.tree_util.tree_mean_axis0):
            reset_collective_counts()
            m = mean(tree, "chain")
            out.append(({k: v.numpy() for k, v in m.items()}, collective_counts()))
    return out


def sampler_steps_rank(rank, world, jobs):
    """For each job ``(kind, params, noises, kw)``: steps of ``ec_sghmc`` or
    ``ec_sgld`` (``kind``) built with ``chain_axis`` and ``kw`` on this
    rank's chains of the global ``params``, with the noise handed in (each
    rank's slice of the chains' noise, the whole center noise).  Returns,
    per job, the local params and the state after each step."""
    mesh = make_chain_mesh(world)
    kl = K // world
    return [_sampler_steps(mesh, rank * kl, (rank + 1) * kl, *job) for job in jobs]


def _tensors(tree):
    return core.tree_util.tree_map(lambda x: (tuple(torch.from_numpy(b) for b in x)
                                              if isinstance(x, tuple) else torch.from_numpy(x)),
                                   tree)


def _sampler_steps(mesh, lo, hi, kind, params, noises, kw):
    build = core.ec_sghmc if kind == "ec_sghmc" else core.ec_sgld
    samp = build(chain_axis="chain", **kw)
    p_g = _tensors(params)
    state = local_chains(samp.init(p_g), mesh, K)
    p = local_chains(p_g, mesh, K)
    chain_key = "p" if kind == "ec_sghmc" else "theta"
    names = ("center", "center_momentum", "center_stale", "mean_theta_stale")
    if kind == "ec_sghmc":
        names = ("momentum",) + names
    history = []
    with bind_axis("chain", mesh_axis(mesh, "chain")):
        for n in noises:
            cut = core.tree_util.tree_map(
                lambda x: tuple(b[lo:hi] for b in x) if isinstance(x, tuple) else x[lo:hi],
                n[chain_key])
            noise = {chain_key: _tensors(cut), "r": _tensors(n["r"])}
            grads = core.tree_util.tree_map(lambda x: x - MU, p)
            up, state = samp.update(grads, state, p, None, noise=noise)
            p = core.apply_updates(p, up)
            history.append({"params": _np(p), **{k: _np(getattr(state, k)) for k in names}})
    return history
