"""Rank functions of the dry run's multi-rank CPU test, and the shapes the
dry-run tests narrow the cells to.

``repro_torch.launch.mesh.spawn_local`` runs the rank functions in spawned
processes of one gloo process group, so this module imports torch, numpy
and ``repro_torch`` only.  Each rank builds the SMOKE cell on its mesh,
places the same full arguments (drawn from a seed) as DTensors, runs the
cell's step on real CPU tensors, and gathers the results; rank 0 also runs
the plain unsharded step on the full arguments.  Results come back as
numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import rng as rnglib
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import N_DATA, build_cell, default_sampler
from repro_torch.models import get_model, init_params, tree_leaves
from repro_torch.models.common import map_tensors, tree_map
from repro_torch.serve.loop import make_decode_step
from repro_torch.train.step import make_train_step

# the reference's tests/test_dryrun_smoke.py narrows the grid so
SMOKE_SHAPES = {
    "train_4k": ("train", 64, 8),
    "prefill_32k": ("prefill", 64, 8),
    "decode_32k": ("decode", 64, 8),
    "long_500k": ("decode", 256, 1),
}
K, SYNC = 2, 4


def narrow_shapes() -> None:
    for name, (kind, seq, batch) in SMOKE_SHAPES.items():
        configs.SHAPES[name] = configs.ShapeCell(name, kind, seq, batch)


def distribute_tree(tree, placements_tree, mesh):
    """DTensors of a tree of full tensors (the same on every rank): each
    rank keeps its block of each leaf; host values (placements None) as
    they are."""
    return map_tensors(lambda x, pl: x if pl is None else shd.as_dtensor(
        shd.block(x, pl, mesh).contiguous(), pl, mesh, x.shape), tree, placements_tree)


def _np(tree):
    return map_tensors(lambda t: (t.full_tensor() if shd.is_dtensor(t) else t)
                       .detach().float().numpy(), tree)


def _noise_fn(cfg, params):
    """The sampler's noise for a step, drawn from the step alone, shaped
    like the momentum ("p") and the center ("r")."""
    def fn(step):
        g = torch.Generator().manual_seed(1000 + int(step))
        return {"p": tree_map(lambda x: torch.randn(x.shape, generator=g), params),
                "r": tree_map(lambda x: torch.randn(x.shape[1:], generator=g), params)}
    return fn


def train_rank(rank, world, arch):
    """The SMOKE train cell on a (chain 1, data 2, model 2) mesh, K = 2
    chains at the syncing step, against the plain step (rank 0)."""
    torch.set_num_threads(1)
    narrow_shapes()
    cfg = configs.get_config(arch, smoke=True)
    model = get_model(cfg)
    mesh = mesh_lib.make_train_mesh(1, size=2)
    gen = torch.Generator().manual_seed(3)
    params = tree_map(lambda *ls: torch.stack(ls),
                      *[init_params(model.param_specs(cfg), gen, "cpu") for _ in range(K)])
    shape = configs.SHAPES["train_4k"]
    toks = torch.randint(0, cfg.vocab_size, (K, shape.global_batch // K, shape.seq_len + 1),
                         generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
    noise_fn = _noise_fn(cfg, params)
    cell = build_cell(arch, "train_4k", mesh, smoke=True, num_chains=K, sync_every=SYNC,
                      noise_fn=noise_fn)
    sampler = default_sampler(cfg, arch, K, SYNC)
    state = sampler.init(tree_map(torch.clone, params))._replace(step=SYNC - 1)
    key = rnglib.key(5)
    args = distribute_tree(map_tensors(torch.clone, (params, state, batch, key)),
                               cell.in_shardings, mesh)
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        p_dt, s_dt, m_dt = cell.fn(*args)
    out = {"params": _np(p_dt), "center": _np(s_dt.center), "momentum": _np(s_dt.momentum),
           "mean_theta_stale": _np(s_dt.mean_theta_stale), "step": s_dt.step,
           "metrics": _np(m_dt)}
    if rank == 0:
        plain = make_train_step(cfg, model, sampler, n_data=N_DATA, noise_fn=noise_fn)
        p, s, m = plain(params, state, batch, key)
        out["plain"] = {"params": _np(p), "center": _np(s.center), "momentum": _np(s.momentum),
                        "mean_theta_stale": _np(s.mean_theta_stale), "step": s.step,
                        "metrics": _np(m)}
    return out


def decode_rank(rank, world, arch):
    """The SMOKE decode cell on a (data 2, model 2) mesh after a plain
    prefill of 8 tokens, against the plain decode step (rank 0)."""
    torch.set_num_threads(1)
    narrow_shapes()
    cfg = configs.get_config(arch, smoke=True)
    model = get_model(cfg)
    mesh = mesh_lib.make_production_mesh(size=2)
    shape = configs.SHAPES["decode_32k"]
    gen = torch.Generator().manual_seed(4)
    params = init_params(model.param_specs(cfg), gen, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (shape.global_batch, 8), generator=gen,
                           dtype=torch.int32)
    _, cache = model.prefill(cfg, params, {"tokens": prompt}, shape.seq_len)
    tok = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1), generator=gen,
                        dtype=torch.int32)
    cell = build_cell(arch, "decode_32k", mesh, smoke=True)
    args = distribute_tree((params, tree_map(torch.clone, cache), tok), cell.in_shardings,
                               mesh)
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        t_dt, c_dt = cell.fn(*args)
    out = {"tokens": _np(t_dt), "cache": [_np(x) for x in tree_leaves(c_dt)]}
    if rank == 0:
        t, c = make_decode_step(cfg, model)(params, cache, tok)
        out["plain"] = {"tokens": _np(t), "cache": [_np(x) for x in tree_leaves(c)]}
    return out


def cells_rank(rank, world, archs):
    """``train_rank`` and ``decode_rank`` of each arch, in one process."""
    return {(arch, kind): fn(rank, world, arch) for arch in archs
            for kind, fn in (("train", train_rank), ("decode", decode_rank))}
