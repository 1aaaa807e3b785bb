"""Rank functions of the port's sharded-serving CPU tests
(``tests/test_torch_sharded_serve.py``).

``repro_torch.launch.mesh.spawn_local`` runs them in spawned processes of
one gloo process group, so this module imports torch, numpy and
``repro_torch`` only (no jax).  The parent hands in the members (drawn by
the reference's ``init_params``, as numpy) and the request traces; each
rank serves them through ``ServeEngine(mesh=make_engine_mesh(m, s))`` and
returns tokens, log-probs and collective counts as plain values.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _interop, core
from repro_torch.core import rng
from repro_torch.distributed import collective_counts, reset_collective_counts
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import get_model, tree_map
from repro_torch.serve.engine import RefreshScheduler, ServeEngine, SnapshotRegistry
from repro_torch.serve.sampling import SamplingParams

STUB_VOCAB = 11  # tests/test_serve_engine.py's stub
SAMPLED = SamplingParams(temperature=0.7, top_k=50)
MESHES = {1: ((1, 1),), 2: ((2, 1), (1, 2)), 4: ((2, 2),)}
NUM_SLOTS, MAX_SEQ = 4, 16
REFRESH_PREC = 2500.0


def stub_model():
    """The reference's stub engine model in torch: next token = (last + 1)
    % vocab as one-hot logits scaled by the member's ``scale``."""
    def one_hot(tok):
        return F.one_hot((tok.long() + 1) % STUB_VOCAB, STUB_VOCAB).float()

    def prefill(cfg, params, batch, max_seq, cache_dtype=None):
        tokens = batch["tokens"]
        last = tokens[:, -1:]
        return params["scale"] * one_hot(last), {
            "t": torch.tensor(tokens.shape[1], dtype=torch.int32), "last": last}

    def decode_step(cfg, params, cache, tokens):
        return params["scale"] * one_hot(tokens), {"t": cache["t"] + 1, "last": tokens}

    def make_cache(cfg, batch, max_seq, dtype, device="cpu"):
        return {"t": torch.zeros((batch,), dtype=torch.int32, device=device),
                "last": torch.zeros((batch, 1), dtype=torch.int32, device=device)}

    return SimpleNamespace(prefill=prefill, decode_step=decode_step, make_cache=make_cache,
                           paged=None)


STUB_CFG = SimpleNamespace(compute_dtype=torch.float32, vocab_size=STUB_VOCAB)


def stub_members(k: int):
    return {"scale": 10.0 * (1.0 + torch.arange(k, dtype=torch.float32)[:, None])}


def model_of(name, data):
    """(cfg, model, members) of ``"stub"``, ``"stub3"`` (K = 3) or
    ``"smoke"`` (SMOKE qwen3-0.6b, the parent's members)."""
    if name.startswith("stub"):
        return STUB_CFG, stub_model(), stub_members(3 if name == "stub3" else 4)
    cfg = data["smoke_cfg"]
    return cfg, get_model(cfg), _interop.tree_from_numpy(data["smoke_members"])


def _result(rep):
    return {r.rid: {"tokens": r.tokens.tolist(),
                    "logprobs": None if r.logprobs is None else np.asarray(r.logprobs)}
            for r in rep.results}


def _delta(a, b):
    return {op: {k: b[op][k] - a[op][k] for k in ("calls", "bytes")} for op in a}


def instrument(eng):
    """Wrap the engine's tick and admit: the collectives of each call and
    of the host work between calls, and the registry version at each tick
    (read after that tick's pump)."""
    log, versions, last = [], [], [collective_counts()]

    def wrap(kind, fn):
        def call(*args, **kw):
            before = collective_counts()
            log.append(("between", _delta(last[0], before)))
            if kind == "tick":
                versions.append(eng.registry.version)
            out = fn(*args, **kw)
            last[0] = collective_counts()
            log.append((kind, _delta(before, last[0])))
            return out
        return call

    eng._decode = wrap("tick", eng._decode)
    eng._admit = wrap("admit", eng._admit)

    def finish():
        log.append(("between", _delta(last[0], collective_counts())))
        return log, versions

    return finish


def serve(name, data, mesh, trace, **kw):
    cfg, model, members = model_of(name, data)
    eng = ServeEngine(cfg, model, members, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                      record_logprobs=True, mesh=mesh, device="cpu", **kw)
    reset_collective_counts()
    finish = instrument(eng)
    if trace is None:
        trace = data["traces"]["stub" if name.startswith("stub") else name]
    rep = eng.run(trace)
    log, versions = finish()
    return eng, rep, {"results": _result(rep), "log": log, "k_local": eng._k_local,
                      "slots": eng._slots}


def refresh_run(data, mesh, skew_rank=None):
    """``tests/test_sharding.py::test_overlapped_refresh_parks_on_spare_device``
    on the port: the stub ensemble refreshed by SGLD chains (chunks of 4
    steps, a micro-chunk a tick) through ``RefreshScheduler``.  On rank
    ``skew_rank`` each staged verdict reads as not ready for its first two
    queries and the side stream as busy at every third, as a slow card's
    events would: the mesh's agreement must keep the ranks in step."""
    stack = stub_members(4)
    reg = SnapshotRegistry(stack)
    center = tree_map(lambda x: x[0], stack)
    sched = RefreshScheduler(
        reg, core.sgld(step_size=8e-5),
        lambda p: tree_map(lambda x, c: REFRESH_PREC * (x - c), p, center),
        tree_map(lambda x: x[0][None].expand(x.shape).clone(), stack),
        key=rng.key(8), chunk_steps=4)
    if skew_rank is not None and torch.distributed.get_rank() == skew_rank:
        staged_passes, queries, idle_calls = reg.staged_passes, {}, [0]

        def slow_verdict(wait=False):
            if wait or reg.staged is None:
                return staged_passes(wait)
            n = queries[reg.staged_total] = queries.get(reg.staged_total, 0) + 1
            return staged_passes() if n > 2 else None

        def busy_every_third():
            idle_calls[0] += 1
            return idle_calls[0] % 3 != 0

        reg.staged_passes, sched._sampler_idle = slow_verdict, busy_every_third
    eng = ServeEngine(STUB_CFG, stub_model(), reg, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                      refresher=sched, refresh_every=2, mesh=mesh, device="cpu")
    placed = []
    place = eng._place_members
    eng._place_members = lambda tree: placed.append(1) or place(tree)
    finish = instrument(eng)
    rep = eng.run(data["refresh_trace"])
    _, versions = finish()
    return {"results": _result(rep), "versions": versions, "final_version": reg.version,
            "promoted": reg.promoted, "placed": len(placed),
            "placed_version": eng._placed_version, "refresher": rep.refresher,
            "device": sched.device, "members": {k: v.numpy() for k, v in reg.members.items()}}


def serve_checks(rank, world, data):
    """Everything ``tests/test_torch_sharded_serve.py`` reads, for one world
    size: per mesh of ``MESHES[world]``, the stub and SMOKE models greedy
    and sampled on the dense engine; on (2, 1)
    also the paged engine, K = 3 on the member axis of 2, and live
    refresh; ``make_engine_mesh``'s default shape, and at W = 2 its
    refusals."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    torch.manual_seed(0)
    out = {"rank": rank, "runs": {}, "default_shape": tuple(make_engine_mesh(min(world, 2)).shape)}
    for m, s in MESHES[world]:
        mesh = make_engine_mesh(m, s)
        for name in ("stub", "smoke"):
            for sampled in (False, True):
                kw = dict(sampling=SAMPLED, seed=3) if sampled else {}
                out["runs"][(m, s, name, sampled)] = serve(name, data, mesh, None, **kw)[2]
        if (m, s) == (2, 1):
            eng, _, res = serve("smoke", data, mesh, data["paged_trace"], paged=True,
                                block_size=4)
            eng.pool.alloc.check()
            res["alloc_checked"] = True
            out["runs"][(m, s, "smoke-paged", False)] = res
            out["runs"][(m, s, "stub3", False)] = serve("stub3", data, mesh, None)[2]
            out["refresh"] = refresh_run(data, mesh)
            out["refresh_skewed"] = refresh_run(data, mesh, skew_rank=1)
    if world == 2:
        out["mesh_errors"] = []
        for shape in ((3, None), (2, 2), (1, 1), (0, 2)):
            try:
                make_engine_mesh(*shape)
            except ValueError as e:
                out["mesh_errors"].append(str(e))
            else:
                out["mesh_errors"].append(None)
    return out


def unsharded(data):
    """The port's unsharded engine on what ``serve_checks`` serves (in the
    parent: no process group)."""
    runs = {}
    for name in ("stub", "smoke"):
        for sampled in (False, True):
            kw = dict(sampling=SAMPLED, seed=3) if sampled else {}
            runs[(name, sampled)] = serve(name, data, None, None, **kw)[2]
    runs[("smoke-paged", False)] = serve("smoke", data, None, data["paged_trace"], paged=True,
                                         block_size=4)[2]
    runs[("stub3", False)] = serve("stub3", data, None, None)[2]
    runs["refresh"] = refresh_run(data, None)
    return runs
