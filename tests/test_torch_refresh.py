"""Live snapshot refresh of the port against the reference, on the CPU.

Mirrors ``TestRegistry``, ``TestOverlappedRefresh`` and
``TestExecutorStream`` of ``tests/test_serve_engine.py``:

* ``_micro_split`` equals the reference's on a grid, exactly;
* ``ensemble_spread`` and the registry's promote/reject decisions equal
  the reference's on the same stacks (rtol 1e-6);
* ``ChainExecutor.stream`` matches ``run`` bit for bit, and a promoted
  snapshot does not change when the stream advances (the port's carry is
  written in place, so the stream copies at proposal boundaries);
* ``ChainRefresher`` and ``RefreshScheduler``: exhaustion, amortized pumps,
  micro-split == unsplit bitwise, ``refresh()`` == ``ChainRefresher``,
  draining the last candidate, stale prefix invalidation, ``bind`` advancing
  nothing, ``_pick_device`` with a stubbed device count;
* the port's ``ServeEngine`` + ``ChainRefresher`` against the JAX engine +
  ``ChainRefresher`` on the same SMOKE weights and trace with a noiseless
  SGLD (temperature 0): the same tokens and promotions, log-probs within
  2e-5 (the engine tolerance of ``tests/test_torch_serve_engine.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro.diagnostics import ensemble_spread as jensemble_spread
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.serve.engine import ChainRefresher as JChainRefresher
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import SnapshotRegistry as JSnapshotRegistry
from repro.serve.engine import synthetic_trace as jsynthetic_trace
from repro.serve.engine.registry import _micro_split as j_micro_split
from repro_torch import _interop, core
from repro_torch.core import rng
from repro_torch.diagnostics import ensemble_spread
from repro_torch.models import get_model, tree_leaves, tree_map
from repro_torch.run import ChainExecutor, ChunkSnapshot
from repro_torch.serve.engine import (
    ChainRefresher,
    RefreshScheduler,
    Request,
    ServeEngine,
    SnapshotRegistry,
    synthetic_trace,
)
from repro_torch.serve.engine import refresh as refresh_mod
from repro_torch.serve.engine.registry import _micro_split
from repro_torch.serve.loop import ensemble_diagnostics

LOGP_ATOL = 2e-5
PREC = 2500.0


def _smoke_cfg():
    return jconfigs.get_config("qwen3-0.6b", smoke=True)


@pytest.fixture(scope="module")
def smoke():
    jcfg = _smoke_cfg()
    jmodel = jget_model(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    jstack = jax.vmap(lambda k: jinit_params(jmodel.param_specs(jcfg), k))(keys)
    np_stack = jax.tree.map(np.asarray, jstack)
    cfg = _interop.config_from(jcfg)
    return jcfg, jmodel, np_stack, cfg, get_model(cfg)


def _stack(smoke):
    return _interop.tree_from_numpy(smoke[2])


def _model_refresher(cls, stack, reg, **kw):
    """Chain-stacked SGLD pulled toward member 0 of a real SMOKE stack."""
    center = tree_map(lambda x: x[0].clone(), stack)
    grad_fn = lambda p: tree_map(lambda x, c: PREC * (x - c), p, center)
    start = tree_map(lambda x: x[0][None].expand(x.shape).contiguous(), stack)
    base = dict(key=rng.key(8), chunk_steps=4)
    base.update(kw)
    return cls(reg, core.sgld(step_size=8e-5), grad_fn, start, **base)


def _toy(cls, total_steps=8, chunk_steps=4, **kw):
    start = torch.zeros(2, 3)
    reg = SnapshotRegistry(start + torch.arange(2.0)[:, None])
    return reg, cls(reg, core.sgld(step_size=0.1), lambda p: p, start, key=rng.key(0),
                    chunk_steps=chunk_steps, total_steps=total_steps, **kw)


# --- pure helpers against the reference ----------------------------------------


def test_micro_split_matches_reference():
    for chunk in range(1, 65):
        for cadence in range(0, 21):
            assert _micro_split(chunk, cadence) == j_micro_split(chunk, cadence), (chunk, cadence)


def _stacks(seed):
    g = np.random.default_rng(seed)
    a = {"w": g.normal(size=(3, 5, 4)).astype(np.float32),
         "b": {"x": g.normal(size=(3, 7)).astype(np.float32)}}
    collapsed = {"w": np.repeat(a["w"][:1], 3, 0), "b": {"x": np.repeat(a["b"]["x"][:1], 3, 0)}}
    tiny = {"w": collapsed["w"] + 1e-9 * g.normal(size=(3, 5, 4)).astype(np.float32),
            "b": collapsed["b"]}
    return {"spread": a, "collapsed": collapsed, "tiny": tiny,
            "scaled": {"w": 40.0 * a["w"], "b": {"x": 40.0 * a["b"]["x"]}}}


@pytest.mark.parametrize("name", ["spread", "collapsed", "tiny", "scaled"])
def test_ensemble_spread_and_decisions_match_reference(name):
    stack = _stacks(3)[name]
    ref = jensemble_spread(jax.tree.map(jnp.asarray, stack))
    got = ensemble_spread(_interop.tree_from_numpy(stack))
    assert got.keys() == ref.keys() and got["num_chains"] == ref["num_chains"] == 3
    # rtol 1e-6; a collapsed stack's spread is rounding noise (the
    # reference's f32 mean of equal rows is rounded, so its variance is
    # ~1e-15 where torch's is 0), hence an absolute floor of f32 epsilon on
    # rel_spread and its square (times the mean square) on chain_spread
    eps = float(np.finfo(np.float32).eps)
    ms = float(np.mean([np.mean(np.square(x)) for x in jax.tree.leaves(stack)]))
    floor = {"chain_spread": eps * eps * ms, "mean_param_norm": 0.0, "rel_spread": eps}
    for k in ("chain_spread", "mean_param_norm", "rel_spread"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=floor[k], err_msg=k)
    base = _stacks(4)["spread"]
    jreg = JSnapshotRegistry(jax.tree.map(jnp.asarray, base))
    reg = SnapshotRegistry(_interop.tree_from_numpy(base))
    assert reg.propose(_interop.tree_from_numpy(stack)) == jreg.propose(
        jax.tree.map(jnp.asarray, stack))
    assert (reg.version, reg.rejected) == (jreg.version, jreg.rejected)
    assert reg.last_health["collapsed"] == jreg.last_health["collapsed"]
    np.testing.assert_allclose(reg.last_health["rel_spread"], jreg.last_health["rel_spread"],
                               rtol=1e-6, atol=eps)


# --- registry (mirrors TestRegistry) --------------------------------------------


def test_collapsed_ensemble_flagged(smoke):
    one = tree_map(lambda x: x[0], _stack(smoke))
    collapsed = tree_map(lambda x: x[None].expand((3,) + tuple(x.shape)), one)
    health = ensemble_diagnostics(collapsed)
    assert health["collapsed"] and health["rel_spread"] < 1e-6


def test_registry_refuses_collapsed_keeps_serving_old(smoke):
    stack = _stack(smoke)
    reg = SnapshotRegistry(stack)
    collapsed = tree_map(lambda x: x[:1].expand(x.shape), stack)
    assert not reg.propose(collapsed)
    assert reg.version == 0 and reg.rejected == 1
    assert reg.members is stack
    assert reg.propose(tree_map(lambda x: x * 1.01, stack))
    assert reg.version == 1


def test_registry_rejects_wrong_k_and_collapsed_initial():
    reg = SnapshotRegistry({"w": torch.arange(8.0).reshape(2, 4)})
    with pytest.raises(ValueError):
        reg.propose({"w": torch.ones(3, 4)})
    with pytest.raises(ValueError):
        SnapshotRegistry({"w": torch.ones(3, 4)}, validate=True)


def test_refresher_exhausts():
    _, refr = _toy(ChainRefresher)
    assert refr.refresh()  # independent per-element noise => spread > 0
    assert refr.refresh() and not refr.exhausted
    assert not refr.refresh() and refr.exhausted  # total_steps consumed


def test_chain_refresher_pump_amortizes_chunks():
    reg, refr = _toy(ChainRefresher, total_steps=16, chunk_steps=8)
    refr.bind(SimpleNamespace(refresh_every=4))
    assert refr.micro_steps == 2  # largest divisor of 8 <= ceil(8/4)
    before, flips = [refr.micro_chunks], []
    for i in range(8):
        flips.append(refr.pump(i))
        before.append(refr.micro_chunks)
    assert [b - a for a, b in zip(before, before[1:])] == [1] * 8  # 1 micro/tick
    assert flips == [False, False, False, True] * 2  # chunk boundaries only
    assert refr.refreshes == 2 and refr.steps_done == 16 and reg.version == 2
    assert not refr.pump(8) and refr.exhausted


def test_chain_refresher_split_is_bit_identical():
    _, legacy = _toy(ChainRefresher, total_steps=8, chunk_steps=8)
    legacy.refresh()
    _, split = _toy(ChainRefresher, total_steps=8, chunk_steps=8)
    split.bind(SimpleNamespace(refresh_every=4))
    for i in range(4):
        split.pump(i)
    assert split.micro_steps < split.chunk_steps  # genuinely split
    assert torch.equal(legacy.registry.members, split.registry.members)


def test_live_refresh_through_engine(smoke):
    *_, cfg, model = smoke
    stack = _stack(smoke)
    reg = SnapshotRegistry(stack)
    refresher = _model_refresher(ChainRefresher, stack, reg, chunk_steps=8, total_steps=32)
    engine = ServeEngine(cfg, model, reg, num_slots=2, max_seq=16, refresher=refresher,
                         refresh_every=3, device="cpu")
    reqs = synthetic_trace(4, vocab_size=cfg.vocab_size, prompt_lens=(5,), max_new=6,
                           mean_interarrival=2.0, seed=9)
    report = engine.run(reqs)
    assert report.registry["version"] >= 1 and report.refresher["refreshes"] >= 1
    assert len(report.results) == 4
    with pytest.raises(ValueError):  # a refresher must feed the engine's own registry
        ServeEngine(cfg, model, stack, num_slots=2, max_seq=16, refresher=refresher,
                    refresh_every=3, device="cpu")


# --- overlapped scheduler (mirrors TestOverlappedRefresh) ----------------------


def test_stage_flip_lazy_gate():
    stack = {"w": torch.arange(8.0).reshape(2, 4)}
    reg = SnapshotRegistry(stack)
    assert not reg.staged_ready()  # nothing staged
    reg.stage(tree_map(lambda x: x * 1.5, stack))
    assert reg.staged is not None and reg.version == 0 and reg.staged_ready()
    assert reg.flip_staged() and reg.version == 1 and reg.staged is None
    reg.stage({"w": torch.ones(2, 4)})  # collapsed: rejected at the flip
    assert not reg.flip_staged() and reg.version == 1 and reg.rejected == 1
    assert not reg.flip_staged()  # nothing staged -> no-op
    reg.stage(tree_map(lambda x: x * 2.0, stack))
    reg.stage(tree_map(lambda x: x * 3.0, stack))  # restaging replaces; last one wins
    assert reg.staged_total == 4 and reg.flip_staged()
    assert torch.equal(reg.members["w"], stack["w"] * 3.0)
    placed = []
    reg.stage(tree_map(lambda x: x * 4.0, stack))
    assert reg.flip_staged(place=lambda t: placed.append(t) or {"w": t["w"] + 0.0})
    assert len(placed) == 1 and torch.equal(reg.members["w"], stack["w"] * 4.0)
    with pytest.raises(ValueError):
        reg.stage({"w": torch.ones(3, 4)})  # K mismatch still refused


def test_scheduler_refresh_matches_chain_refresher_and_exhausts():
    """refresh() mirrors ChainRefresher: the same promotions, the same
    members bit for bit, the same exhaustion contract."""
    reg_a, sync = _toy(ChainRefresher)
    reg_b, sched = _toy(RefreshScheduler)
    for _ in range(2):
        assert sched.refresh() and sync.refresh()
        assert torch.equal(reg_a.members, reg_b.members)
    assert not sched.exhausted
    assert not sched.refresh() and sched.exhausted and not sync.refresh()
    assert not sched.pump(0)  # exhausted pump is a cheap no-op
    st = sched.stats()
    assert st["promotions"] == 2 and st["exhausted"] and st["device"] is None


def test_scheduler_drains_last_candidate_on_exhaustion():
    reg, sched = _toy(RefreshScheduler, total_steps=4, chunk_steps=4)
    flipped = [sched.pump(i) for i in range(4)]
    assert reg.version == 1 and sched.exhausted and any(flipped)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_scheduler_promotes_through_engine(smoke, paged):
    *_, cfg, model = smoke
    stack = _stack(smoke)
    reg = SnapshotRegistry(stack)
    sched = _model_refresher(RefreshScheduler, stack, reg)
    engine = ServeEngine(cfg, model, reg, num_slots=2, max_seq=24, paged=paged, block_size=8,
                         refresher=sched, refresh_every=2, device="cpu")
    reqs = synthetic_trace(8, vocab_size=cfg.vocab_size, prompt_lens=(5,), max_new=8,
                           mean_interarrival=1.5, seed=4)
    report = engine.run(reqs)
    assert reg.promoted >= 3, reg.stats()
    rf = report.refresher
    assert rf["promotions"] == reg.promoted
    assert rf["micro_chunks"] >= rf["proposals"] >= rf["promotions"]
    assert rf["per_refresh_wall_s"] >= 0.0 and rf["decode_steps_stalled"] == 0
    assert {"decode_steps_stalled", "stall_wall_s", "flips_deferred", "rejections",
            "pump_wall_s", "backpressure_ticks"} <= rf.keys()
    assert report.trace_counts["decode"] == report.decode_steps
    assert len(report.results) == 8


def test_bind_advances_nothing(smoke, monkeypatch):
    """The counterpart of the reference's warm-up pin: bind paces the
    scheduler and runs the gate once, read only; it advances no step,
    stages nothing and leaves the live params as they were.  The first
    pump builds no kernel library."""
    *_, cfg, model = smoke
    stack = _stack(smoke)
    reg = SnapshotRegistry(stack)
    sched = _model_refresher(RefreshScheduler, stack, reg, total_steps=1 << 20)
    live = tree_map(torch.clone, sched._params)
    ServeEngine(cfg, model, reg, num_slots=2, max_seq=16, refresher=sched, refresh_every=2,
                device="cpu")
    assert sched.micro_steps == 2 and sched._rate == 1.0  # paced to the cadence
    assert sched.steps_done == 0 and sched.micro_chunks == 0 and sched._stream is None
    assert reg.version == 0 and reg.staged is None and reg.staged_total == 0
    assert reg.members is stack
    for a, b in zip(tree_leaves(sched._params), tree_leaves(live)):
        assert torch.equal(a, b)
    from repro_torch.kernels import _build

    def no_build(*a, **k):
        raise AssertionError("a pump built a kernel library")

    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    sched.pump(0)
    assert sched.micro_chunks == 1 and sched.steps_done == 2


def test_promotion_invalidates_stale_prefix_entries(smoke):
    *_, cfg, model = smoke
    stack = _stack(smoke)
    reg = SnapshotRegistry(stack)
    sched = _model_refresher(RefreshScheduler, stack, reg)
    engine = ServeEngine(cfg, model, reg, num_slots=2, max_seq=24, paged=True, block_size=8,
                         refresher=sched, refresh_every=2, device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)  # exactly one full block
    reqs = [Request(rid=i, prompt=prompt.copy(), max_new=8, arrival_step=2 * i)
            for i in range(6)]
    report = engine.run(reqs)
    assert reg.promoted >= 1
    st = engine.pool.stats()
    assert st["prefix_invalidated"] >= 1
    assert all(k[0] == reg.version for k in engine.pool.alloc._prefix)
    engine.pool.alloc.check()
    assert len(report.results) == 6


@pytest.mark.parametrize("cls", [ChainRefresher, RefreshScheduler])
def test_engine_and_refresher_free_without_the_cycle_collector(smoke, cls):
    """Dropping a served engine frees its refresher and the chain carry at
    once: no reference cycle (engine <-> refresher, or refresher -> stream
    -> executor -> grad closure) keeps them alive until the collector runs."""
    import gc
    import weakref

    *_, cfg, model = smoke
    stack = _stack(smoke)
    gc.collect()
    gc.disable()
    try:
        reg = SnapshotRegistry(stack)
        ref = _model_refresher(cls, stack, reg, total_steps=16)
        eng = ServeEngine(cfg, model, reg, num_slots=2, max_seq=16, refresher=ref,
                          refresh_every=2, device="cpu")
        eng.run(synthetic_trace(2, vocab_size=cfg.vocab_size, prompt_lens=(5,), max_new=4,
                                seed=1))
        assert reg.version >= 1
        alive = [weakref.ref(x) for x in (eng, ref, reg)]
        del eng, ref, reg
        assert [w() is None for w in alive] == [True, True, True]
    finally:
        gc.enable()


@pytest.mark.parametrize("count", [0, 1, 2, 4])
def test_pick_device(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    card = SimpleNamespace(device=torch.device("cuda", 0))
    want = torch.device("cuda", count - 1) if count > 1 else None
    assert refresh_mod._pick_device(card, "auto") == want
    assert refresh_mod._pick_device(SimpleNamespace(device=torch.device("cpu")), "auto") is None
    assert refresh_mod._pick_device(card, None) is None
    assert refresh_mod._pick_device(card, "cuda:0") == torch.device("cuda", 0)


# --- executor stream (mirrors TestExecutorStream) ------------------------------


def _executor(chunk):
    return ChainExecutor(sampler=core.sgld(step_size=0.1), grad_fn=lambda t, _b: t,
                         chunk_steps=chunk, key_mode="fold")


def test_stream_matches_run():
    key = rng.key(0)
    ex1 = _executor(8)
    p1 = torch.ones(2, 3)
    final_run = ex1.run(p1, ex1.sampler.init(p1), num_steps=24, key=key)
    ex2 = _executor(8)
    p2 = torch.ones(2, 3)
    snaps = list(ex2.stream(p2, ex2.sampler.init(p2), num_steps=24, key=key))
    assert all(isinstance(s, ChunkSnapshot) and s.probe is None for s in snaps)
    assert [s.step for s in snaps] == [8, 16, 24]
    assert torch.equal(final_run.params, snaps[-1].params)
    assert [s.state.step for s in snaps] == [8, 16, 24]


def test_stream_micro_split_and_snapshot_every():
    """Micro-chunks of 2 with a proposal every 4th boundary equal the
    unsplit chunks of 8 bit for bit; only the proposal yields carry
    params."""
    key = rng.key(5)
    ex8 = _executor(8)
    whole = list(ex8.stream(torch.ones(2, 3), ex8.sampler.init(torch.ones(2, 3)),
                            num_steps=16, key=key))
    ex2 = _executor(2)
    split = list(ex2.stream(torch.ones(2, 3), ex2.sampler.init(torch.ones(2, 3)),
                            num_steps=16, key=key, snapshot_every=4))
    assert [s.step for s in split] == list(range(2, 17, 2))
    assert [s.params is not None for s in split] == [False, False, False, True] * 2
    for a, b in zip(whole, [s for s in split if s.params is not None]):
        assert torch.equal(a.params, b.params)


def test_stream_holds_no_snapshot_copy_once_dropped():
    """The generator keeps no reference to the copies it yielded: a
    dropped snapshot is freed while the stream is suspended (at full width
    the state copy alone is 19 GB)."""
    import weakref

    samp = core.ec_sghmc(step_size=1e-2, sync_every=2)
    ex = ChainExecutor(sampler=samp, grad_fn=lambda t, _b: t, chunk_steps=2, key_mode="fold")
    p = torch.zeros(2, 3)
    stream = ex.stream(p, samp.init(p), num_steps=8, key=rng.key(1))
    snap = next(stream)
    held = [weakref.ref(snap.params), weakref.ref(snap.state.momentum),
            weakref.ref(snap.state.center)]
    del snap
    assert [w() is None for w in held] == [True, True, True]
    assert next(stream).step == 4


def test_promoted_snapshot_survives_the_stream_advancing():
    """The port's carry is written in place: a snapshot (and so a promoted
    stack) is a copy that the next chunk does not touch; with
    ``copy_snapshots=False`` the yield IS the live carry and changes."""
    ex = _executor(4)
    p = torch.zeros(2, 3)
    stream = ex.stream(p, ex.sampler.init(p), num_steps=12, key=rng.key(1))
    first = next(stream)
    kept = first.params.clone()
    rest = list(stream)
    assert torch.equal(first.params, kept)
    vals = [float(torch.sum(s.params)) for s in [first] + rest]
    assert len(set(vals)) == 3
    ex_live = _executor(4)
    q = torch.zeros(2, 3)
    live_stream = ex_live.stream(q, ex_live.sampler.init(q), num_steps=8, key=rng.key(1),
                                 copy_snapshots=False)
    live = next(live_stream)
    before = live.params.clone()
    next(live_stream)
    assert live.params is q and not torch.equal(live.params, before)
    reg, sched = _toy(RefreshScheduler, total_steps=12)
    sched.refresh()
    promoted = reg.members
    held = promoted.clone()
    sched.refresh()
    sched.refresh()
    assert reg.version == 3 and torch.equal(promoted, held)


# --- the port's engine + refresher against the JAX engine + refresher ----------


def test_engine_with_live_refresh_matches_reference_engine(smoke):
    """Noiseless SGLD (temperature 0) pulls distinct members toward member
    0; with no noise the two trajectories need no shared RNG.  The engines
    serve the same trace through the same promotions."""
    jcfg, jmodel, np_stack, cfg, model = smoke
    kw = dict(chunk_steps=8, total_steps=32)
    trace_kw = dict(vocab_size=cfg.vocab_size, prompt_lens=(5, 8), max_new=6,
                    mean_interarrival=1.0, seed=9)

    jstack = jax.tree.map(jnp.asarray, np_stack)
    jcenter = jax.tree.map(lambda x: x[0], jstack)
    jreg = JSnapshotRegistry(jstack)
    jref = JChainRefresher(jreg, jcore.sgld(step_size=8e-5, temperature=0.0),
                           lambda p: jax.tree.map(lambda x, c: PREC * (x - c), p, jcenter),
                           jax.tree.map(lambda x: x + 0.0, jstack), key=jax.random.PRNGKey(3),
                           **kw)
    jrep = JServeEngine(jcfg, jmodel, jreg, num_slots=2, max_seq=16, record_logprobs=True,
                        refresher=jref, refresh_every=3).run(jsynthetic_trace(5, **trace_kw))

    stack = _interop.tree_from_numpy(np_stack)
    center = tree_map(lambda x: x[0].clone(), stack)
    reg = SnapshotRegistry(stack)
    ref = ChainRefresher(reg, core.sgld(step_size=8e-5, temperature=0.0),
                         lambda p: tree_map(lambda x, c: PREC * (x - c), p, center),
                         tree_map(lambda x: x + 0.0, stack), key=rng.key(3), **kw)
    rep = ServeEngine(cfg, model, reg, num_slots=2, max_seq=16, record_logprobs=True,
                      refresher=ref, refresh_every=3, device="cpu").run(
        synthetic_trace(5, **trace_kw))

    assert rep.decode_steps == jrep.decode_steps
    assert rep.registry["version"] == jrep.registry["version"] >= 2
    assert rep.registry["rejected"] == jrep.registry["rejected"]
    assert rep.refresher["steps_done"] == jrep.refresher["steps_done"]
    for a, b in zip(rep.results, jrep.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=LOGP_ATOL)
    for a, b in zip(tree_leaves(reg.members), jax.tree.leaves(jreg.members)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
