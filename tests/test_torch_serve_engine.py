"""The port's ServeEngine against the reference's, on the CPU.

The same ``synthetic_trace``, the same member stack (drawn by
``repro.models.init_params`` and carried across with ``_interop``) and
greedy sampling go through ``repro.serve.engine.ServeEngine`` and
``repro_torch.serve.engine.ServeEngine`` over the grid dense/paged x fused
select on/off x BMA mode, with the slice's configuration (qwen3 SMOKE,
``use_flash_kernel=True``; the reference runs its Pallas kernels in
interpret mode).  Emitted tokens must be identical and the recorded
mixture log-prob rows close.  Within the port: paged == dense, fused ==
unfused at T > 0 for the same seed, and the engine == the sequential
per-member reference.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import synthetic_trace as jsynthetic_trace
from repro_torch import _interop
from repro_torch.models import get_model, tree_map
from repro_torch.serve.engine import ServeEngine, reference_bma_decode, synthetic_trace
from repro_torch.serve.sampling import SamplingParams

K = 2
MAX_SEQ = 16
# f32 SMOKE model: logp rows of the two frameworks differ by ~1e-6 (summation
# order of XLA's and torch's CPU matmuls); 2e-5 is the reference suite's
# model-level tolerance
LOGP_ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config("qwen3-0.6b", smoke=True).replace(use_flash_kernel=True)
    jmodel = jget_model(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    jmembers = jax.vmap(lambda kk: jinit_params(jmodel.param_specs(jcfg), kk))(keys)
    members = _interop.tree_from_numpy(jax.tree.map(np.asarray, jmembers))
    cfg = _interop.config_from(jcfg)
    return jcfg, jmodel, jmembers, cfg, get_model(cfg), members


def _trace(mod_trace):
    return mod_trace(3, vocab_size=512, prompt_lens=(5, 8), max_new=4,
                     mean_interarrival=1.0, seed=5)


def _port_run(setup, **kw):
    _, _, _, cfg, model, members = setup
    eng = ServeEngine(cfg, model, members, num_slots=2, max_seq=MAX_SEQ,
                      record_logprobs=True, device="cpu", **kw)
    return eng.run(_trace(synthetic_trace))


@pytest.mark.parametrize("bma", ["probs", "logprobs"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_reference_engine(setup, paged, fused, bma):
    jcfg, jmodel, jmembers, *_ = setup
    jrep = JServeEngine(jcfg, jmodel, jmembers, num_slots=2, max_seq=MAX_SEQ, bma=bma,
                        record_logprobs=True, paged=paged, block_size=4,
                        fused_select=fused).run(_trace(jsynthetic_trace))
    rep = _port_run(setup, bma=bma, paged=paged, block_size=4, fused_select=fused)
    assert rep.decode_steps == jrep.decode_steps
    assert len(rep.results) == len(jrep.results) == 3
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=LOGP_ATOL)
    if paged:
        jpool, pool = jrep.pool, rep.pool
        for key in ("blocks_high_water", "prefix_queries", "acquired", "released"):
            assert pool[key] == jpool[key], key


def test_paged_equals_dense_and_fused_equals_unfused_sampled(setup):
    sampling = SamplingParams(temperature=0.9, top_k=20)
    reps = {
        (paged, fused): _port_run(setup, paged=paged, block_size=4, fused_select=fused,
                                  sampling=sampling, seed=3)
        for paged in (False, True) for fused in (False, True)
    }
    base = reps[(False, False)]
    for rep in reps.values():
        for a, b in zip(rep.results, base.results):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)
    other_seed = _port_run(setup, paged=True, block_size=4, sampling=sampling, seed=4)
    assert any((a.tokens != b.tokens).any() for a, b in zip(other_seed.results, base.results))


def test_engine_matches_sequential_reference(setup):
    *_, cfg, model, members = setup
    prompt = np.arange(3, 9, dtype=np.int32)
    member_list = [tree_map(lambda a: a[k], members) for k in range(K)]
    ref_tok, ref_trace = reference_bma_decode(
        cfg, model, member_list, {"tokens": torch.tensor(prompt)[None]}, MAX_SEQ, 5)
    from repro_torch.serve.engine import Request

    for paged in (False, True):
        eng = ServeEngine(cfg, model, members, num_slots=2, max_seq=MAX_SEQ, paged=paged,
                          block_size=4, record_logprobs=True, device="cpu")
        rep = eng.run([Request(rid=0, prompt=prompt, max_new=5)])
        np.testing.assert_array_equal(rep.results[0].tokens, ref_tok[0].numpy())
        np.testing.assert_allclose(rep.results[0].logprobs, ref_trace[:, 0].numpy(), atol=1e-5)


def test_trace_counts_and_truncation(setup):
    rep = _port_run(setup, paged=True, block_size=4)
    assert rep.trace_counts["decode"] == rep.decode_steps
    assert rep.trace_counts["admit_len5"] + rep.trace_counts["admit_len8"] == 3
    cut = _port_run(setup, paged=True, block_size=4, fused_select=True)
    _, _, _, cfg, model, members = setup
    eng = ServeEngine(cfg, model, members, num_slots=2, max_seq=MAX_SEQ, device="cpu", paged=True,
                      block_size=4)
    short = eng.run(_trace(synthetic_trace), max_steps=1)
    assert any(r.truncated for r in short.results)
    assert eng.pool.free_slots == 2 and eng.pool.alloc.used_blocks == 0
    eng.pool.alloc.check()
    assert [r.num_tokens for r in cut.results] == [4, 4, 4]


def test_unported_options_raise(setup):
    *_, cfg, model, members = setup
    kw = dict(num_slots=2, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeEngine(cfg, model, members, mesh=object(), **kw)
    # the refresher is ported (tests/test_torch_refresh.py); what is left to
    # refuse is one that feeds another registry, as the reference refuses it
    with pytest.raises(ValueError, match="refresher must feed"):
        ServeEngine(cfg, model, members, refresher=SimpleNamespace(registry=None), **kw)
    # compressed parking is ported (the int8 codec): the pool parks through it
    assert ServeEngine(cfg, model, members, compress_parked=True, **kw).pool.compressed_parking


def test_engine_defaults_to_cuda(setup):
    """Members on the CPU and no device argument: the engine is on CUDA
    and refuses to move them."""
    *_, cfg, model, members = setup
    with pytest.raises(ValueError, match="engine runs on cuda"):
        ServeEngine(cfg, model, members, num_slots=2, max_seq=MAX_SEQ)


@pytest.mark.parametrize("paged", [False, True])
def test_park_restore_round_trip(setup, paged):
    *_, cfg, model, members = setup
    eng = ServeEngine(cfg, model, members, num_slots=3, max_seq=MAX_SEQ, device="cpu",
                      paged=paged, block_size=4, prefix_sharing=False)
    pool = eng.pool
    prompt = np.arange(1, 8, dtype=np.int32)
    from repro_torch.serve.engine import Request

    slot = pool.acquire()
    table = pool.admit_blocks(slot, prompt, 4) if paged else None
    eng._admit(Request(rid=0, prompt=prompt, max_new=4), slot, table)
    before = [leaf.clone() for leaf in _slot_leaves(pool, slot, paged)]
    parked = pool.park(slot, release=False)  # the copy must land elsewhere
    new_slot = pool.acquire()
    assert pool.restore(parked, new_slot) == new_slot != slot
    after = _slot_leaves(pool, new_slot, paged)
    for a, b in zip(before, after):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if paged:
        assert not set(pool.alloc.tables[slot]) - {0} & set(pool.alloc.tables[new_slot])
        pool.alloc.check()


def _slot_leaves(pool, slot, paged):
    if paged:
        row = pool.alloc.tables[slot]
        idx = torch.tensor(row[row != 0], dtype=torch.long)
        return [pool.caches["layers"]["0"]["attn"][kk][:, :, idx] for kk in ("k", "v")]
    return [pool.caches["layers"]["0"]["attn"][kk][:, :, slot] for kk in ("k", "v")] + [
        pool.caches["t"][:, slot]]


def test_eos_ends_requests_like_mask_after_eos(setup):
    """With ``eos_id`` set to a token a request emits, that request ends at
    its first EOS and every request's tokens equal the EOS-free run's,
    masked after the first EOS and cut there."""
    base = _port_run(setup, paged=True, block_size=4)
    eos = int(base.results[0].tokens[1])
    rep = _port_run(setup, paged=True, block_size=4, eos_id=eos)
    assert rep.results[0].hit_eos
    for a, b in zip(rep.results, base.results):
        hits = np.nonzero(b.tokens == eos)[0]
        want = b.tokens[: hits[0] + 1] if hits.size else b.tokens
        np.testing.assert_array_equal(a.tokens, want)


def test_registry_spread_gate_matches_reference(setup):
    from repro.diagnostics import ensemble_spread_device as jspread
    from repro_torch.diagnostics import ensemble_spread_device
    from repro_torch.serve.engine import SnapshotRegistry

    _, _, jmembers, _, _, members = setup
    got = ensemble_spread_device(members)
    want = jspread(jmembers)
    for key in ("chain_spread", "mean_param_norm", "rel_spread"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)
    reg = SnapshotRegistry(members, validate=True)
    collapsed = tree_map(lambda a: a[:1].expand_as(a).clone(), members)
    assert not reg.propose(collapsed) and reg.rejected == 1 and reg.version == 0
    assert reg.propose(tree_map(lambda a: a.flip(0), members)) and reg.version == 1
    with pytest.raises(ValueError, match="collapsed"):
        SnapshotRegistry(collapsed, validate=True)


def _float_paths(tree, path=()):
    """(path, leaf) of every float leaf of a nested dict of caches."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _float_paths(v, path + (k,))
        elif v.is_floating_point():
            yield path + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_compressed_park_restore_matches_reference_pool(setup, paged):
    """The int8 parking of ``tests/test_serve_engine.py:684-725`` (dense)
    and ``tests/test_paged_cache.py:356-367`` (paged) against the
    reference's pool: the same random slot contents park and restore
    through both codecs to within 0.05 of the original and of each other,
    and a second park/restore lands on the same quantization points, bit
    for bit."""
    from repro.serve.engine.cache_pool import CachePool as JCachePool
    from repro.serve.engine.cache_pool import PagedCachePool as JPagedCachePool
    from repro_torch.serve.engine.cache_pool import CachePool, PagedCachePool

    jcfg, jmodel, _, cfg, model, _ = setup
    kw = dict(num_members=2, num_slots=2, max_seq=32, compress_parked=True)
    if paged:
        kw["block_size"] = 8
        jpool, pool = JPagedCachePool(jcfg, jmodel, **kw), PagedCachePool(cfg, model, device="cpu",
                                                                          **kw)
    else:
        jpool, pool = JCachePool(jcfg, jmodel, **kw), CachePool(cfg, model, device="cpu", **kw)
    slot, jslot = pool.acquire(), jpool.acquire()
    assert slot == jslot
    if paged:
        prompt = np.arange(9, dtype=np.int32)
        pool.admit_blocks(slot, prompt, 4)
        jpool.admit_blocks(jslot, prompt, 4)
    r = np.random.default_rng(3)
    jcaches = jpool.caches
    for path, leaf in _float_paths(pool.caches):
        vals = r.normal(size=leaf.shape).astype(np.float32)
        leaf.copy_(torch.from_numpy(vals))
        jleaf = _at(jcaches, path)
        if not paged:  # the reference pools batch-1 caches: (K, slot, ..., 1, ...)
            ax = 1 + (path[0] == "layers")
            vals = np.expand_dims(np.moveaxis(vals, ax, 1), ax + 1)
        assert jleaf.shape == vals.shape, path
        jcaches = jax.tree_util.tree_map(lambda x: x, jcaches)
        _at(jcaches, path[:-1])[path[-1]] = jax.numpy.asarray(vals, jleaf.dtype)
    jpool.caches = jcaches

    def port_slot(s):
        if paged:
            row = pool.alloc.tables[s]
            idx = torch.tensor(row[row != 0], dtype=torch.long)
            return [leaf.index_select(leaf.ndim - 4, idx).clone()
                    for _, leaf in _float_paths(pool.caches)]
        return [leaf.select(1 + (p[0] == "layers"), s).clone()
                for p, leaf in _float_paths(pool.caches)]

    def ref_slot(s):
        if paged:
            row = jpool.tables[s]
            idx = np.asarray(row[row != 0])
            return [np.take(np.asarray(_at(jpool.caches, p)), idx, axis=leaf.ndim - 4)
                    for p, leaf in _float_paths(pool.caches)]
        return [np.asarray(_at(jpool.caches, p))[:, s] for p, _ in _float_paths(pool.caches)]

    orig = port_slot(slot)
    restore = (lambda pl, pk: pl.restore(pk, max_new=4)) if paged else (lambda pl, pk: pl.restore(pk))
    parked = pool.park(slot)
    assert parked.compressed and all(isinstance(x, dict) for x in parked.leaves)
    slot = restore(pool, parked)
    jslot = restore(jpool, jpool.park(jslot))
    once, jonce = port_slot(slot), ref_slot(jslot)
    for o, a, b in zip(orig, once, jonce):
        np.testing.assert_allclose(a.numpy(), o.numpy(), atol=0.05)
        np.testing.assert_allclose(a.numpy().reshape(-1), b.reshape(-1), atol=0.05)
    slot = restore(pool, pool.park(slot))
    for a, b in zip(once, port_slot(slot)):
        assert torch.equal(a, b)
