"""The port's hybrid family (recurrentgemma-2b: RG-LRU blocks between
local-attention blocks) against the reference's, on the CPU.

The SMOKE configuration on params drawn by ``repro.models.init_params`` and
carried across with ``_interop``: the spec tree, the RG-LRU block, prefill
logits and every cache leaf (RG-LRU h and conv, the windowed ring buffer),
dense ``decode_step`` logits, ``train_nll`` and the whole dense
``ServeEngine`` must match the reference (atol 2e-5, the reference suite's
model-level tolerance; tokens identical).  The RG-LRU scan goes through
``kernels.ops.rglru_scan`` (its plain version here) and attention through
the flash wrapper when ``use_flash_kernel`` is on (head_dim 32, padded to
64).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.models import recurrent as jR
from repro.models import transformer as jT
from repro.models.common import num_params as jnum_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import synthetic_trace as jsynthetic_trace
from repro_torch import _interop, configs
from repro_torch.kernels import launches
from repro_torch.models import get_model, init_params, num_params, tree_leaves, tree_map
from repro_torch.models import recurrent as R
from repro_torch.serve.engine import ServeEngine, synthetic_trace

ARCH = "recurrentgemma-2b"
ATOL = 2e-5
# Cache leaves past the attention layer also get a relative tolerance: the
# reference's fan-in init gives wk a std of 1 (fan-in Hkv = 1), so k reaches
# |28| and scores reach the hundreds, and the two frameworks' f32 sums
# (~5e-7 relative up to there) come out of the softmax ~5e-6 relative, on
# remainder-layer leaves of magnitude ~4 (measured 1.5e-5 to 2.2e-5 absolute)
CACHE_RTOL = 1e-5
MAX_SEQ = 24  # the windowed layer's ring buffer holds min(window 8, 24) = 8 slots


@pytest.fixture(scope="module")
def shared():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    jmodel = jget_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(jcfg), jax.random.PRNGKey(1))
    params = _interop.tree_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, _interop.config_from(jcfg), params


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_close(tree, jtree):
    leaves, jleaves = tree_leaves(tree), jax.tree.leaves(jtree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), rtol=CACHE_RTOL, atol=ATOL)


def test_config_and_specs_match_reference():
    for smoke in (True, False):
        jcfg = jconfigs.get_config(ARCH, smoke=smoke)
        cfg = configs.get_config(ARCH, smoke=smoke)
        assert cfg == _interop.config_from(jcfg)
        assert num_params(cfg) == jnum_params(jcfg)
        jspecs = jax.tree_util.tree_flatten_with_path(
            jget_model(jcfg).param_specs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
        specs = tree_leaves(get_model(cfg).param_specs(cfg))
        assert len(specs) == len(jspecs)
        assert smoke or len(specs) == 71
        for s, (path, js) in zip(specs, jspecs):
            assert (s.shape, s.axes, s.init) == (js.shape, js.axes, js.init), path
            assert s.dtype == _interop.torch_dtype(js.dtype), path
    assert configs.EC_CHAINS[ARCH] == jconfigs.EC_CHAINS[ARCH]


def test_lambda_init_gives_decay_in_range():
    """Λ from the port's generator maps to a = exp(-8·softplus(Λ)) in
    [0.9, 0.999], as the reference's init promises."""
    cfg = configs.get_config(ARCH, smoke=True).replace(rnn_width=4096)
    p = init_params(R.rglru_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(p["lam"]))
    assert p["lam"].dtype == torch.float32 and p["lam"].shape == (4096,)
    assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    assert float(a.max() - a.min()) > 0.09  # spread over the range, not a constant


def _layer0_mix(params, jparams):
    return (tree_map(lambda a: a[0], params["layers"]["0"]["mix"]),
            jax.tree.map(lambda a: a[0], jparams["layers"]["0"]["mix"]))


def test_rglru_block_and_state_match_reference(shared):
    jcfg, _, jparams, cfg, params = shared
    p, jp = _layer0_mix(params, jparams)
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    out, state = R.rglru_block(cfg, p, torch.tensor(x))
    np.testing.assert_allclose(_np(out), _np(jR.rglru_block(jcfg, jp, jnp.asarray(x))), atol=ATOL)
    jout, jstate = jT._rglru_with_state(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL)
    for key in ("h", "conv"):
        assert state[key].dtype == _interop.torch_dtype(jstate[key].dtype)
        np.testing.assert_allclose(_np(state[key]), _np(jstate[key]), atol=ATOL)
    assert launches["rglru_scan"] == 0


def test_rglru_decode_matches_reference(shared):
    jcfg, _, jparams, cfg, params = shared
    p, jp = _layer0_mix(params, jparams)
    rng = np.random.default_rng(4)
    state = {"h": torch.tensor(rng.standard_normal((3, 64)).astype(np.float32)),
             "conv": torch.tensor(rng.standard_normal((3, 3, 64)).astype(np.float32))}
    jstate = {k: jnp.asarray(v.numpy().copy()) for k, v in state.items()}  # decode writes state
    for step in range(3):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        out, state = R.rglru_decode(cfg, p, torch.tensor(x), state)
        jout, jstate = jR.rglru_decode(jcfg, jp, jnp.asarray(x), jstate)
        np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL)
        for key in ("h", "conv"):
            np.testing.assert_allclose(_np(state[key]), _np(jstate[key]), atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_and_dense_decode_match_reference(shared, flash):
    """A 16-token prompt over the window of 8: the ring buffer is rolled,
    h and conv come out of the one scan; then three decode steps."""
    jcfg, jmodel, jparams, cfg, params = shared
    jcfg, cfg = jcfg.replace(use_flash_kernel=flash), cfg.replace(use_flash_kernel=flash)
    model = get_model(cfg)
    prompt = _tokens(0, (2, 16))
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)}, MAX_SEQ)
    tl, cache = model.prefill(cfg, params, {"tokens": torch.tensor(prompt)}, MAX_SEQ)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    assert cache["layers"]["2"]["attn"]["k"].shape == (1, 2, 8, 1, 32)
    assert cache["rem"]["1"]["mix"]["conv"].shape == (2, 3, 64)
    _assert_trees_close(cache, jcache)
    for i in range(3):
        nt = _tokens(10 + i, (2, 1))
        jl, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(nt))
        tl, cache = model.decode_step(cfg, params, cache, torch.tensor(nt))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    _assert_trees_close(cache, jcache)


def test_decode_continues_prefill(shared):
    """State handoff from prefill to decode: decoding tokens 8..11 after an
    8-token prefill gives the last-position logits of prefilling 9..12
    tokens (the reference's test_recurrent_decode_matches_prefill)."""
    *_, cfg, params = shared
    model = get_model(cfg)
    toks = torch.tensor(_tokens(9, (1, 12)))

    def last_logits(n):
        return model.prefill(cfg, params, {"tokens": toks[:, :n]}, 16)[0][0, 0]

    lg, cache = model.prefill(cfg, params, {"tokens": toks[:, :8]}, 16)
    for t in range(8, 12):
        lg, cache = model.decode_step(cfg, params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(_np(lg[0, 0]), _np(last_logits(t + 1)), rtol=5e-4, atol=5e-4)


def test_train_nll_matches_reference(shared):
    jcfg, jmodel, jparams, cfg, params = shared
    toks = _tokens(5, (2, 24))
    labels = _tokens(6, (2, 24))
    mask = (np.arange(24)[None] < np.asarray([[24], [17]])).astype(np.float32)
    jn, jc = jmodel.train_nll(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                              "labels": jnp.asarray(labels),
                                              "mask": jnp.asarray(mask)})
    n, c = get_model(cfg).train_nll(cfg, params, {"tokens": torch.tensor(toks),
                                                  "labels": torch.tensor(labels),
                                                  "mask": torch.tensor(mask)})
    assert float(c) == float(jc) == 41.0
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6, atol=ATOL)


K = 2


@pytest.fixture(scope="module")
def engine_setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True).replace(use_flash_kernel=True)
    jmodel = jget_model(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    jmembers = jax.vmap(lambda kk: jinit_params(jmodel.param_specs(jcfg), kk))(keys)
    members = _interop.tree_from_numpy(jax.tree.map(np.asarray, jmembers))
    cfg = _interop.config_from(jcfg)
    return jcfg, jmodel, jmembers, cfg, get_model(cfg), members


def _trace(mod_trace):
    # prompts of 5 and 12 tokens: the 12-token one wraps the window of 8
    return mod_trace(4, vocab_size=512, prompt_lens=(5, 12), max_new=4,
                     mean_interarrival=1.0, seed=5)


@pytest.mark.parametrize("bma,fused", [("probs", False), ("logprobs", True)])
def test_dense_engine_matches_reference_engine(engine_setup, bma, fused):
    jcfg, jmodel, jmembers, cfg, model, members = engine_setup
    jrep = JServeEngine(jcfg, jmodel, jmembers, num_slots=2, max_seq=MAX_SEQ, bma=bma,
                        record_logprobs=True, fused_select=fused).run(_trace(jsynthetic_trace))
    rep = ServeEngine(cfg, model, members, num_slots=2, max_seq=MAX_SEQ, bma=bma,
                      record_logprobs=True, fused_select=fused, device="cpu").run(
                          _trace(synthetic_trace))
    assert rep.decode_steps == jrep.decode_steps
    assert len(rep.results) == len(jrep.results) == 4
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=ATOL)
    for key in ("acquired", "released", "high_water"):
        assert rep.pool[key] == jrep.pool[key], key


def test_park_restore_carries_the_recurrent_state(engine_setup):
    *_, cfg, model, members = engine_setup
    from repro_torch.serve.engine import Request

    eng = ServeEngine(cfg, model, members, num_slots=3, max_seq=MAX_SEQ, device="cpu")
    pool = eng.pool
    slot = pool.acquire()
    eng._admit(Request(rid=0, prompt=np.arange(1, 11, dtype=np.int32), max_new=4), slot)
    leaves = lambda s: [pool.caches["layers"]["0"]["mix"][k][:, :, s] for k in ("h", "conv")] + [
        pool.caches["rem"]["1"]["mix"][k][:, s] for k in ("h", "conv")]
    before = [x.clone() for x in leaves(slot)]
    assert all(float(x.abs().max()) > 0 for x in before)
    parked = pool.park(slot, release=False)
    new_slot = pool.acquire()
    assert pool.restore(parked, new_slot) == new_slot != slot
    for a, b in zip(before, leaves(new_slot)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_paged_engine_is_refused_like_the_reference(engine_setup):
    jcfg, jmodel, jmembers, cfg, model, members = engine_setup
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jcfg, jmodel, jmembers, num_slots=2, max_seq=MAX_SEQ, paged=True)
    with pytest.raises(ValueError) as err:
        ServeEngine(cfg, model, members, num_slots=2, max_seq=MAX_SEQ, paged=True, device="cpu")
    assert str(err.value) == str(jerr.value) == \
        "paged decode supports attn-only models, got 'rglru'"


def test_xlstm_kinds_raise():
    """The xLSTM kinds build on the dense surface; the paged surface refuses
    them, and a kind no family has raises, with the
    reference's messages."""
    cfg = configs.get_config(ARCH, smoke=True)  # num_heads * head_dim == d_model
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    for kind in ("mlstm", "slstm", "conv"):
        xl = cfg.replace(pattern=(type(cfg.pattern[0])(kind),))
        jxl = jcfg.replace(pattern=(type(jcfg.pattern[0])(kind),))
        if kind == "conv":
            with pytest.raises(ValueError, match="conv"):
                get_model(xl).param_specs(xl)
            with pytest.raises(ValueError, match="conv"):
                jget_model(jxl).param_specs(jxl)
            continue
        assert num_params(xl) == jnum_params(jxl)
        with pytest.raises(ValueError) as err:
            get_model(xl).paged.check_support(xl)
        with pytest.raises(ValueError) as jerr:
            jget_model(jxl).paged.check_support(jxl)
        assert str(err.value) == str(jerr.value) == \
            f"paged decode supports attn-only models, got {kind!r}"
    assert configs.get_config("xlstm-350m").family == "ssm"
