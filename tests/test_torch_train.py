"""The port's training stack against the reference's, on the CPU.

On the SMOKE qwen3 configuration (f32), with params drawn by the
reference's ``init_params`` and carried across with ``_interop``:

* ``train_nll``/``chunked_xent`` values and gradients against
  ``jax.value_and_grad`` (rtol 1e-5 on the value; grads atol 2e-5, the
  reference suite's model-level tolerance);
* ``make_train_step`` steps and a ``train.loop.run`` against the
  reference's, with the reference's noise handed in (params, momentum and
  center atol 2e-6 after the steps; the GEMMs sum in another order);
* ``_chunk_steps``, ``default_sampler`` and the synthetic token stream's
  law (zipf(1.1) unigram plus the 0.3 local-bigram mix).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro.core import tree_util as jtu
from repro.data.synthetic import synthetic_token_stream as jstream
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.train import loop as jloop
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import _interop, configs, core
from repro_torch.core.potential import value_and_grad
from repro_torch.data import chain_batches, synthetic_token_stream, token_batch
from repro_torch.launch import default_sampler
from repro_torch.models import get_model, layers, tree_leaves
from repro_torch.train import LoopConfig, loop, make_train_step

K = 2
N_DATA = 1000


@pytest.fixture(scope="module")
def shared():
    jcfg = jconfigs.get_config("qwen3-0.6b", smoke=True)
    jmodel = jget_model(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(4), K)
    jparams = jax.vmap(lambda k: jinit_params(jmodel.param_specs(jcfg), k))(keys)
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = _interop.config_from(jcfg)
    return jcfg, jmodel, np_params, cfg, get_model(cfg)


def _batch(seed, shape, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, size=shape[:-1] + (shape[-1] + 1,))
    toks = toks.astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _close(a, b, atol, rtol=0.0, what=""):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y), atol=atol, rtol=rtol,
                                   err_msg=what)


@pytest.mark.parametrize("masked", [False, True])
def test_train_nll_value_and_grads_match_reference(shared, masked):
    jcfg, jmodel, np_params, cfg, model = shared
    one = jax.tree.map(lambda x: x[0], np_params)
    batch = _batch(0, (2, 20))  # 20 positions over chunks of 16: one full, one ragged
    if masked:
        batch["mask"] = (np.arange(20)[None] % 3 != 0).astype(np.float32).repeat(2, 0)
    jv, jg = jax.value_and_grad(lambda p: jmodel.train_nll(jcfg, p, jax.tree.map(jnp.asarray, batch))[0])(
        jax.tree.map(jnp.asarray, one))
    tv, tg = value_and_grad(lambda p, b: model.train_nll(cfg, p, b)[0])(
        _interop.tree_from_numpy(one), _interop.tree_from_numpy(batch))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    _close(tg, jg, atol=2e-5, what="grads")
    _, count = model.train_nll(cfg, _interop.tree_from_numpy(one), _interop.tree_from_numpy(batch))
    assert float(count) == float(batch["mask"].sum() if masked else 40)


def test_chunked_xent_matches_reference(shared):
    jcfg, _, np_params, cfg, _ = shared
    table = {"table": np_params["embed"]["table"][1]}
    r = np.random.default_rng(1)
    x = r.normal(size=(3, 37, cfg.d_model)).astype(np.float32)
    labels = r.integers(0, cfg.vocab_size, size=(3, 37)).astype(np.int32)
    js, jc = jlayers.chunked_xent(jcfg, jax.tree.map(jnp.asarray, table), jnp.asarray(x),
                                  jnp.asarray(labels))
    ts, tc = layers.chunked_xent(cfg, _interop.tree_from_numpy(table), torch.from_numpy(x),
                                 torch.from_numpy(labels))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    assert float(tc) == float(jc) == 3 * 37


def _noise_fn(jstate, np_params, fused, key_of):
    """noise_fn(step) -> the reference's draws for that step's key."""
    jp = jax.tree.map(jnp.asarray, np_params)

    def fn(step):
        k_p, k_r = jax.random.split(key_of(step))
        noise_r = jtu.tree_random_normal(k_r, jstate.center_momentum, jnp.float32)
        if fused:
            leaves, treedef = jax.tree.flatten(jp)
            out = []
            for leaf, kk in zip(leaves, jax.random.split(k_p, len(leaves))):
                rows = -(-leaf.size // 8192) * 8
                bits = [np.asarray(jax.random.bits(k, (rows, 1024), jnp.uint32)).reshape(-1)[:leaf.size]
                        for k in jax.random.split(kk)]
                out.append(tuple(torch.from_numpy(b.view(np.int32).copy()) for b in bits))
            noise_p = jax.tree.unflatten(treedef, out)
        else:
            noise_p = _interop.tree_from_numpy(jax.tree.map(
                np.asarray, jtu.tree_random_normal(k_p, jstate.momentum, jnp.float32)))
        return {"p": noise_p, "r": _interop.tree_from_numpy(jax.tree.map(np.asarray, noise_r))}

    return fn


def _samplers(fused):
    kw = dict(step_size=1e-3, alpha=1.0, sync_every=2, fused=fused)
    return jcore.ec_sghmc(**kw), core.ec_sghmc(**kw)


def test_train_step_matches_reference(shared):
    """Unfused here; the loop test below runs the fused sampler."""
    fused = False
    jcfg, jmodel, np_params, cfg, model = shared
    jsamp, tsamp = _samplers(fused)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = _interop.tree_from_numpy(np_params)
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    key = jax.random.PRNGKey(9)
    key_of = lambda t: jax.random.fold_in(key, t)
    jstep = jax.jit(jmake_train_step(jcfg, jmodel, jsamp, N_DATA))
    tstep = make_train_step(cfg, model, tsamp, N_DATA, noise_fn=_noise_fn(jstate, np_params, fused, key_of))
    for t in range(2):
        batch = _batch(10 + t, (K, 2, 16))
        jparams, jstate, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray, batch), key_of(t))
        params, state, m = tstep(params, state, _interop.tree_from_numpy(batch), None)
        for k in ("potential", "nll_per_token"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    _close(params, jparams, atol=2e-6, what="params")
    for name in ("momentum", "center", "center_momentum", "center_stale", "mean_theta_stale"):
        _close(getattr(state, name), getattr(jstate, name), atol=2e-6, what=name)


def test_loop_run_matches_reference(shared):
    jcfg, jmodel, np_params, cfg, model = shared
    jsamp, tsamp = _samplers(True)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = _interop.tree_from_numpy(np_params)
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    lcfg = dict(num_steps=4, log_every=2, seed=3)
    batches = {t: _batch(20 + t, (K, 2, 16)) for t in range(4)}
    key_of = lambda t: jax.random.fold_in(jax.random.key(3), t)
    jstep = jmake_train_step(jcfg, jmodel, jsamp, N_DATA)
    tstep = make_train_step(cfg, model, tsamp, N_DATA, noise_fn=_noise_fn(jstate, np_params, True, key_of))
    jp, js, jh = jloop.run(jstep, jparams, jstate, lambda t: jax.tree.map(jnp.asarray, batches[t]),
                           jloop.LoopConfig(**lcfg), num_chains=K, sampler=jsamp)
    tp, ts, th = loop.run(tstep, params, state, lambda t: _interop.tree_from_numpy(batches[t]),
                          LoopConfig(**lcfg), num_chains=K, sampler=tsamp)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [2, 4]
    for a, b in zip(th, jh):
        for k in ("nll_per_token", "potential"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        # the reference's stats are jitted there, and XLA sums these f32
        # norms in another order: its own jitted and eager stats differ by
        # 2e-4 here, so the norms are held at 1e-3
        for k in ("chain_center_rms", "momentum_norm", "center_momentum_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, err_msg=k)
    _close(tp, jp, atol=2e-6, what="params")
    _close(ts.momentum, js.momentum, atol=2e-6, what="momentum")
    assert ts.step == int(js.step) == 4


def test_loop_production_noise_runs(shared):
    """Without a noise_fn the sampler draws its own noise (Philox bits in
    the fused update's plain version) from the loop's fold keys, and the
    run is a function of the seed."""
    _, _, np_params, cfg, model = shared
    outs = []
    for _ in range(2):
        samp = default_sampler(cfg, "qwen3-0.6b", K, sync_every=2, fused=True, step_size=1e-3)
        params = _interop.tree_from_numpy(np_params)
        step = make_train_step(cfg, model, samp, N_DATA)
        stream = synthetic_token_stream(cfg.vocab_size, seed=1, device="cpu")
        p, s, h = loop.run(step, params, samp.init(params),
                           lambda t: chain_batches(stream, t, K, 2, 16),
                           LoopConfig(num_steps=3, log_every=1), num_chains=K, sampler=samp)
        outs.append(p)
        assert len(h) == 3 and all(np.isfinite(v) for m in h for v in m.values())
        assert h[-1]["momentum_norm"] > 0 and h[-1]["chain_center_rms"] > 0
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(num_steps=100, log_every=10),
    dict(num_steps=100, log_every=10, ckpt_dir="x", ckpt_every=25),
    dict(num_steps=100, log_every=0),
    dict(num_steps=5000, log_every=0),
    dict(num_steps=100, log_every=6, preempt_at=9),
    dict(num_steps=100, log_every=2048 * 3, max_chunk=1024),
])
def test_chunk_steps_matches_reference(kw):
    assert loop._chunk_steps(LoopConfig(**kw)) == jloop._chunk_steps(jloop.LoopConfig(**kw))


def test_loop_checkpointing_waits(tmp_path):
    """``ckpt_dir`` no longer waits for ``train/checkpoint.py``: the loop
    writes a checkpoint at every ``ckpt_every`` boundary with the leaf keys
    and shapes the reference loop writes for the same run, and a rerun
    resumes from the last one as a no-op."""
    import json

    def port_step(samp):
        def step(params, state, batch, rng):
            upd, state = samp.update(params - 1.0, state, params, rng)
            return core.apply_updates(params, upd), state, {}
        return step

    def ref_step(samp):
        def step(params, state, batch, rng):
            upd, state = samp.update(params - 1.0, state, params, rng)
            return jcore.apply_updates(params, upd), state, {}
        return step

    cfg = dict(num_steps=4, ckpt_every=2, log_every=0)
    samp = core.ec_sghmc(step_size=1e-2, sync_every=2)
    p0 = torch.zeros(2, 8)
    p, s, _ = loop.run(port_step(samp), p0, samp.init(p0), lambda t: None,
                       LoopConfig(ckpt_dir=str(tmp_path / "port"), **cfg), num_chains=2)
    assert s.step == 4
    jsamp = jcore.ec_sghmc(step_size=1e-2, sync_every=2)
    j0 = jnp.zeros((2, 8))
    jloop.run(ref_step(jsamp), j0, jsamp.init(j0), lambda t: None,
              jloop.LoopConfig(ckpt_dir=str(tmp_path / "ref"), **cfg), num_chains=2)
    for name in ("step_00000002", "step_00000004"):
        mp = json.loads((tmp_path / "port" / name / "manifest.json").read_text())
        mr = json.loads((tmp_path / "ref" / name / "manifest.json").read_text())
        assert mp["shapes"] == mr["shapes"] and mp["step"] == mr["step"]
    p2, s2, _ = loop.run(port_step(samp), torch.zeros(2, 8), samp.init(torch.zeros(2, 8)),
                         lambda t: None, LoopConfig(ckpt_dir=str(tmp_path / "port"), **cfg),
                         num_chains=2)
    assert s2.step == 4 and torch.equal(p2, p)


def test_default_sampler():
    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    samp = default_sampler(cfg, "qwen3-0.6b", 4, fused=True)
    st = samp.init({"w": torch.zeros(4, 3)})
    assert st.momentum["w"].dtype == cfg.param_dtype
    assert isinstance(default_sampler(cfg, "qwen3-0.6b", 1).init({"w": torch.zeros(3)}),
                      core.SGHMCState)
    with pytest.raises(NotImplementedError):
        default_sampler(cfg, "qwen3-0.6b", 4, compress_sync=True)


def test_token_stream_law():
    V = 512
    sample = synthetic_token_stream(V, seed=0, device="cpu")
    a = sample(3, (64, 257))
    assert a.dtype == torch.int32 and a.shape == (64, 257)
    assert torch.equal(a, sample(3, (64, 257))) and not torch.equal(a, sample(4, (64, 257)))
    toks = torch.cat([sample(t, (64, 257)) for t in range(8)]).numpy()
    ref_toks = np.concatenate([np.asarray(jstream(V, seed=0)(t, (64, 257))) for t in range(8)])
    # the bigram rule (30% of tokens replaced by f(previous draw)) shows as
    # the share of tokens that follow f of their predecessor: ~0.21
    rule = lambda x: np.mean(x == (np.roll(x, 1, axis=-1) * 31 + 7) % V)
    assert abs(rule(toks) - rule(ref_toks)) < 0.01 and 0.15 < rule(toks) < 0.3
    # unigram frequencies of the 10 commonest ranks against the reference's
    # stream (zipf(1.1) plus the mix), within 5 binomial sd of the two draws
    f = np.bincount(toks.ravel(), minlength=V)[:10] / toks.size
    g = np.bincount(ref_toks.ravel(), minlength=V)[:10] / ref_toks.size
    sd = np.sqrt(2 * g * (1 - g) / toks.size)
    assert (np.abs(f - g) < 5 * sd).all(), (f, g)
    probs = np.arange(1, V + 1) ** -1.1
    assert f[0] > f[1] > f[2] and f[0] > 0.7 * probs[0] / probs.sum()
    b = token_batch(sample, 0, (2, 3), 8)
    assert b["tokens"].shape == b["labels"].shape == (2, 3, 8)
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
