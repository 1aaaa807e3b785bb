"""Shared checks of the port's language models against the reference's, on
the CPU (used by ``test_torch_dense_configs.py``, ``test_torch_moe.py``,
``test_torch_arch_smoke.py`` and the xlstm, vlm and encdec files).

Params are drawn by ``repro.models.init_params`` and carried across with
``_interop``; each check runs the reference and the port on the same
inputs.  The model-level tolerance is the reference suite's, 2e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.models.common import num_params as jnum_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import synthetic_trace as jsynthetic_trace
from repro_torch import _interop, configs
from repro_torch.models import get_model, num_params, tree_leaves
from repro_torch.serve.engine import ServeEngine, synthetic_trace

ATOL = 2e-5
# Some SMOKE models amplify f32 rounding: the reference's fan-in init gives
# wk a std of 1/sqrt(Hkv), so without qk-norm (h2o-danube, gemma2, grok)
# the scores are large, and gemma2's sandwich norms rescale small
# attention outputs.  Against an f64 run of the port on the same weights,
# the reference itself is off by up to 1.2e-5 on h2o-danube's decode
# logits (|l| <= 3.6) and 1.9e-4 on gemma2's cache leaves (|x| <= 21), and
# the port by as much; on grok's embedding gradient (|g| <= 3.7) the port
# is 1.5e-4 off and the reference 3.0e-5, and 1.2e-4 with the attention
# softcap off.  qwen2-vl (no qk-norm either): the reference is 6.8e-5 off
# on the third decode step's logits (|l| <= 3.1), 3.0e-4 on cache leaves
# (|x| <= 22) and 2.4e-3 on the embedding gradient (|g| <= 52), the port
# 6.8e-5, 1.8e-4 and 1.2e-3; xlstm: the reference 2.9e-5 on the sLSTM
# state (|x| <= 15) and 2.6e-5 on the embedding gradient (|g| <= 1.5).  So
# beyond ATOL a difference may reach SCALE_RTOL of the compared tensor's
# largest magnitude (measured: 4.2e-5 at most, there).
SCALE_RTOL = 5e-5


def assert_close(got, want, atol=ATOL, scale_rtol=SCALE_RTOL, what=""):
    """max|got - want| <= atol + scale_rtol * max|want|."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if want.size else 0.0
    bound = atol + scale_rtol * float(np.abs(want).max() if want.size else 0.0)
    assert err <= bound, f"{what}: max|got - want| = {err:.3e} > {bound:.3e}"


def setup(arch, seed=1, **replace):
    """(jcfg, jmodel, jparams, cfg, params) of ``arch``'s SMOKE config."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**replace)
    jmodel = jget_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(jcfg), jax.random.PRNGKey(seed))
    params = _interop.tree_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, _interop.config_from(jcfg), params


def member_setup(arch, K, seed=7, **replace):
    """(jcfg, jmodel, jmembers, cfg, model, members): K stacked members."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**replace)
    jmodel = jget_model(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    jmembers = jax.vmap(lambda kk: jinit_params(jmodel.param_specs(jcfg), kk))(keys)
    members = _interop.tree_from_numpy(jax.tree.map(np.asarray, jmembers))
    cfg = _interop.config_from(jcfg)
    return jcfg, jmodel, jmembers, cfg, get_model(cfg), members


def tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_trees_close(tree, jtree):
    leaves, jleaves = tree_leaves(tree), jax.tree.leaves(jtree)
    assert len(leaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        assert_close(a, b, what=f"leaf {i}")


def check_config_and_specs(arch):
    """Full and SMOKE configs equal the reference's, with the same
    parameter count and spec tree (shape, axes, init, dtype)."""
    for smoke in (True, False):
        jcfg = jconfigs.get_config(arch, smoke=smoke)
        cfg = configs.get_config(arch, smoke=smoke)
        assert cfg == _interop.config_from(jcfg)
        assert num_params(cfg) == jnum_params(jcfg)
        jspecs = jax.tree_util.tree_flatten_with_path(
            jget_model(jcfg).param_specs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
        specs = tree_leaves(get_model(cfg).param_specs(cfg))
        assert len(specs) == len(jspecs)
        for s, (path, js) in zip(specs, jspecs):
            assert (s.shape, s.axes, s.init) == (js.shape, js.axes, js.init), path
            assert s.dtype == _interop.torch_dtype(js.dtype), path
    assert configs.EC_CHAINS[arch] == jconfigs.EC_CHAINS[arch]


def check_prefill_and_decode(s, prompt, max_seq, steps=3):
    """Prefill logits and every dense cache leaf, then ``steps`` decode
    steps' logits; returns the port's last logits."""
    jcfg, jmodel, jparams, cfg, params = s
    model = get_model(cfg)
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)}, max_seq)
    tl, cache = model.prefill(cfg, params, {"tokens": torch.tensor(prompt)}, max_seq)
    assert_close(tl, jl, what="prefill logits")
    assert_trees_close(cache, jcache)
    B = prompt.shape[0]
    for i in range(steps):
        nt = tokens(10 + i, (B, 1))
        jl, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(nt))
        tl, cache = model.decode_step(cfg, params, cache, torch.tensor(nt))
        assert_close(tl, jl, what=f"decode {i} logits")
    assert_trees_close(cache, jcache)
    return tl


def check_paged_decode(s, plen=11, bs=8, steps=3):
    """A prompt of ``plen`` written into pages along a scattered table row,
    then ``steps`` paged decode steps: pools and logits."""
    jcfg, jmodel, jparams, cfg, params = s
    model = get_model(cfg)
    prompt = tokens(1, (1, plen))
    tab = np.asarray([[2, 4, 1]], np.int32)
    max_seq = 3 * bs
    _, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)}, max_seq)
    _, cache = model.prefill(cfg, params, {"tokens": torch.tensor(prompt)}, max_seq)
    jpools = jmodel.paged.make_pools(jcfg, 6, bs, jcfg.compute_dtype)
    jpools = jmodel.paged.prefill_write(jcfg, jpools, jcache, jnp.asarray(tab[0]), bs)
    pools = model.paged.make_pools(cfg, 6, bs, cfg.compute_dtype, "cpu")
    pools = model.paged.prefill_write(cfg, pools, cache, torch.tensor(tab[0]), bs)
    assert_trees_close(pools, jpools)
    for step in range(steps):
        ctx = np.asarray([plen + step], np.int32)
        wb = tab[:, (plen + step) // bs]
        nt = tokens(20 + step, (1, 1))
        jl, jpools = jmodel.paged.decode_step(jcfg, jparams, jpools, jnp.asarray(nt),
                                              jnp.asarray(tab), jnp.asarray(ctx), jnp.asarray(wb))
        tl, pools = model.paged.decode_step(cfg, params, pools, torch.tensor(nt),
                                            torch.tensor(tab), torch.tensor(ctx), torch.tensor(wb))
        assert_close(tl, jl, what=f"paged decode {step} logits")


def nll_batch(S=24, seed=5):
    toks = tokens(seed, (2, S))
    labels = tokens(seed + 1, (2, S))
    mask = (np.arange(S)[None] < np.asarray([[S], [S - 7]])).astype(np.float32)
    return {"tokens": toks, "labels": labels, "mask": mask}


def check_train_nll(s, S=24):
    jcfg, jmodel, jparams, cfg, params = s
    b = nll_batch(S)
    jn, jc = jmodel.train_nll(jcfg, jparams, {k: jnp.asarray(v) for k, v in b.items()})
    n, c = get_model(cfg).train_nll(cfg, params, {k: torch.tensor(v) for k, v in b.items()})
    assert float(c) == float(jc) == 2 * S - 7
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6, atol=ATOL)
    return float(n)


def check_grads(s, batch, scale_rtol=SCALE_RTOL, jit=False):
    """``train_nll``'s gradient of the mean NLL on ``batch`` (numpy arrays),
    leaf by leaf: torch autograd against ``jax.grad`` (compiled first with
    ``jit``, which is quicker where the eager reference is slow)."""
    from repro_torch.models.common import tree_unflatten

    jcfg, jmodel, jparams, cfg, params = s

    def jloss(p):
        total, count = jmodel.train_nll(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})
        return total / count

    jgrad = jax.jit(jax.grad(jloss)) if jit else jax.grad(jloss)
    jgrads = jax.tree.leaves(jgrad(jparams))
    leaves = [a.clone().requires_grad_(True) for a in tree_leaves(params)]
    total, count = get_model(cfg).train_nll(cfg, tree_unflatten(params, leaves),
                                            {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total / count, leaves)
    assert len(grads) == len(jgrads)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert_close(g, jg, scale_rtol=scale_rtol, what=f"grad leaf {i}")


def engine_trace(mod_trace, n=4, prompt_lens=(5, 12), max_new=4):
    return mod_trace(n, vocab_size=512, prompt_lens=prompt_lens, max_new=max_new,
                     mean_interarrival=1.0, seed=5)


def check_engine(ms, *, paged, bma="logprobs", fused=True, max_seq=24, block_size=4,
                 prompt_lens=(5, 12)):
    """The port's ServeEngine against the reference's on one trace: the
    same tokens, log-prob rows at 2e-5 and the same pool counters."""
    jcfg, jmodel, jmembers, cfg, model, members = ms
    kw = dict(num_slots=2, max_seq=max_seq, bma=bma, record_logprobs=True, fused_select=fused,
              paged=paged, block_size=block_size)
    jrep = JServeEngine(jcfg, jmodel, jmembers, **kw).run(
        engine_trace(jsynthetic_trace, prompt_lens=prompt_lens))
    rep = ServeEngine(cfg, model, members, device="cpu", **kw).run(
        engine_trace(synthetic_trace, prompt_lens=prompt_lens))
    assert rep.decode_steps == jrep.decode_steps
    assert len(rep.results) == len(jrep.results) == 4
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert_close(a.logprobs, b.logprobs, what=f"request {a.rid} logprobs")
    keys = ("blocks_high_water", "prefix_queries", "acquired", "released") if paged else \
        ("acquired", "released", "high_water")
    for key in keys:
        assert rep.pool[key] == jrep.pool[key], key
    return rep
