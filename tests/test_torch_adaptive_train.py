"""SMOKE training with the port's scale-adapted EC-SGHMC against the
reference's, on the CPU.

qwen3's SMOKE configuration (f32), params from the reference's
``init_params``, K = 2 chains, 4 steps of ``train.loop.run`` with
``scale_adapted_ec_sghmc(fused=True)`` across the burn-in freeze
(burnin 2), with the reference's noise handed in (the fused kernel's
per-leaf bits and the center's normals).  Params, momentum and center at
atol 2e-6 after the run (the GEMMs sum in another order), and V̂ at rtol
1e-4: it is the EMA of g², and the gradients (scaled by n_data / tokens)
inherit the GEMMs' order differences, which reach 4.5e-5 relative in V̂
here; the logged nll and potential at rtol 1e-5, the sampler's norms at
1e-3 (the reference's jitted stats sum them in another order, as in
``tests/test_torch_train.py``) and ``precond_v_mean`` at 1e-5.  A run
without handed-in noise (Philox bits in the plain version) is a function
of the seed.
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
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.train import loop as jloop
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import _interop, core
from repro_torch.data import chain_batches, synthetic_token_stream
from repro_torch.kernels import launches
from repro_torch.models import get_model, tree_leaves
from repro_torch.train import LoopConfig, loop, make_train_step

K = 2
N_DATA = 1000
SAMPLER = dict(step_size=1e-3, alpha=1.0, friction=1.0, center_friction=1.0, sync_every=2,
               burnin=2, decay=0.9, fused=True)


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


def _noise_fn(jstate, np_params, key_of):
    """noise_fn(step) -> the reference's draws for that step's key: the
    preconditioned kernel's per-leaf bits and the center's normals."""
    jp = jax.tree.map(jnp.asarray, np_params)

    def fn(step):
        k_p, k_r = jax.random.split(key_of(step))
        leaves, treedef = jax.tree.flatten(jp)
        out = []
        for leaf, kk in zip(leaves, jax.random.split(k_p, len(leaves))):
            rows = -(-leaf.size // 8192) * 8
            bits = [np.asarray(jax.random.bits(k, (rows, 1024), jnp.uint32)).reshape(-1)[:leaf.size]
                    for k in jax.random.split(kk)]
            out.append(tuple(torch.from_numpy(b.view(np.int32).copy()) for b in bits))
        noise_r = jtu.tree_random_normal(k_r, jstate.center_momentum, jnp.float32)
        return {"p": jax.tree.unflatten(treedef, out),
                "r": _interop.tree_from_numpy(jax.tree.map(np.asarray, noise_r))}

    return fn


def test_loop_run_matches_reference(shared):
    jcfg, jmodel, np_params, cfg, model = shared
    jsamp, tsamp = jcore.scale_adapted_ec_sghmc(**SAMPLER), core.scale_adapted_ec_sghmc(**SAMPLER)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = _interop.tree_from_numpy(np_params)
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    lcfg = dict(num_steps=4, log_every=2, seed=3)
    batches = {t: _batch(20 + t, (K, 2, 16)) for t in range(4)}
    key_of = lambda t: jax.random.fold_in(jax.random.key(3), t)
    jstep = jmake_train_step(jcfg, jmodel, jsamp, N_DATA)
    tstep = make_train_step(cfg, model, tsamp, N_DATA, noise_fn=_noise_fn(jstate, np_params, key_of))
    jp, js, jh = jloop.run(jstep, jparams, jstate, lambda t: jax.tree.map(jnp.asarray, batches[t]),
                           jloop.LoopConfig(**lcfg), num_chains=K, sampler=jsamp)
    before = dict(launches)
    tp, ts, th = loop.run(tstep, params, state, lambda t: _interop.tree_from_numpy(batches[t]),
                          LoopConfig(**lcfg), num_chains=K, sampler=tsamp)
    assert launches == before  # the CPU path launches no kernel
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [2, 4]
    for a, b in zip(th, jh):
        for k in ("nll_per_token", "potential", "precond_v_mean"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        for k in ("chain_center_rms", "momentum_norm", "center_momentum_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, err_msg=k)
    # V̂ moved during burn-in and then froze: the mean differs between the
    # two logs only by steps 0-1's adaptation
    assert th[0]["precond_v_mean"] == th[1]["precond_v_mean"] != 1.0
    _close(tp, jp, atol=2e-6, what="params")
    _close(ts.momentum, js.momentum, atol=2e-6, what="momentum")
    _close(ts.center, js.center, atol=2e-6, what="center")
    _close(ts.precond.v, js.precond.v, atol=0.0, rtol=1e-4, what="V̂")
    assert ts.step == int(js.step) == 4 and ts.precond.step == int(js.precond.step)


def test_loop_production_noise_is_a_function_of_the_seed(shared):
    _, _, np_params, cfg, model = shared
    outs = []
    for _ in range(2):
        samp = core.scale_adapted_ec_sghmc(**SAMPLER)
        params = _interop.tree_from_numpy(np_params)
        step = make_train_step(cfg, model, samp, N_DATA)
        stream = synthetic_token_stream(cfg.vocab_size, seed=1, device="cpu")
        p, s, h = loop.run(step, params, samp.init(params),
                           lambda t: chain_batches(stream, t, K, 2, 16),
                           LoopConfig(num_steps=3, log_every=1), num_chains=K, sampler=samp)
        outs.append(p)
        assert len(h) == 3 and all(np.isfinite(v) for m in h for v in m.values())
        assert h[-1]["momentum_norm"] > 0 and h[-1]["precond_v_mean"] != 1.0
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)
