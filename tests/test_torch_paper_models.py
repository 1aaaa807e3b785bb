"""The paper's posteriors on the port, against the reference, on the CPU.

* ``models.mlp`` and ``models.resnet``: logits, ``nll_fn`` and the
  potential's gradients on the reference's ``init_params`` output (HWIO
  conv weights, unchanged), at atol 2e-5 on logits and NLLs (the models'
  tolerance) and rtol 1e-4 on gradients (the potential scales the f32 sum
  by n_data / B).  XLA's SAME padding is asymmetric at stride 2, which a
  symmetric ``F.conv2d(padding=1)`` misses: the stride-2 convolutions are
  held against the reference, and the symmetric version is shown to fail.
* ``data.ShardedLoader``: batches identical to the reference's, index for
  index.
* ``data.synthetic_{mnist,cifar10}``: the reference's shapes and dtypes,
  the input law, and labels drawn from softmax(teacher logits) by the same
  Gumbel-max law as ``jax.random.categorical``.
* The slice as a whole: a hidden-16 MLP posterior on the reference's
  synthetic MNIST, 12 executor steps of fused EC-SGHMC (K = 3, the
  kernel's plain version in bits mode) and of Async SGHMC (3 workers,
  s = 2), with the reference's noise handed in, against the reference's
  executor run of the same steps at the training stack's atol 2e-6.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import core as jcore
from repro.core import tree_util as jtu
from repro.data import synthetic as jsyn
from repro.data.pipeline import ShardedLoader as JShardedLoader
from repro.models import init_params as jinit
from repro.models import mlp as jmlp
from repro.models import resnet as jresnet
from repro.run import ChainExecutor as JChainExecutor
from repro_torch import _interop, core
from repro_torch.core import potential, rng
from repro_torch.data import ShardedLoader, synthetic
from repro_torch.data import synthetic_cifar10, synthetic_mnist
from repro_torch.models import mlp, resnet
from repro_torch.run import ChainExecutor
from test_torch_core_samplers import _ec_noise

MODEL_ATOL = 2e-5
GRAD_RTOL = 1e-4
ATOL = 2e-6

MODELS = {  # name: (reference module, port module, specs kw, input shape)
    "mlp-16": (jmlp, mlp, dict(hidden=16), (6, 784)),
    "mlp-800": (jmlp, mlp, dict(), (4, 784)),
    "resnet-4": (jresnet, resnet, dict(width=4), (3, 32, 32, 3)),
    "resnet-16": (jresnet, resnet, dict(width=16), (2, 32, 32, 3)),
}


def _model(name, seed=0):
    jmod, mod, kw, xshape = MODELS[name]
    jp = jinit(jmod.param_specs(**kw), jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    x = r.normal(size=xshape).astype(np.float32)
    y = r.integers(0, 10, size=xshape[0]).astype(np.int32)
    return jmod, mod, jp, _interop.tree_from_numpy(jax.tree.map(np.asarray, jp)), x, y


@pytest.mark.parametrize("name", list(MODELS))
def test_apply_and_nll_match_reference(name):
    jmod, mod, jp, tp, x, y = _model(name)
    jl = np.asarray(jmod.apply(jp, jnp.asarray(x)))
    tl = mod.apply(tp, torch.from_numpy(x)).numpy()
    assert tl.shape == jl.shape == (x.shape[0], 10)
    np.testing.assert_allclose(tl, jl, atol=MODEL_ATOL, rtol=1e-5)
    js, jn = jmod.nll_fn(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    ts, tn = mod.nll_fn(tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(ts), float(js), atol=MODEL_ATOL, rtol=1e-6)
    assert float(tn) == float(jn) == x.shape[0]


@pytest.mark.parametrize("name", list(MODELS))
def test_potential_gradients_match_reference(name):
    jmod, mod, jp, tp, x, y = _model(name, seed=1)
    n_data = 1000
    jpot = jcore.make_potential(jmod.nll_fn, n_data=n_data, prior=jcore.gaussian_prior(1e-5))
    pot = potential.make_potential(mod.nll_fn, n_data=n_data, prior=potential.gaussian_prior(1e-5))
    jv, jg = jpot.value_and_grad(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tv, tg = pot.value_and_grad(tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for k in sorted(jg):
        g, want = tg[k].numpy(), np.asarray(jg[k])
        np.testing.assert_allclose(g, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["mlp-16", "resnet-4"])
def test_chainwise_matches_per_chain_potential(name):
    """The chain lift (one ``torch.func.vmap`` pass, the reference's
    ``jax.vmap``) against the per-chain potential (held to the reference
    above), K = 2 chains with their own minibatches."""
    _, mod, _, tp, x, y = _model(name, seed=2)
    stack = {k: torch.stack([v, 1.5 * v]) for k, v in tp.items()}
    xs, ys = np.stack([x, x[::-1].copy()]), np.stack([y, y[::-1].copy()])
    batch = {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}
    pot = potential.make_potential(mod.nll_fn, n_data=500, prior=potential.gaussian_prior(1e-5))
    v, g = potential.chainwise(pot).value_and_grad(stack, batch)
    assert tuple(v.shape) == (2,)
    for i in range(2):
        vi, gi = pot.value_and_grad({k: t[i] for k, t in stack.items()},
                                    {k: t[i] for k, t in batch.items()})
        np.testing.assert_allclose(float(v[i]), float(vi), rtol=1e-6)
        for k in sorted(gi):
            want = gi[k].numpy()
            np.testing.assert_allclose(g[k][i].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("size,k,cin,cout", [(32, 3, 4, 8), (16, 3, 8, 16), (32, 1, 4, 8),
                                             (15, 3, 4, 4)])
def test_stride2_same_padding_matches_reference(size, k, cin, cout):
    """Stride-2 SAME convolutions, the reference's ``_conv`` against the
    port's; at an even input the 3x3 case pads (0, 1), and the symmetric
    padding the port must not use is shown to differ."""
    r = np.random.default_rng(size + k)
    x = r.normal(size=(2, size, size, cin)).astype(np.float32)
    w = r.normal(size=(k, k, cin, cout)).astype(np.float32)
    want = np.asarray(jresnet._conv(jnp.asarray(x), jnp.asarray(w), 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = resnet.conv(xt, torch.from_numpy(w), 2).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    if k == 3 and size % 2 == 0:
        assert resnet.same_padding(size, 3, 2) == (0, 1)
        sym = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
        assert sym.shape == xt.new_empty(2, cout, size // 2, size // 2).shape
        assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1e-1


def test_resnet32_structure():
    specs = resnet.param_specs(width=16)
    jspecs = jresnet.param_specs(width=16)
    assert {k: v.shape for k, v in specs.items()} == {k: v.shape for k, v in jspecs.items()}
    n_conv = sum(1 for k in specs if k.startswith("s") and k[-2] == "c") + 1
    assert n_conv == 31  # 3 stages x 5 blocks x 2 convs + the stem, + the head = 32 layers
    assert sum(int(np.prod(s.shape)) for s in mlp.param_specs().values()) == 1_276_810


# --- data -------------------------------------------------------------------------


@pytest.mark.parametrize("chains", [1, 3])
def test_sharded_loader_matches_reference(chains):
    x, y = jsyn.synthetic_mnist(500, seed=3)
    jl = JShardedLoader(x, y, batch_size=7, num_chains=chains, seed=11)
    tl = ShardedLoader(x, y, batch_size=7, num_chains=chains, seed=11, device="cpu")
    for step in (0, 1, 17, 1000):
        jb, tb = jl.batch(step), tl.batch(step)
        lead = (chains,) if chains > 1 else ()
        assert tuple(tb["x"].shape) == lead + (7, 784) and tuple(tb["y"].shape) == lead + (7,)
        np.testing.assert_array_equal(tb["x"].numpy(), np.asarray(jb["x"]))
        np.testing.assert_array_equal(tb["y"].numpy(), np.asarray(jb["y"]))


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_synthetic_datasets_shapes_and_law(name):
    n = 3000
    jfn, fn = {"mnist": (jsyn.synthetic_mnist, synthetic_mnist),
               "cifar10": (jsyn.synthetic_cifar10, synthetic_cifar10)}[name]
    jx, jy = jfn(n, seed=0)
    x, y = fn(n, seed=0, device="cpu")
    assert tuple(x.shape) == jx.shape and tuple(y.shape) == jy.shape
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    assert jx.dtype == np.float32 and jy.dtype == np.int32
    assert int(y.min()) >= 0 and int(y.max()) < 10 and len(torch.unique(y)) == 10
    # the input law: mean center_loc, variance center_scale^2 + noise^2
    loc, var = {"mnist": (0.5, 0.2**2 + 0.15**2), "cifar10": (0.0, 0.1**2 + 0.25**2)}[name]
    for arr in (x.numpy(), jx):
        assert abs(arr.mean() - loc) < 0.02 and abs(arr.var() - var) / var < 0.1
    # the same seed gives the same data; another seed other data
    x2, y2 = fn(n, seed=0, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(fn(n, seed=1, device="cpu")[0], x)
    # the labels are the teacher's draw, reproduced from the same generator
    feats = x.reshape(n, -1)[:, ::4] if name == "cifar10" else x
    gen = rng.generator(rng.key(1), "cpu")
    logits = synthetic.teacher_logits(feats, gen)
    assert torch.equal(synthetic.categorical(logits, gen), y)


def test_categorical_law_matches_reference():
    """Gumbel-max draws from fixed logits: the port's and jax.random's
    class frequencies both match softmax(logits) within 5 sigma."""
    n = 20_000
    logits = np.random.default_rng(0).normal(size=(1, 10)).astype(np.float32) * 1.5
    big = np.repeat(logits, n, axis=0)
    p = np.exp(logits[0] - logits[0].max())
    p /= p.sum()
    tol = 5 * np.sqrt(p * (1 - p) / n)
    ours = synthetic.categorical(torch.from_numpy(big), rng.generator(rng.key(2), "cpu")).numpy()
    theirs = np.asarray(jax.random.categorical(jax.random.PRNGKey(2), jnp.asarray(big)))
    for draws in (ours, theirs):
        freq = np.bincount(draws, minlength=10) / n
        assert np.all(np.abs(freq - p) < tol), (freq, p)


# --- the slice as a whole ---------------------------------------------------------

K = 3
STEPS = 12
N_TRAIN = 600
# the paper's sampler settings, sgd_map(lr=3e-7, beta=0.9) of
# benchmarks/posterior_driver.py: eps = sqrt(lr (1 - beta)), V = (1 - beta) / eps
EPS = math.sqrt(3e-7 * 0.1)
FRIC = 0.1 / EPS


def _slice_setup():
    x, y = jsyn.synthetic_mnist(N_TRAIN, seed=4)
    jp1 = jinit(jmlp.param_specs(hidden=16), jax.random.PRNGKey(5))
    return x, y, jax.tree.map(np.asarray, jp1)


def _noise_sampler(inner, noises):
    """``inner`` with step t's noise taken from ``noises[t]``."""
    return core.Sampler(inner.init,
                        lambda g, st, p, rng_=None: inner.update(g, st, p, None,
                                                                 noise=noises[st.step]),
                        inner.grad_targets, inner.stats)


@pytest.mark.parametrize("job", ["ec_fused", "async_s2"])
def test_paper_slice_matches_reference(job):
    x, y, np_p1 = _slice_setup()
    lead = (K,) if job == "ec_fused" else ()
    np_params = {k: np.broadcast_to(v, lead + v.shape).copy() for k, v in np_p1.items()}
    keys = jax.random.split(jax.random.PRNGKey(6), STEPS)
    kw = dict(step_size=EPS, friction=FRIC)
    if job == "ec_fused":
        mk = lambda c, **f: c.ec_sghmc(center_friction=FRIC, alpha=1.0, sync_every=4,
                                       noise_convention="eq4", center_noise_in_p=False, **kw, **f)
        jsamp, tsamp = mk(jcore, fused=True), mk(core, fused=True)
    else:
        jsamp = jcore.async_sghmc(num_workers=K, sync_every=2, **kw)
        tsamp = core.async_sghmc(num_workers=K, sync_every=2, **kw)

    # the reference's run, through its executor
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate0 = jsamp.init(jparams)
    jpot = jcore.make_potential(jmlp.nll_fn, n_data=N_TRAIN, prior=jcore.gaussian_prior(1e-5))
    jloader = JShardedLoader(x, y, batch_size=10, num_chains=K, seed=7)
    jex = JChainExecutor(sampler=jsamp, grad_fn=lambda t, b: jax.vmap(jpot.grad)(t, b),
                         batch_fn=jloader.batch, chunk_steps=4, key_mode="keys")
    jres = jex.run(jparams, jstate0, num_steps=STEPS, keys=keys)

    # the same steps on the port, with the reference's noise handed in
    jstate_shapes = jsamp.init(jax.tree.map(jnp.asarray, np_params))
    if job == "ec_fused":
        noises = [_ec_noise(keys[t], jstate_shapes, jax.tree.map(jnp.asarray, np_params), True)
                  for t in range(STEPS)]
    else:
        noises = [_interop.tree_from_numpy(jax.tree.map(
            np.asarray, jtu.tree_random_normal(keys[t], jstate_shapes.momentum, jnp.float32)))
            for t in range(STEPS)]
    params = _interop.tree_from_numpy(np_params)
    pot = potential.chainwise(potential.make_potential(
        mlp.nll_fn, n_data=N_TRAIN, prior=potential.gaussian_prior(1e-5)))
    loader = ShardedLoader(x, y, batch_size=10, num_chains=K, seed=7, device="cpu")
    ex = ChainExecutor(sampler=_noise_sampler(tsamp, noises), grad_fn=pot.grad,
                       batch_fn=loader.batch, chunk_steps=4, key_mode="keys")
    res = ex.run(params, tsamp.init(params), num_steps=STEPS, keys=list(range(STEPS)))

    for k in sorted(np_params):
        np.testing.assert_allclose(res.params[k].numpy(), np.asarray(jres.params[k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    fields = (("momentum", "center", "center_momentum") if job == "ec_fused"
              else ("momentum", "snapshots"))
    for f in fields:
        for k in sorted(np_params):
            np.testing.assert_allclose(getattr(res.state, f)[k].numpy(),
                                       np.asarray(getattr(jres.state, f)[k]), atol=ATOL, rtol=0,
                                       err_msg=f"{f}/{k}")
    assert res.state.step == STEPS
