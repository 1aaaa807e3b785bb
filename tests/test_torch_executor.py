"""The port's chain executor and streaming diagnostics, on the CPU.

Chunking is invisible (chunk 1, 7 and the whole run give identical
trajectories in every key mode), thinning keeps every ``thin``-th state,
and the in-carry Welford moments and batch-means ESS equal the reference's
functions on the same series (rtol 1e-5: both are f32 running sums in the
same order).  The numpy ESS copy equals the reference's exactly.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import diagnostics as jdiag
from repro_torch import core
from repro_torch import diagnostics as diag
from repro_torch.core import rng
from repro_torch.run import ChainExecutor, ess_feedback_adapter, rollout

MU = 1.5
STEPS = 48


def _grad(th):
    return th - MU


def _sampler(fused=False):
    return core.ec_sghmc(step_size=0.1, alpha=1.0, sync_every=4, fused=fused)


def _run(chunk, key_mode="keys", thin=1, fused=False, steps=STEPS, **kw):
    p0 = torch.full((4, 3), MU + 1.0)
    keys = rng.split(rng.key(5), steps) if key_mode == "keys" else None
    key = rng.key(6) if key_mode != "keys" else None
    return rollout(_sampler(fused), _grad, p0, num_steps=steps, keys=keys, key=key,
                   key_mode=key_mode, thin=thin, chunk_steps=chunk, **kw)


@pytest.mark.parametrize("key_mode", ["keys", "fold", "carry"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_chunking_is_invisible(key_mode, fused):
    whole = _run(STEPS, key_mode, fused=fused)
    for chunk in (1, 7):
        res = _run(chunk, key_mode, fused=fused)
        assert torch.equal(res.trace, whole.trace), f"chunk {chunk} changed the trajectory"
        assert torch.equal(res.params, whole.params)
        assert torch.equal(res.moments.mean, whole.moments.mean)


def test_key_modes_differ():
    runs = [_run(STEPS, m).trace for m in ("keys", "fold", "carry")]
    assert not torch.equal(runs[0], runs[1]) and not torch.equal(runs[1], runs[2])


def test_thinning_keeps_every_thin_th_state():
    full = _run(16, "fold")
    thinned = _run(16, "fold", thin=4)
    assert thinned.trace.shape[0] == STEPS // 4
    assert torch.equal(thinned.trace, full.trace[3::4])


def test_thin_must_divide_chunk():
    with pytest.raises(ValueError):
        ChainExecutor(sampler=_sampler(), grad_fn=lambda t, b: _grad(t), trace_fn=lambda p: p,
                      thin=3, chunk_steps=8)


def test_in_carry_moments_match_trajectory():
    res = _run(16, "keys")
    traj = res.trace.numpy()
    np.testing.assert_allclose(res.moments.mean.numpy(), traj.mean(0), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(diag.welford_var(res.moments).numpy(), traj.var(0), rtol=2e-3,
                               atol=2e-4)


def test_moments_from_burnin():
    burn = 20
    res = _run(16, "keys", moments_from=burn)
    assert float(res.moments.count) == STEPS - burn
    np.testing.assert_allclose(res.moments.mean.numpy(), res.trace.numpy()[burn:].mean(0),
                               rtol=2e-4, atol=2e-4)


def test_resume_from_start_step_in_fold_mode():
    whole = _run(STEPS, "fold")
    samp = _sampler()
    ex = ChainExecutor(sampler=samp, grad_fn=lambda t, b: _grad(t), trace_fn=lambda p: p,
                       key_mode="fold", chunk_steps=8)
    p0 = torch.full((4, 3), MU + 1.0)
    first = ex.run(p0, samp.init(p0), num_steps=STEPS // 2, key=rng.key(6))
    second = ex.run(first.params, first.state, num_steps=STEPS // 2, key=rng.key(6),
                    start_step=STEPS // 2)
    assert torch.equal(torch.cat([first.trace, second.trace]), whole.trace)


def test_on_chunk_boundaries_and_early_stop():
    seen = []

    def on_chunk(step_end, params, state, outs):
        seen.append((step_end, state.step, outs["trace"].shape[0]))
        return step_end < 24

    samp = _sampler()
    ex = ChainExecutor(sampler=samp, grad_fn=lambda t, b: _grad(t), trace_fn=lambda p: p,
                       chunk_steps=8, key_mode="fold", collect_stats=True)
    p0 = torch.full((4, 3), MU + 1.0)
    res = ex.run(p0, samp.init(p0), num_steps=STEPS, key=rng.key(1), on_chunk=on_chunk)
    assert seen == [(8, 8, 8), (16, 16, 8), (24, 24, 8)]
    assert res.steps == 24 and res.trace.shape[0] == 24
    assert res.stats["chain_center_rms"].shape == (24,)
    assert torch.equal(res.stats["step"], torch.arange(1, 25))


def test_step_fn_mode_and_batches():
    calls = []

    def step_fn(params, state, batch, rng_key):
        calls.append(batch)
        return params + batch, state, {"b": torch.tensor(float(batch))}

    ex = ChainExecutor(step_fn=step_fn, batch_fn=lambda t: t, key_mode="fold", chunk_steps=3)
    res = ex.run(torch.zeros(()), None, num_steps=7, key=rng.key(0), start_step=10)
    assert calls == list(range(10, 17)) and float(res.params) == sum(range(10, 17))
    assert float(res.metrics["b"]) == 16.0


@pytest.mark.parametrize("call", ["sharded", "lower"])
def test_unported_modes_raise(call):
    """run_sharded is ported (tests/test_torch_sharding.py) and refuses a
    mesh without the chain axis; lower_sharded has no lowered program in
    eager torch and points to the collective counter."""
    samp = _sampler()
    ex = ChainExecutor(sampler=samp, grad_fn=lambda t, b: _grad(t), key_mode="fold")
    p0 = torch.zeros(4, 3)
    mesh = SimpleNamespace(mesh_dim_names=("data",))
    calls = {
        "sharded": lambda: ex.run_sharded(p0, None, num_steps=1, key=1, mesh=mesh),
        "lower": lambda: ex.lower_sharded(p0, None, num_steps=1, key=1, mesh=mesh),
    }
    expected = {"sharded": (ValueError, "no 'chain' axis"),
                "lower": (NotImplementedError, "collective counter")}
    with pytest.raises(expected[call][0], match=expected[call][1]):
        calls[call]()


SWEEP_P0 = np.stack([np.full((4, 3), MU + 1.0), np.full((4, 3), MU - 2.0)]).astype(np.float32)
SWEEP_EPS = np.array([0.1, 0.05], np.float32)


def _swept_calls(core_mod, executor_cls, adapter, roll, key, one_key, zeros, pkg):
    """The swept calls of one package.  The plain ids run on an unswept
    state: a hyper without ``sweep=False`` (or ``sweep=True``) sweeps the
    leading axis of params and state, which that state does not carry.
    The ``-swept`` ids make the same call on a state swept over two runs
    (``pkg``: the package's ``asarray``, its swept ``init``, (S, steps)
    keys and the hyper values), at temperature 0 so that the two packages'
    different noise streams drop out."""
    samp = core_mod.ec_sghmc(step_size=0.1, alpha=1.0, sync_every=4)
    mk = lambda: executor_cls(sampler=samp, grad_fn=lambda t, b: _grad(t), key_mode="fold")
    factory = lambda: executor_cls(sampler_factory=lambda h: samp, grad_fn=lambda t, b: t,
                                   key_mode="fold", ess_probe_fn=lambda p: p[0])
    p0 = zeros((4, 3))
    cold = core_mod.ec_sghmc(step_size=0.1, alpha=1.0, sync_every=4, temperature=0.0)
    cold_mk = lambda: executor_cls(sampler=cold, grad_fn=lambda t, b: _grad(t), key_mode="fold")
    grid = lambda h: core_mod.ec_sghmc(step_size=h["eps"], alpha=1.0, sync_every=4,
                                       temperature=0.0)
    cold_factory = lambda: executor_cls(sampler_factory=grid, grad_fn=lambda t, b: t,
                                        key_mode="fold", ess_probe_fn=lambda p: p[0])
    ps = lambda: pkg["asarray"](SWEEP_P0)
    st = lambda: pkg["init"](cold, ps())
    return {
        "factory": lambda: factory().run(p0, samp.init(p0), num_steps=1, key=key, hyper={}),
        "hyper": lambda: mk().run(p0, samp.init(p0), num_steps=1, key=key, hyper={}),
        "adapt": lambda: mk().run(p0, samp.init(p0), num_steps=1, key=key, hyper={}, sweep=True,
                                  adapt_fn=lambda *a: None),
        "feedback": lambda: factory().run(p0, samp.init(p0), num_steps=2, key=key, hyper={},
                                          adapt_fn=adapter(None)),
        "sweep": lambda: roll(samp, _grad, p0, num_steps=1, keys=one_key, sweep=True),
        "factory-swept": lambda: cold_factory().run(ps(), st(), num_steps=8, key=key,
                                                    hyper=pkg["hyper"]),
        "hyper-swept": lambda: cold_mk().run(ps(), st(), num_steps=8, key=key, hyper={}),
        "adapt-swept": lambda: cold_mk().run(ps(), st(), num_steps=8, key=key, hyper={},
                                             sweep=True, adapt_fn=lambda *a: None),
        "feedback-swept": lambda: cold_factory().run(ps(), st(), num_steps=2, key=key,
                                                     hyper=pkg["hyper"], adapt_fn=adapter(None)),
        "sweep-swept": lambda: roll(cold, _grad, ps(), num_steps=8, keys=pkg["keys"], sweep=True),
    }


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - the exception type is what is compared
        return None, type(e)


@pytest.mark.parametrize("call", ["factory", "hyper", "adapt", "feedback", "sweep",
                                  "factory-swept", "hyper-swept", "adapt-swept",
                                  "feedback-swept", "sweep-swept"])
def test_swept_modes_match_reference(call):
    """Swept runs are ported: each call behaves as the reference's same call
    (its keys made JAX keys): the same result, or the same exception type
    where the reference raises.  The unswept-state calls raise in both; the
    swept-state calls run in both and give the same params (atol 2e-6)."""
    import jax

    from repro import core as jcore
    from repro.run import ChainExecutor as JChainExecutor
    from repro.run import ess_feedback_adapter as j_adapter
    from repro.run import rollout as jrollout
    from repro_torch.run import stack_runs

    jkey = jax.random.PRNGKey(1)
    jpkg = dict(asarray=jnp.asarray, init=lambda s, p: jax.vmap(s.init)(p),
                keys=jax.random.split(jkey, 16).reshape(2, 8, -1),
                hyper={"eps": jnp.asarray(SWEEP_EPS)})
    tpkg = dict(asarray=torch.tensor,  # a copy: the port updates its params in place
                init=lambda s, p: stack_runs([s.init(x) for x in p]),
                keys=[rng.split(rng.key(1), 8), rng.split(rng.key(2), 8)],
                hyper={"eps": torch.from_numpy(SWEEP_EPS)})
    ref = _swept_calls(jcore, JChainExecutor, j_adapter, jrollout, jkey,
                       jax.random.split(jkey, 1), jnp.zeros, jpkg)[call]
    port = _swept_calls(core, ChainExecutor, ess_feedback_adapter, rollout, 1, [[1]],
                        torch.zeros, tpkg)[call]
    (ref_out, ref_exc), (out, exc) = _outcome(ref), _outcome(port)
    assert exc is ref_exc, f"port raised {exc}, the reference {ref_exc}"
    assert (exc is None) == call.endswith("-swept")
    if ref_exc is None:
        assert out.params.shape == SWEEP_P0.shape
        np.testing.assert_allclose(out.params.numpy(), np.asarray(ref_out.params), atol=2e-6)


# --- streaming diagnostics against the reference --------------------------------


def _series(seed, n=600, shape=(3, 2)):
    r = np.random.default_rng(seed)
    x = np.zeros((n,) + shape, np.float32)
    for t in range(1, n):  # AR(1): correlated, so the ESS is well below n
        x[t] = 0.8 * x[t - 1] + r.normal(size=shape)
    return x


def test_welford_matches_reference():
    x = _series(0)
    jst = jdiag.welford_init(jnp.zeros(x.shape[1:]))
    st = diag.welford_init(torch.zeros(x.shape[1:]))
    for row in x:
        jst = jdiag.welford_add(jst, jnp.asarray(row))
        st = diag.welford_add(st, torch.from_numpy(row))
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(jst.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(diag.welford_var(st, 1).numpy(), np.asarray(jdiag.welford_var(jst, 1)),
                               rtol=1e-5, atol=1e-6)
    half = diag.welford_init(torch.zeros(x.shape[1:]))
    for row in x[:200]:
        half = diag.welford_add(half, torch.from_numpy(row))
    rest = diag.welford_init(torch.zeros(x.shape[1:]))
    for row in x[200:]:
        rest = diag.welford_add(rest, torch.from_numpy(row))
    merged = diag.welford_merge(half, rest)
    np.testing.assert_allclose(merged.mean.numpy(), st.mean.numpy(), rtol=1e-5, atol=1e-6)
    js = jdiag.chain_summary(jst)
    ts = diag.chain_summary(st)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch_len", [8, 25])
def test_batch_means_ess_matches_reference(batch_len):
    x = _series(1)
    jst = jdiag.batch_ess_init(jnp.zeros(x.shape[1:]), batch_len)
    st = diag.batch_ess_init(torch.zeros(x.shape[1:]), batch_len)
    for i, row in enumerate(x):
        jst = jdiag.batch_ess_add(jst, jnp.asarray(row))
        st = diag.batch_ess_add(st, torch.from_numpy(row))
        if i in (batch_len, 3 * batch_len + 1):
            np.testing.assert_allclose(diag.batch_ess_estimate(st).numpy(),
                                       np.asarray(jdiag.batch_ess_estimate(jst)), rtol=1e-5)
    got = diag.batch_ess_estimate(st).numpy()
    np.testing.assert_allclose(got, np.asarray(jdiag.batch_ess_estimate(jst)), rtol=1e-5)
    assert (got < len(x)).all()


def test_in_carry_ess_probe():
    res = _run(16, "fold", ess_probe_fn=lambda p: p[:, 0], ess_batch_len=8)
    assert res.ess.count == STEPS and res.ess.m_count == STEPS // 8
    assert diag.batch_ess_estimate(res.ess).shape == (4,)


@pytest.mark.parametrize("fn", ["effective_sample_size_nd", "coupled_ess_nd", "split_rhat_nd"])
def test_ess_copy_matches_reference(fn):
    x = np.moveaxis(_series(2, n=400, shape=(4, 3)), 0, 1)  # (chains, samples, dims)
    np.testing.assert_array_equal(getattr(diag, fn)(x), getattr(jdiag, fn)(x))


def test_spread_helpers_match_reference():
    r = np.random.default_rng(3)
    tree = {"a": r.normal(size=(4, 5)).astype(np.float32), "b": r.normal(size=(4, 2, 3)).astype(np.float32)}
    center = {k: v.mean(0) + 0.1 for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    tc = {k: torch.from_numpy(v) for k, v in center.items()}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    jc = {k: jnp.asarray(v) for k, v in center.items()}
    np.testing.assert_allclose(float(diag.chain_center_rms(tt, tc)),
                               float(jdiag.chain_center_rms(jt, jc)), rtol=1e-6)
    traj = r.normal(size=(4, 50, 3))
    for a, b in zip(diag.pooled_moments(traj), jdiag.pooled_moments(traj)):
        np.testing.assert_array_equal(a, b)
