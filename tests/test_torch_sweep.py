"""Swept runs of the port's executor, on the CPU (mirrors the sweep cases of
``tests/test_executor.py``).

A swept run advances S independent runs over the leading axis of params,
state and keys.  The port runs them one after another inside each chunk,
over views of the stacked tensors, so a swept run equals its per-member
runs bit for bit, in every key mode, fused or not.  An (alpha, eps) grid
built by ``sampler_factory`` from a swept ``hyper`` matches directly built
samplers at atol 1e-6 (the reference's tolerance), and, at temperature 0,
the reference's own swept grid at atol 2e-6.  Async SGHMC's gradients go
through ``grad_targets`` in the executor exactly as in a per-step loop.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.run import ChainExecutor as JChainExecutor
from repro_torch import core
from repro_torch.core import rng
from repro_torch.run import ChainExecutor, rollout, stack_runs

MU = 1.5
K = 4
STEPS = 40


def _grad(th):
    return th - MU


def _start(shape):
    return torch.full(shape, MU + 1.0)


def _ec(fused=False, **kw):
    return core.ec_sghmc(step_size=0.1, alpha=1.0, sync_every=4, fused=fused, **kw)


def _seed_keys(R, steps=STEPS, base=20):
    return [rng.split(rng.key(base + r), steps) for r in range(R)]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_stacked_seeds_match_members(fused):
    """Swept == per-member runs, bitwise (trace, final params and state,
    moments)."""
    R = 3
    keys = _seed_keys(R)
    swept = rollout(_ec(fused), _grad, _start((R, K, 2)), num_steps=STEPS, keys=keys,
                    chunk_steps=16, sweep=True)
    assert swept.trace.shape == (R, STEPS, K, 2) and swept.moments.mean.shape == (R, K, 2)
    for r in range(R):
        member = rollout(_ec(fused), _grad, _start((K, 2)), num_steps=STEPS, keys=keys[r],
                         chunk_steps=16)
        assert torch.equal(swept.trace[r], member.trace)
        assert torch.equal(swept.params[r], member.params)
        assert torch.equal(swept.state.center[r], member.state.center)
        assert torch.equal(swept.state.momentum[r], member.state.momentum)
        assert torch.equal(swept.moments.mean[r], member.moments.mean)
    assert swept.state.step == STEPS


@pytest.mark.parametrize("mode", ["fold-shared", "fold-stacked", "carry"])
def test_swept_key_modes_match_members(mode):
    R = 2
    key_mode = "carry" if mode == "carry" else "fold"
    key = rng.key(9) if mode == "fold-shared" else [rng.key(9 + r) for r in range(R)]
    ex = ChainExecutor(sampler=_ec(), grad_fn=lambda t, _b: _grad(t), trace_fn=lambda p: p,
                       chunk_steps=16, key_mode=key_mode)
    p0 = _start((R, K, 2))
    st0 = stack_runs([_ec().init(p0[r]) for r in range(R)])
    swept = ex.run(p0, st0, num_steps=STEPS, key=key, sweep=True)
    for r in range(R):
        pr = _start((K, 2))
        member = ex.run(pr, _ec().init(pr), num_steps=STEPS,
                        key=key if mode == "fold-shared" else key[r])
        assert torch.equal(swept.trace[r], member.trace)
    if mode == "fold-shared":  # one shared key: every run draws the same noise
        assert torch.equal(swept.trace[0], swept.trace[1])


def test_hyper_factory_grid():
    """An (alpha, step_size) grid built per run by ``sampler_factory``
    matches directly constructed samplers (atol 1e-6, as the reference)."""
    hyper = {"alpha": torch.tensor([0.0, 1.0]), "eps": torch.tensor([5e-3, 1e-2])}

    def factory(h):
        return core.ec_sghmc(step_size=h["eps"], alpha=h["alpha"], sync_every=4, friction=1.0,
                             center_friction=1.0, noise_convention="eq6")

    grid = 2
    p0 = _start((grid, K, 2))
    st0 = stack_runs(
        [factory({k: v[i] for k, v in hyper.items()}).init(p0[i]) for i in range(grid)])
    keys = _seed_keys(grid, base=30)
    ex = ChainExecutor(sampler_factory=factory, grad_fn=lambda t, _b: _grad(t),
                       trace_fn=lambda p: p, chunk_steps=16, key_mode="keys")
    res = ex.run(p0, st0, num_steps=STEPS, keys=keys, hyper=hyper)
    assert res.trace.shape == (grid, STEPS, K, 2)
    for i, (alpha, eps) in enumerate([(0.0, 5e-3), (1.0, 1e-2)]):
        direct = core.ec_sghmc(step_size=eps, alpha=alpha, sync_every=4, friction=1.0,
                               center_friction=1.0, noise_convention="eq6")
        member = rollout(direct, _grad, _start((K, 2)), num_steps=STEPS, keys=keys[i],
                         chunk_steps=16)
        np.testing.assert_allclose(res.trace[i].numpy(), member.trace.numpy(), rtol=0,
                                   atol=1e-6)


def test_hyper_grid_matches_reference_at_temperature_zero():
    """The deterministic grid (temperature 0) against the reference's vmapped
    sweep program, from the same start: atol 2e-6."""
    alphas, epss = [0.0, 0.5, 1.0], [5e-3, 1e-2]
    pairs = [(a, e) for a in alphas for e in epss]
    grid = len(pairs)
    start = np.random.default_rng(0).normal(size=(grid, K, 2)).astype(np.float32)

    def factory(c, h):
        return c.ec_sghmc(step_size=h["eps"], alpha=h["alpha"], sync_every=4, friction=1.0,
                          center_friction=1.0, noise_convention="eq6", temperature=0.0)

    jh = {"alpha": jnp.array([a for a, _ in pairs]), "eps": jnp.array([e for _, e in pairs])}
    jp0 = jnp.asarray(start)
    jst0 = jax.vmap(lambda h, p: factory(jcore, h).init(p))(jh, jp0)
    jkeys = jnp.stack([jax.random.split(jax.random.PRNGKey(i), STEPS) for i in range(grid)])
    jex = JChainExecutor(sampler_factory=lambda h: factory(jcore, h),
                         grad_fn=lambda t, _b: t - MU, trace_fn=lambda p: p, chunk_steps=16,
                         key_mode="keys")
    jres = jex.run(jp0, jst0, num_steps=STEPS, keys=jkeys, hyper=jh)

    th = {"alpha": torch.tensor([a for a, _ in pairs]), "eps": torch.tensor([e for _, e in pairs])}
    p0 = torch.from_numpy(start.copy())
    st0 = stack_runs(
        [factory(core, {k: v[i] for k, v in th.items()}).init(p0[i]) for i in range(grid)])
    ex = ChainExecutor(sampler_factory=lambda h: factory(core, h), grad_fn=lambda t, _b: _grad(t),
                       trace_fn=lambda p: p, chunk_steps=16, key_mode="keys")
    res = ex.run(p0, st0, num_steps=STEPS, keys=_seed_keys(grid), hyper=th)
    np.testing.assert_allclose(res.trace.numpy(), np.asarray(jres.trace), rtol=0, atol=2e-6)


def test_rollout_sweep_traces_and_thinning():
    R = 2
    keys = _seed_keys(R)
    full = rollout(_ec(), _grad, _start((R, K, 2)), num_steps=STEPS, keys=keys, chunk_steps=8,
                   sweep=True)
    thin = rollout(_ec(), _grad, _start((R, K, 2)), num_steps=STEPS, keys=keys, chunk_steps=8,
                   thin=4, sweep=True)
    assert thin.trace.shape == (R, STEPS // 4, K, 2)
    assert torch.equal(thin.trace, full.trace[:, 3::4])
    notrace = rollout(_ec(), _grad, _start((R, K, 2)), num_steps=STEPS, keys=keys,
                      chunk_steps=8, trace=False, sweep=True)
    assert notrace.trace is None and torch.equal(notrace.params, full.params)


def test_swept_on_chunk_stats_and_metrics():
    R = 2
    seen = []

    def on_chunk(step_end, params, state, outs):
        seen.append((step_end, tuple(params.shape), tuple(outs["trace"].shape)))

    def grad_fn(t, _b):
        return _grad(t), {"gnorm": torch.linalg.norm(t)}

    ex = ChainExecutor(sampler=_ec(), grad_fn=grad_fn, trace_fn=lambda p: p, chunk_steps=16,
                       key_mode="fold", collect_stats=True)
    p0 = _start((R, K, 2))
    st0 = stack_runs([_ec().init(p0[r]) for r in range(R)])
    res = ex.run(p0, st0, num_steps=32, key=rng.key(3), sweep=True, on_chunk=on_chunk)
    assert seen == [(16, (R, K, 2), (R, 16, K, 2)), (32, (R, K, 2), (R, 16, K, 2))]
    assert res.stats["chain_center_rms"].shape == (R, 32)
    assert res.metrics["gnorm"].shape == (R,)


def test_swept_adapt_fn_sees_stacked_carry():
    R, seen = 2, []

    def adapt(step_end, carry, hyper):
        seen.append((step_end, tuple(carry["wf"].mean.shape), carry["ess"].batch_sum.shape))
        return {"eps": hyper["eps"] * 0.5}

    def factory(h):
        return core.sghmc(step_size=h["eps"])

    ex = ChainExecutor(sampler_factory=factory, grad_fn=lambda t, _b: _grad(t), moments=True,
                       ess_probe_fn=lambda p: p[:1], ess_batch_len=4, chunk_steps=8,
                       key_mode="fold")
    p0 = _start((R, 3))
    hyper = {"eps": torch.tensor([0.1, 0.05])}
    st0 = stack_runs([factory({"eps": 0.1}).init(p0[r]) for r in range(R)])
    res = ex.run(p0, st0, num_steps=24, key=rng.key(1), hyper=hyper, adapt_fn=adapt)
    assert seen == [(8, (R, 3), (R, 1)), (16, (R, 3), (R, 1))]
    assert res.moments.count.shape == (R,)


def test_async_grad_targets_through_executor():
    """Approach I: gradients at the stale worker snapshots, not the server
    params; the executor equals a per-step loop bitwise."""
    sampler = core.async_sghmc(step_size=1e-2, num_workers=K, sync_every=2)
    keys = rng.split(rng.key(1), STEPS)
    res = rollout(sampler, _grad, _start((2,)), num_steps=STEPS, keys=keys, chunk_steps=16)
    loop = core.async_sghmc(step_size=1e-2, num_workers=K, sync_every=2)
    params = _start((2,))
    state = loop.init(params)
    traj = []
    for t in range(STEPS):
        g = _grad(loop.grad_targets(state, params))
        upd, state = loop.update(g, state, params, keys[t])
        params = core.apply_updates(params, upd)
        traj.append(params.clone())
    assert torch.equal(res.trace, torch.stack(traj))
    # the targets are the snapshots: worker 0 last arrived at step 38 (s = 2)
    assert torch.equal(state.snapshots[1], params)
    assert not torch.equal(state.snapshots[0], params)


def test_swept_async_matches_members():
    R = 2
    keys = _seed_keys(R)
    mk = lambda: core.async_sghmc(step_size=1e-2, num_workers=3, sync_every=4)
    swept = rollout(mk(), _grad, _start((R, 2)), num_steps=STEPS, keys=keys, sweep=True)
    assert swept.state.snapshots.shape == (R, 3, 2)
    for r in range(R):
        member = rollout(mk(), _grad, _start((2,)), num_steps=STEPS, keys=keys[r])
        assert torch.equal(swept.trace[r], member.trace)


def test_swept_functional_states_land_in_the_stack():
    """A sampler that returns new state tensors (the EASGD family) has them
    copied into the stacked state."""
    R = 2
    p0 = torch.from_numpy(np.random.default_rng(5).normal(size=(R, 3, 2)).astype(np.float32))
    swept = rollout(core.ec_msgd(step_size=0.05, alpha=1.0, xi=0.1), _grad, p0.clone(),
                    num_steps=STEPS, keys=[[0] * STEPS] * R, chunk_steps=16, sweep=True)
    for r in range(R):
        member = rollout(core.ec_msgd(step_size=0.05, alpha=1.0, xi=0.1), _grad, p0[r].clone(),
                         num_steps=STEPS, keys=[0] * STEPS, chunk_steps=16)
        assert torch.equal(swept.trace[r], member.trace)
        assert torch.equal(swept.state.center_velocity[r], member.state.center_velocity)


def test_swept_misuse_raises():
    ex = ChainExecutor(sampler=_ec(), grad_fn=lambda t, _b: _grad(t), key_mode="keys")
    p0 = _start((2, K, 2))
    st0 = stack_runs([_ec().init(p0[r]) for r in range(2)])
    with pytest.raises(ValueError):  # one key sequence for two runs
        ex.run(p0, st0, num_steps=4, keys=_seed_keys(1, 4), sweep=True)
    with pytest.raises(ValueError):  # an unswept state
        ex.run(p0, _ec().init(p0[0]), num_steps=4, keys=_seed_keys(2, 4), sweep=True)
    with pytest.raises(ValueError):  # a hyper value of the wrong length
        ChainExecutor(sampler_factory=lambda h: _ec(), grad_fn=lambda t, _b: t,
                      key_mode="fold").run(p0, st0, num_steps=4, key=1,
                                           hyper={"eps": torch.ones(3)})
    with pytest.raises(NotImplementedError):  # a host batch_fn (as the reference)
        ChainExecutor(sampler=_ec(), grad_fn=lambda t, _b: _grad(t), batch_fn=lambda t: None,
                      key_mode="fold").run(p0, st0, num_steps=4, key=1, sweep=True)
