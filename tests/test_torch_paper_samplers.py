"""The port's other samplers against the reference's, on the CPU: the naive
Async SGHMC baseline, EC-SGLD, the EASGD family and the complete recipe.

Async SGHMC and EC-SGLD run step for step from the same state on both
sides, with the reference's normal draws handed to the port through
``update(..., noise=...)``; params, momenta, snapshots and center trees
agree at atol 2e-6 (the reference suite's kernel tolerance: the two
frameworks round a few ops differently), and EC-SGLD's stats at rtol
1e-5.  The EASGD family is deterministic and agrees at the same
tolerance.  The recipe's D/Q matrices equal the reference's exactly, and
its trajectories agree at atol 1e-5 given the reference's noise.  Async
SGHMC passes the exact ``async_sghmc_stationary`` oracle at 3 sigma with
the battery's step counts (``tests/test_stationary.py``), and the
behaviour tests of ``tests/test_core_samplers.py``, ``tests/test_easgd.py``
and ``tests/test_recipe.py`` are mirrored on the port.
"""
from __future__ import annotations

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import diagnostics as jdiag
from repro.core import recipe as jrecipe
from repro.core import tree_util as jtu
from repro_torch import _interop, core
from repro_torch.core import recipe, rng
from repro_torch.run import rollout
from test_torch_stationary import assert_matches_oracle

ATOL = 2e-6
MU, LAM = 1.5, 1.0


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_close(a, b, atol=ATOL, what=""):
    la, lb = core.tree_util.tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_np(x), np.asarray(y), atol=atol, rtol=0, err_msg=what)


def _tree(seed, lead=()):
    r = np.random.default_rng(seed)
    return {"a": (MU + r.normal(size=lead + (3, 5))).astype(np.float32),
            "b": {"w": (MU + r.normal(size=lead + (7,))).astype(np.float32)}}


def _pair(tree):
    return jax.tree.map(jnp.asarray, tree), _interop.tree_from_numpy(tree)


def _to_torch(jtree):
    return _interop.tree_from_numpy(jax.tree.map(np.asarray, jtree))


# worker k's gradient carries an offset of its own, so that the mean over
# the arrived workers depends on which ones arrived
def _grad_j(t):
    off = jnp.arange(t.shape[0], dtype=jnp.float32).reshape((-1,) + (1,) * (t.ndim - 1))
    return LAM * (t - MU) + 0.1 * off


def _grad_t(t):
    off = torch.arange(t.shape[0], dtype=torch.float32).view((-1,) + (1,) * (t.ndim - 1))
    return LAM * (t - MU) + 0.1 * off


# --- Async SGHMC ---------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("K", [1, 3])
def test_async_sghmc_matches_reference(K, s):
    """Step for step with the reference's normals; K=1 at s in {2, 4} and
    K=3 at s=4 include steps where no worker arrives (the idle server)."""
    kw = dict(step_size=0.05, num_workers=K, friction=1.3, mass=2.0, sync_every=s)
    jsamp, tsamp = jcore.async_sghmc(**kw), core.async_sghmc(**kw)
    jparams, params = _pair(_tree(3))
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    _assert_tree_close(state.snapshots, jstate.snapshots, atol=0.0, what="init snapshots")
    idle = 0
    for t in range(9):
        kt = jax.random.PRNGKey(40 + t)
        noise = _to_torch(jtu.tree_random_normal(kt, jstate.momentum, jnp.float32))
        jg = jax.tree.map(_grad_j, jsamp.grad_targets(jstate, jparams))
        g = core.tree_util.tree_map(_grad_t, tsamp.grad_targets(state, params))
        jup, jstate = jsamp.update(jg, jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        idle += not any(t % s == k % s for k in range(K))
        up, state = tsamp.update(g, state, params, None, noise=noise)
        params = core.apply_updates(params, up)
        for name in ("momentum", "snapshots"):
            _assert_tree_close(getattr(state, name), getattr(jstate, name),
                               what=f"step {t} {name}")
        _assert_tree_close(params, jparams, what=f"step {t} params")
        assert state.step == int(jstate.step)
    assert (idle > 0) == (s > K)


def test_async_idle_server_is_the_identity():
    a = core.async_sghmc(step_size=0.1, num_workers=1, sync_every=3)
    params = torch.full((4,), 2.0)
    state = a.init(params)
    g = a.grad_targets(state, params) - MU
    _, state = a.update(g, state, params, rng.key(0))  # step 0: worker 0 arrives
    p_before = state.momentum.clone()
    up, state = a.update(g, state, params, rng.key(1))  # step 1: nobody arrives
    assert torch.equal(up, torch.zeros_like(up)) and torch.equal(state.momentum, p_before)
    assert state.step == 2


def test_async_s1_k1_equals_sghmc():
    """One worker syncing every step == plain SGHMC (temperature 0)."""
    a = core.async_sghmc(step_size=2e-2, num_workers=1, sync_every=1, temperature=0.0)
    s = core.sghmc(step_size=2e-2, temperature=0.0)
    keys = rng.split(rng.key(0), 100)
    t_a = rollout(a, lambda t: t, torch.tensor([3.0, -2.0]), num_steps=100, keys=keys).trace
    t_s = rollout(s, lambda t: t, torch.tensor([3.0, -2.0]), num_steps=100, keys=keys).trace
    np.testing.assert_allclose(t_a.numpy(), t_s.numpy(), atol=1e-6)


def test_async_staleness_of_snapshots():
    """Snapshots refresh only on each worker's phase step."""
    K, s = 4, 2
    a = core.async_sghmc(step_size=1e-2, num_workers=K, sync_every=s)
    params = torch.ones(3)
    st = a.init(params)
    for t in range(6):
        prev = st.snapshots.clone()
        g = a.grad_targets(st, params) - 0.0
        upd, st = a.update(g, st, params, rng.key(t))
        params = core.apply_updates(params, upd)
        for k in range(K):
            if t % s == k % s:  # arrived: snapshot == post-update params
                np.testing.assert_allclose(st.snapshots[k].numpy(), params.numpy(), atol=1e-7)
            else:
                assert torch.equal(st.snapshots[k], prev[k])


@pytest.mark.parametrize("s", [1, 4])
def test_async_sghmc_stationary_oracle(s):
    """The battery's case (tests/test_stationary.py): K=4 workers, D=2,
    40k steps, burn-in 4k, against the delay-augmented exact oracle."""
    sampler = core.async_sghmc(step_size=0.1, num_workers=4, friction=1.0, sync_every=s)
    steps = 40_000
    res = rollout(sampler, lambda th: LAM * (th - MU), torch.full((2,), MU + 1.0),
                  num_steps=steps, keys=rng.split(rng.key(3 + s), steps), chunk_steps=8192)
    traj = res.trace.numpy()[4_000:][None]  # (1, T, D)
    oracle = jdiag.async_sghmc_stationary(step_size=0.1, friction=1.0, sync_every=s,
                                          precision=LAM, mu=MU)
    assert_matches_oracle(traj, oracle, label=f"async-s{s}")


def test_chip_smoke_async_oracle_constants_are_the_oracle():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    case = smoke.ASYNC_STATIONARY_CASE
    assert sorted(smoke.ASYNC_ORACLE_VAR) == [1, 4]
    for s, var in smoke.ASYNC_ORACLE_VAR.items():
        oracle = jdiag.async_sghmc_stationary(step_size=case["eps"], friction=case["friction"],
                                              sync_every=s, precision=case["lam"], mu=case["mu"])
        assert oracle.theta_mean == case["mu"]
        assert var == pytest.approx(oracle.theta_var, rel=1e-12)


# --- EC-SGLD -------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("alpha", [0.0, 0.7])
def test_ec_sgld_matches_reference(alpha, s):
    kw = dict(step_size=0.05, alpha=alpha, center_friction=1.2, mass=1.5, sync_every=s)
    jsamp, tsamp = jcore.ec_sgld(**kw), core.ec_sgld(**kw)
    jparams, params = _pair(_tree(5, lead=(4,)))
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    for t in range(7):
        kt = jax.random.PRNGKey(60 + t)
        k_t, k_r = jax.random.split(kt)
        jg = jax.tree.map(lambda x: LAM * (x - MU), jparams)
        g = core.tree_util.tree_map(lambda x: LAM * (x - MU), params)
        noise = {"theta": _to_torch(jtu.tree_random_normal(k_t, jg, jnp.float32)),
                 "r": _to_torch(jtu.tree_random_normal(k_r, jstate.center_momentum,
                                                       jnp.float32))}
        jup, jstate = jsamp.update(jg, jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        up, state = tsamp.update(g, state, params, None, noise=noise)
        params = core.apply_updates(params, up)
        for name in ("center", "center_momentum", "center_stale", "mean_theta_stale"):
            _assert_tree_close(getattr(state, name), getattr(jstate, name),
                               what=f"step {t} {name}")
        _assert_tree_close(params, jparams, what=f"step {t} params")
    jst, st = jsamp.stats(jstate, jparams), tsamp.stats(state, params)
    assert st["step"] == int(jst["step"])
    for k in ("center_momentum_norm", "chain_center_rms"):
        np.testing.assert_allclose(float(st[k]), float(jst[k]), rtol=1e-5, atol=1e-7)


def test_ec_sgld_draws_its_own_noise():
    samp = core.ec_sgld(step_size=0.05, alpha=1.0, sync_every=2)
    p0 = torch.full((3, 4), 2.0)
    a = rollout(samp, lambda t: t - MU, p0.clone(), num_steps=20, key=rng.key(1),
                key_mode="fold").trace
    b = rollout(samp, lambda t: t - MU, p0.clone(), num_steps=20, key=rng.key(1),
                key_mode="fold").trace
    c = rollout(samp, lambda t: t - MU, p0.clone(), num_steps=20, key=rng.key(2),
                key_mode="fold").trace
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("kw", [dict(chain_axis="chains"),
                                dict(chain_axis="chains", per_chain_noise=True)])
def test_ec_sgld_unported_options_raise(kw):
    """The chain-axis options are ported (tests/test_torch_sharding.py,
    tests/test_torch_distributed_samplers.py); outside the run_sharded
    that binds the axis name the update raises, as an unbound axis name
    does in JAX."""
    samp = core.ec_sgld(step_size=0.1, **kw)
    p = torch.zeros(4, 3)
    with pytest.raises(NameError, match="unbound axis name"):
        samp.update(torch.zeros(4, 3), samp.init(p), p, rng.key(0))


# --- the EASGD family -------------------------------------------------------------

EASGD_CASES = {
    "easgd-s1": lambda c: c.easgd(step_size=0.05, alpha=0.5),
    "easgd-s3": lambda c: c.easgd(step_size=0.05, alpha=0.5, sync_every=3),
    "eamsgd-s1": lambda c: c.eamsgd(step_size=0.02, alpha=0.8, xi=0.1),
    "eamsgd-s3": lambda c: c.eamsgd(step_size=0.02, alpha=0.8, xi=0.1, sync_every=3),
    "ec_msgd": lambda c: c.ec_msgd(step_size=0.02, alpha=1.3, xi=0.05),
}


@pytest.mark.parametrize("name", list(EASGD_CASES))
def test_easgd_family_matches_reference(name):
    jopt, opt = EASGD_CASES[name](jcore), EASGD_CASES[name](core)
    jparams, params = _pair(_tree(7, lead=(3,)))
    jstate, state = jopt.init(jparams), opt.init(params)
    for t in range(12):
        jg = jax.tree.map(lambda x: LAM * (x - MU), jparams)
        g = core.tree_util.tree_map(lambda x: LAM * (x - MU), params)
        jup, jstate = jopt.update(jg, jstate, jparams)
        jparams = jtu.apply_updates(jparams, jup)
        up, state = opt.update(g, state, params)
        params = core.apply_updates(params, up)
        _assert_tree_close(params, jparams, what=f"step {t} params")
        for field in state._fields[:-1]:
            _assert_tree_close(getattr(state, field), getattr(jstate, field),
                               what=f"step {t} {field}")
        assert state.step == int(jstate.step)


def _traj(sampler, p0, steps, seed=0):
    return rollout(sampler, lambda t: t - torch.tensor([1.0, -2.0, 0.5])[:t.shape[-1]],
                   p0.clone(), num_steps=steps, keys=rng.split(rng.key(seed), steps)).trace


def test_ec_msgd_is_deterministic_limit_of_ec_sghmc():
    """Paper §5 (tests/test_easgd.py): ec_msgd(step=eps^2, xi=eps*V) ==
    ec_sghmc(eps, V, C=V, temperature 0, s=1), on the port."""
    eps, V, alpha, K = 0.05, 0.8, 1.3, 4
    p0 = torch.from_numpy(np.random.default_rng(0).normal(size=(K, 3)).astype(np.float32))
    ec = core.ec_sghmc(step_size=eps, alpha=alpha, friction=V, center_friction=V, mass=1.0,
                       sync_every=1, temperature=0.0)
    msgd = core.ec_msgd(step_size=eps**2, alpha=alpha, xi=eps * V)
    np.testing.assert_allclose(_traj(ec, p0, 150).numpy(), _traj(msgd, p0, 150).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_eq9_vs_eq10_both_converge():
    p0 = torch.from_numpy(3 * np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32))
    final = {}
    for name, opt in [("eq9", core.ec_msgd(step_size=1e-3, alpha=1.0, xi=0.05)),
                      ("eq10", core.eamsgd(step_size=1e-3 / 0.05, alpha=1e-3, xi=0.05))]:
        traj = rollout(opt, lambda t: t, p0.clone(), num_steps=4000,
                       keys=[0] * 4000).trace
        final[name] = float(traj[-1].abs().mean())
    assert final["eq9"] < 0.15 and final["eq10"] < 0.35


def test_easgd_center_tracks_chains():
    opt = core.easgd(step_size=5e-2, alpha=0.5)
    params = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 2)).astype(np.float32)) + 4
    st = opt.init(params)
    for _ in range(800):
        upd, st = opt.update(params.clone(), st, params)
        params = core.apply_updates(params, upd)
    assert float(params.abs().max()) < 0.3 and float(st.center.abs().max()) < 0.3


def test_eamsgd_sync_period_drops_coupling():
    """Zhang et al.: the coupling terms only apply every s steps."""
    opt = core.eamsgd(step_size=1e-2, alpha=1.0, xi=0.0, sync_every=3)
    params = torch.tensor([[1.0, 1.0], [3.0, 3.0]])
    st = opt.init(params)
    moved = []
    for _ in range(6):
        upd, st = opt.update(torch.zeros_like(params), st, params)
        moved.append(float(upd.abs().max()) > 1e-12)
        params = core.apply_updates(params, upd)
    assert moved == [t % 3 == 0 for t in range(6)]


# --- the complete recipe -------------------------------------------------------------

RECIPES = {
    "sghmc": (lambda m, **kw: m.sghmc_recipe(lambda th: th, dim=3, friction=1.0, **kw)),
    "sghmc-heavy": (lambda m, **kw: m.sghmc_recipe(lambda th: th, dim=2, friction=1.7, mass=2.0,
                                                   **kw)),
    "ec_sghmc": (lambda m, **kw: m.ec_sghmc_recipe(lambda th: th, dim=2, num_chains=3, alpha=0.7,
                                                   **kw)),
    "ec_sghmc-cf": (lambda m, **kw: m.ec_sghmc_recipe(lambda th: th, dim=2, num_chains=2,
                                                      alpha=0.5, friction=0.8,
                                                      center_friction=1.4, **kw)),
}


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_matrices_match_reference(name):
    jr, tr = RECIPES[name](jrecipe), RECIPES[name](recipe, device="cpu")
    np.testing.assert_array_equal(tr.D.numpy(), np.asarray(jr.D))
    np.testing.assert_array_equal(tr.Q.numpy(), np.asarray(jr.Q))
    recipe.validate(tr)  # D PSD, Q skew-symmetric (Prop. 3.1)
    z = np.random.default_rng(4).normal(size=tr.D.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tr.grad_H(torch.from_numpy(z)).numpy(),
                               np.asarray(jr.grad_H(jnp.asarray(z))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("D,Q", [("eye", "eye"), ("neg", "zeros")], ids=["bad-q", "bad-d"])
def test_recipe_invalid_rejected(D, Q):
    mats = {"eye": torch.eye(2), "neg": -torch.eye(2), "zeros": torch.zeros(2, 2)}
    with pytest.raises(ValueError):
        recipe.validate(recipe.Recipe(lambda z: z, D=mats[D], Q=mats[Q]))


@pytest.mark.parametrize("name", ["sghmc", "ec_sghmc"])
def test_recipe_simulate_matches_reference(name):
    """50 Euler–Maruyama steps with the reference's normals."""
    jr, tr = RECIPES[name](jrecipe), RECIPES[name](recipe, device="cpu")
    m = tr.D.shape[0]
    key = jax.random.PRNGKey(8)
    jtraj = np.asarray(jrecipe.simulate(jr, jnp.full((m,), 0.5), 5e-2, 50, key))
    keys = jax.random.split(key, 50)
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (m,), jnp.float32))
                                       for k in keys]))
    traj = recipe.simulate(tr, torch.full((m,), 0.5), 5e-2, 50, noise=noise)
    np.testing.assert_allclose(traj.numpy(), jtraj, atol=1e-5, rtol=0)


def test_sghmc_recipe_targets_gaussian():
    r = recipe.sghmc_recipe(lambda th: th, dim=2, friction=1.0, device="cpu")
    traj = recipe.simulate(r, torch.zeros(4), eps=5e-2, num_steps=8000, rng=rng.key(0))
    theta = traj[2000:, :2].numpy()
    np.testing.assert_allclose(theta.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(theta.var(0), 1.0, atol=0.35)


def test_ec_recipe_marginal_mean():
    K, d = 3, 2
    r = recipe.ec_sghmc_recipe(lambda th: th, dim=d, num_chains=K, alpha=0.5, device="cpu")
    traj = recipe.simulate(r, torch.zeros(2 * (K + 1) * d), eps=5e-2, num_steps=6000,
                           rng=rng.key(1))
    thetas = traj[2000:, : K * d].numpy().reshape(-1, d)
    np.testing.assert_allclose(thetas.mean(0), 0.0, atol=0.2)


def test_gamma_zero_for_constant_dq():
    """For H = theta^2/2 + p^2/2: drift = [p, -theta - V p]."""
    r = recipe.sghmc_recipe(lambda th: th, dim=1, device="cpu")
    z = torch.tensor([0.3, -0.7])
    drift = -(r.D + r.Q) @ r.grad_H(z)
    np.testing.assert_allclose(drift.numpy(), [z[1], -z[0] - z[1]], rtol=1e-6)
