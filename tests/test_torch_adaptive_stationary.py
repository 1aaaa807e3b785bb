"""The port's adaptive samplers against the exact frozen-preconditioner
oracle, on the CPU: the single-chain samplers and fused scale-adapted
EC-SGHMC (the unfused coupled cases are in
``test_torch_adaptive_stationary_ec.py``).

The cases of ``tests/test_stationary.py:405-600`` run through the port's
``rollout`` with its own noise (torch generators; the fused case through
the preconditioned kernel's plain version with Philox bits), on the
diagonal Gaussian target N(mu, diag(4, 0.25)^-1), at the battery's step
counts, burn-in and seeds' roles.  Adaptation runs for 2000 steps and then
freezes; the frozen M⁻¹ is read back from the final state and fed to the
oracle of ``repro.diagnostics``.  Bands are the battery's 3-sigma bands
from the conservative ESS, and the long cases are marked ``slow`` as the
JAX cases are.

The oracle numbers that ``chip_smoke.py`` carries for its on-card
preconditioned case are pinned here to the oracle itself.
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro import diagnostics as jdiag
from repro_torch import core
from repro_torch import diagnostics as diag
from repro_torch.core import rng
from repro_torch.run import rollout

MU = 1.5
D = 2
K = 4
PREC_DIAG = np.array([4.0, 0.25])  # per-dim precisions; cond(Σ) = 16
SA_BURNIN = 2_000
SA_EC_KW = dict(friction=1.0, center_friction=1.0, noise_convention="eq4",
                center_noise_in_p=False)


def run_chains_prec(sampler, shape, steps, burn, seed):
    """(K, T, D) trajectory after burn-in on N(MU, diag(PREC_DIAG)^-1), and
    the final sampler state."""
    params0 = torch.full(shape, MU + 1.0)
    p = torch.tensor(PREC_DIAG, dtype=torch.float32)
    res = rollout(sampler, lambda th: p * (th - MU), params0, num_steps=steps,
                  keys=rng.split(rng.key(seed), steps), moments=False, chunk_steps=8192)
    traj = res.trace.numpy()[burn:]
    traj = traj[None] if traj.ndim == 2 else np.moveaxis(traj, 1, 0)
    return traj, res.state


def frozen_minv_of(precond_state, pre):
    """The frozen M⁻¹ a post-burn-in step used: one more preconditioner
    update on the frozen state changes nothing and returns it exactly."""
    assert precond_state.step >= SA_BURNIN
    minv, after = pre.update(precond_state, torch.zeros_like(precond_state.v))
    assert torch.equal(after.v, precond_state.v)
    return minv.numpy().astype(np.float64)


def assert_matches_elementwise(traj, oracle, *, label=""):
    """Per-(chain, dim) gate for independent scalar recursions with distinct
    frozen masses; 3-sigma Monte-Carlo bands per series."""
    k, _, d = traj.shape
    want_var = np.asarray(oracle.theta_var).reshape(k, d)
    want_mean = np.asarray(oracle.theta_mean).reshape(k, d)
    for i in range(k):
        for j in range(d):
            x = traj[i, :, j].astype(np.float64)
            ess = diag.effective_sample_size(x)
            vtol = jdiag.monte_carlo_tolerance(want_var[i, j], ess) + 1e-6
            assert abs(float(x.var()) - want_var[i, j]) < vtol, (
                f"{label}[{i},{j}]: var {x.var():.6f} vs oracle {want_var[i, j]:.6f} "
                f"(tol {vtol:.6f}, ess {ess:.0f})")
            mtol = 3.0 * np.sqrt(want_var[i, j] / max(ess, 4.0)) + 1e-4
            assert abs(float(x.mean()) - want_mean[i, j]) < mtol, (
                f"{label}[{i},{j}]: mean {x.mean():.5f} vs {want_mean[i, j]} (tol {mtol:.5f})")
    rhat = float(np.max([diag.split_rhat(traj[i, :, j]) for i in range(k) for j in range(d)]))
    assert rhat < 1.05, f"{label}: split-Rhat {rhat:.3f}"


def assert_matches_diag_oracle(traj, oracle, *, check_cross=False, label=""):
    """Per-dim gate for the coupled adaptive sampler: oracle moments are
    chain-averaged per dimension; conservative coupled-chain ESS per dim."""
    k, _, d = traj.shape
    ess_nd = np.maximum(np.asarray(diag.coupled_ess_nd(traj)), 4.0)
    for j in range(d):
        x = traj[:, :, j].astype(np.float64)
        want_var = float(oracle.theta_var[j])
        emp_var = float(((x - x.mean()) ** 2).mean())
        vtol = jdiag.monte_carlo_tolerance(want_var, ess_nd[j]) + 1e-6
        assert abs(emp_var - want_var) < vtol, (
            f"{label}[dim{j}]: var {emp_var:.6f} vs oracle {want_var:.6f} "
            f"(tol {vtol:.6f}, ess {ess_nd[j]:.0f})")
        mtol = 3.0 * np.sqrt(want_var / ess_nd[j]) + 1e-4
        assert abs(float(x.mean()) - float(oracle.theta_mean[j])) < mtol, (
            f"{label}[dim{j}]: mean {x.mean():.5f} vs {oracle.theta_mean[j]}")
        if check_cross and k > 1:
            mu_j = float(oracle.theta_mean[j])
            emp_cross = float(np.mean([np.mean((x[i] - mu_j) * (x[l] - mu_j))
                                       for i in range(k) for l in range(i + 1, k)]))
            want_cross = float(oracle.theta_cross_cov[j])
            ctol = 3.0 * np.sqrt((want_var**2 + want_cross**2) / ess_nd[j]) + 1e-6
            assert abs(emp_cross - want_cross) < ctol, (
                f"{label}[dim{j}]: cross {emp_cross:.6f} vs {want_cross:.6f} (tol {ctol:.6f})")
    rhat = float(np.max(diag.split_rhat_nd(traj)))
    assert rhat < 1.05, f"{label}: split-Rhat {rhat:.3f}"


def sa_ec_case(alpha, s, *, fused=False, steps=30_000):
    eps = 0.1
    sampler = core.scale_adapted_ec_sghmc(step_size=eps, alpha=alpha, sync_every=s, fused=fused,
                                          burnin=SA_BURNIN, decay=0.99, **SA_EC_KW)
    seed = int(31 + 17 * alpha + s + 100 * fused)
    traj, st = run_chains_prec(sampler, (K, D), steps=steps, burn=4_000, seed=seed)
    minv = frozen_minv_of(st.precond, core.rmsprop_preconditioner(decay=0.99, eps=1e-8,
                                                                  burnin=SA_BURNIN))
    oracle = jdiag.preconditioned_ec_sghmc_stationary(
        step_size=eps, alpha=alpha, num_chains=K, mass_inv=minv, sync_every=s,
        precision=PREC_DIAG, mu=MU, **SA_EC_KW)
    return traj, oracle


def test_sa_sghmc_frozen_oracle_elementwise():
    eps = 0.1
    s = core.scale_adapted_sghmc(step_size=eps, friction=1.0, burnin=SA_BURNIN, decay=0.99)
    traj, st = run_chains_prec(s, (4, D), steps=30_000, burn=4_000, seed=21)
    minv = frozen_minv_of(st.precond, core.rmsprop_preconditioner(decay=0.99, eps=1e-8,
                                                                  burnin=SA_BURNIN))
    assert np.all(minv[:, 0] < 0.8 * minv[:, 1]), minv  # the stiff dim got the smaller M⁻¹
    oracle = jdiag.preconditioned_sghmc_stationary(
        step_size=eps, mass_inv=minv.reshape(-1), friction=1.0, noise_convention="eq4",
        precision=np.broadcast_to(PREC_DIAG, (4, D)).reshape(-1), mu=MU)
    assert_matches_elementwise(traj, oracle, label="sa-sghmc")


def test_psgld_frozen_oracle_elementwise():
    eps = 0.05
    s = core.preconditioned_sgld(step_size=eps, burnin=SA_BURNIN, decay=0.99)
    traj, st = run_chains_prec(s, (4, D), steps=30_000, burn=4_000, seed=23)
    minv = frozen_minv_of(st.precond, core.rmsprop_preconditioner(decay=0.99, eps=1e-8,
                                                                  burnin=SA_BURNIN))
    assert np.all(minv[:, 0] < 0.8 * minv[:, 1]), minv
    oracle = jdiag.preconditioned_sgld_stationary(
        step_size=eps, mass_inv=minv.reshape(-1),
        precision=np.broadcast_to(PREC_DIAG, (4, D)).reshape(-1), mu=MU)
    assert_matches_elementwise(traj, oracle, label="psgld")


@pytest.mark.slow
def test_psgld_adam_frozen_oracle_elementwise():
    eps = 0.05
    s = core.preconditioned_sgld(step_size=eps, burnin=SA_BURNIN, decay=0.999, precond="adam")
    traj, st = run_chains_prec(s, (4, D), steps=34_000, burn=6_000, seed=29)
    minv = frozen_minv_of(st.precond, core.adam_preconditioner(beta2=0.999, eps=1e-8,
                                                               burnin=SA_BURNIN))
    oracle = jdiag.preconditioned_sgld_stationary(
        step_size=eps, mass_inv=minv.reshape(-1),
        precision=np.broadcast_to(PREC_DIAG, (4, D)).reshape(-1), mu=MU)
    assert_matches_elementwise(traj, oracle, label="psgld-adam")


def test_sa_ec_alpha1_s1_fused():
    traj, oracle = sa_ec_case(1.0, 1, fused=True)
    assert_matches_diag_oracle(traj, oracle, check_cross=True, label="sa-ec-fused-a1-s1")


@pytest.mark.slow
def test_sa_ec_alpha1_s8_fused():
    traj, oracle = sa_ec_case(1.0, 8, fused=True)
    assert_matches_diag_oracle(traj, oracle, check_cross=True, label="sa-ec-fused-a1-s8")


def test_chip_smoke_precond_oracle_constants_are_the_oracle():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    case = smoke.PRECOND_CASE
    # the frozen M⁻¹ the sampler forms from V̂ (burnin 0: V̂ never moves)
    pre = core.rmsprop_preconditioner(decay=case["decay"], eps=case["precond_eps"], burnin=0)
    v = torch.tensor(case["v_hat"], dtype=torch.float32)
    minv = pre.update_leaf(v.clone(), torch.zeros_like(v), 0)[0].numpy().astype(np.float64)
    np.testing.assert_array_equal(minv, np.asarray(case["minv"]))
    oracle = jdiag.preconditioned_ec_sghmc_stationary(
        step_size=case["eps"], alpha=case["alpha"], num_chains=case["K"],
        mass_inv=np.broadcast_to(minv, (case["K"], minv.size)), sync_every=case["s"],
        precision=np.asarray(case["lam"]), mu=case["mu"], **case["ec_kw"])
    np.testing.assert_allclose(smoke.PRECOND_ORACLE_MEAN, oracle.theta_mean, rtol=1e-12)
    np.testing.assert_allclose(smoke.PRECOND_ORACLE_VAR, oracle.theta_var, rtol=1e-12)
    np.testing.assert_allclose(smoke.PRECOND_ORACLE_CROSS_COV, oracle.theta_cross_cov,
                               rtol=1e-12)
