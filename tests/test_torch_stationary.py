"""The port's EC-SGHMC against the exact stationary oracle, on the CPU.

The non-slow cases of ``tests/test_stationary.py`` (alpha 0 and 1 at
s = 1 and 8, and fused alpha 1 at s = 1) run through the port's
``rollout`` with its own noise (torch generators; the fused case through
the kernel's plain version with Philox bits), on the Gaussian target
U = (lam/2)||theta - mu||^2, at the battery's step counts and burn-in.
Their pooled moments are gated against ``repro.diagnostics``' closed-form
oracle for the discrete-time recursion with the battery's 3-sigma bands,
sized from the conservative coupled-chain ESS.

The oracle's numbers that ``chip_smoke.py`` carries for its on-card case
are pinned here to the oracle itself.
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
LAM = 1.0
D = 2
K = 4
EC_KW = dict(friction=1.0, center_friction=1.0, noise_convention="eq6", center_noise_in_p=False)


def run_chains(sampler, steps, burn, seed):
    """(K, T, D) trajectory after burn-in, with the in-carry Welford moments
    cross-checked against the trajectory."""
    params0 = torch.full((K, D), MU + 1.0)
    keys = rng.split(rng.key(seed), steps)
    res = rollout(sampler, lambda th: LAM * (th - MU), params0, num_steps=steps, keys=keys,
                  moments=True, chunk_steps=8192)
    traj = res.trace.numpy()
    np.testing.assert_allclose(diag.welford_mean(res.moments).numpy(), traj.mean(axis=0),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(diag.welford_var(res.moments).numpy(), traj.var(axis=0),
                               rtol=2e-3, atol=2e-4)
    return np.moveaxis(traj[burn:], 1, 0)


def assert_matches_oracle(traj, oracle, *, check_cross=False, label=""):
    emp_mean, emp_var = diag.pooled_moments(traj)
    ess = float(np.sum(diag.coupled_ess_nd(traj)))
    mean_tol = 3.0 * np.sqrt(oracle.theta_var / ess) + 1e-4
    assert abs(emp_mean.mean() - oracle.theta_mean) < mean_tol, (
        f"{label}: mean {emp_mean.mean():.5f} vs oracle {oracle.theta_mean} (tol {mean_tol:.5f})")
    var_tol = jdiag.monte_carlo_tolerance(oracle.theta_var, ess) + 1e-6
    assert abs(emp_var.mean() - oracle.theta_var) < var_tol, (
        f"{label}: var {emp_var.mean():.6f} vs oracle {oracle.theta_var:.6f} (tol {var_tol:.6f})")
    if check_cross:
        pairs = [np.mean((traj[i] - emp_mean) * (traj[j] - emp_mean))
                 for i in range(K) for j in range(i + 1, K)]
        cross_tol = 3.0 * np.sqrt((oracle.theta_var**2 + oracle.theta_cross_cov**2)
                                  / max(ess, 4.0)) + 1e-6
        assert abs(float(np.mean(pairs)) - oracle.theta_cross_cov) < cross_tol, label
    rhat = float(np.max(diag.split_rhat_nd(traj)))
    assert rhat < 1.05, f"{label}: split-Rhat {rhat:.3f}"


def _ec_case(alpha, s, *, fused=False, steps=40_000):
    eps = 0.1
    sampler = core.ec_sghmc(step_size=eps, alpha=alpha, sync_every=s, fused=fused, **EC_KW)
    seed = int(17 * alpha + s + 100 * fused)
    traj = run_chains(sampler, steps=steps, burn=4_000, seed=seed)
    oracle = jdiag.ec_sghmc_stationary(step_size=eps, alpha=alpha, num_chains=K, sync_every=s,
                                       precision=LAM, mu=MU, **EC_KW)
    return traj, oracle


@pytest.mark.parametrize("s", [1, 8])
def test_alpha0_recovers_independent_sghmc(s):
    traj, oracle = _ec_case(0.0, s)
    sg = jdiag.sghmc_stationary(step_size=0.1, friction=1.0, noise_convention="eq6",
                                precision=LAM, mu=MU)
    assert oracle.theta_var == pytest.approx(sg.theta_var, rel=1e-12)
    assert_matches_oracle(traj, oracle, label=f"ec-a0-s{s}")


@pytest.mark.parametrize("s", [1, 8])
def test_alpha1(s):
    traj, oracle = _ec_case(1.0, s)
    assert_matches_oracle(traj, oracle, check_cross=True, label=f"ec-a1-s{s}")


def test_alpha1_s1_fused():
    traj, oracle = _ec_case(1.0, 1, fused=True, steps=30_000)
    assert_matches_oracle(traj, oracle, check_cross=True, label="ec-fused-a1-s1")


def test_chip_smoke_oracle_constants_are_the_oracle():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    case = smoke.STATIONARY_CASE
    oracle = jdiag.ec_sghmc_stationary(
        step_size=case["eps"], alpha=case["alpha"], num_chains=case["K"],
        sync_every=case["s"], precision=case["lam"], mu=case["mu"], **case["ec_kw"])
    assert case["ec_kw"] == EC_KW
    assert smoke.ORACLE_MEAN == pytest.approx(oracle.theta_mean, rel=1e-12)
    assert smoke.ORACLE_VAR == pytest.approx(oracle.theta_var, rel=1e-12)
    assert smoke.ORACLE_CROSS_COV == pytest.approx(oracle.theta_cross_cov, rel=1e-12)
