"""Unfused scale-adapted EC-SGHMC of the port against the exact
frozen-preconditioner oracle, on the CPU: alpha in {0, 1} at s in {1, 8}
and, marked ``slow`` as the JAX cases are, s = 4 (the cases of
``tests/test_stationary.py:520-560``).  The harness and its 3-sigma bands
are those of ``test_torch_adaptive_stationary.py``."""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_adaptive_stationary import assert_matches_diag_oracle, sa_ec_case


@pytest.mark.parametrize("s", [1, 8])
def test_alpha0_is_independent_preconditioned_sghmc(s):
    traj, oracle = sa_ec_case(0.0, s)
    assert np.all(np.isfinite(oracle.theta_var))
    assert_matches_diag_oracle(traj, oracle, label=f"sa-ec-a0-s{s}")


@pytest.mark.parametrize("s", [1, 8])
def test_alpha1(s):
    traj, oracle = sa_ec_case(1.0, s)
    assert_matches_diag_oracle(traj, oracle, check_cross=True, label=f"sa-ec-a1-s{s}")


@pytest.mark.slow
def test_alpha1_s4():
    traj, oracle = sa_ec_case(1.0, 4)
    assert_matches_diag_oracle(traj, oracle, check_cross=True, label="sa-ec-a1-s4")


@pytest.mark.slow
def test_alpha0_s4():
    traj, oracle = sa_ec_case(0.0, 4)
    assert_matches_diag_oracle(traj, oracle, label="sa-ec-a0-s4")
