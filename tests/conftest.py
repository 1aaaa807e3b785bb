"""Test-suite bootstrap: make ``python -m pytest`` work from the repo root
without the ``PYTHONPATH=src`` incantation (which keeps working unchanged —
duplicate sys.path entries are harmless).

Multi-device harness (DESIGN.md §7): tests marked ``multidevice`` assume a
forced 8-CPU-device backend (``XLA_FLAGS=--xla_force_host_platform_device_
count=8``), which must be set BEFORE jax initializes — impossible to do
in-process once the suite has touched a device.  They therefore only run in
a child pytest launched with :func:`tests.util.multidevice_env` (the CI lane
does this, and ``tests/test_sharding.py`` carries a slow-marked relaunch
proxy so ``-m slow`` covers the suite from a plain session).  In a parent
session they auto-skip."""
from __future__ import annotations

import os
import pathlib
import sys

import pytest

_SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

MULTIDEVICE_CHILD_ENV = "REPRO_MULTIDEVICE_CHILD"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running stationary-battery configs (opt-in via -m slow; "
        "scripts/ci.sh deselects them by default)",
    )
    config.addinivalue_line(
        "markers",
        "multidevice: needs a forced multi-CPU-device jax backend; runs only "
        "in a child pytest launched via tests.util.run_multidevice_suite "
        f"(which sets {MULTIDEVICE_CHILD_ENV}=1), auto-skips otherwise",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc (the PyTorch port's hand-written "
        "kernels); skips without one",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get(MULTIDEVICE_CHILD_ENV) == "1":
        return
    skip = pytest.mark.skip(
        reason="multidevice suite runs in a forced-device child pytest "
        "(scripts/ci.sh multidevice lane, or the slow relaunch proxy in "
        "tests/test_sharding.py)"
    )
    for item in items:
        if "multidevice" in item.keywords:
            item.add_marker(skip)
