"""The dry-run cells executed on real ranks: 4 gloo ranks of real CPU
tensors, spawned by ``launch.mesh.spawn_local`` (rank functions in
``torch_dryrun_workers.py``).

* The qwen3 and recurrentgemma SMOKE train cells on a (chain 1, data 2,
  model 2) mesh (``make_train_mesh(1, size=2)``, K = 2 chains at the
  syncing step) equal the plain unsharded step within ``torch_parity``'s
  rule, the sampler's noise handed in through ``make_train_step(noise_fn=)``
  (a sharded draw need not equal an unsharded one); every rank ends with
  the same tensors.
* Their decode cells on a (data 2, model 2) mesh give the plain step's
  tokens, and caches within the same rule.
"""
from __future__ import annotations

import numpy as np
import pytest

import torch_dryrun_workers as W
import torch_parity
from repro_torch.launch.mesh import spawn_local


def _check_close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _check_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _check_close(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        torch_parity.assert_close(got, want, what=what)
    else:
        assert got == want, what


ARCHS = ("qwen3-0.6b", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def gloo_runs():
    """{(arch, kind): [rank results]}, all from one spawn of 4 ranks."""
    ranks = spawn_local(W.cells_rank, 4, ARCHS, timeout_s=600)
    return {key: [r[key] for r in ranks] for key in ranks[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_on_4_ranks_matches_plain_step(arch, gloo_runs):
    res = gloo_runs[(arch, "train")]
    plain = res[0].pop("plain")
    _check_close(res[0], plain, arch)
    for r in res[1:]:
        _check_close(r, res[0], f"{arch} rank agreement")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_on_4_ranks_gives_plain_tokens(arch, gloo_runs):
    res = gloo_runs[(arch, "decode")]
    plain = res[0].pop("plain")
    np.testing.assert_array_equal(res[0]["tokens"], plain["tokens"])
    _check_close(res[0]["cache"], plain["cache"], arch)
    for r in res[1:]:
        np.testing.assert_array_equal(r["tokens"], res[0]["tokens"])
