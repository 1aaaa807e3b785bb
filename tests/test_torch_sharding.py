"""The port's chains across ranks on the CPU: ``ChainExecutor.run_sharded``
over gloo process groups of W = 1, 2 and 4 ranks, K = 4 chains.

The mirror of the reference's ``multidevice`` layout-invariance suite
(``tests/test_sharding.py:169-296``) and of its lowered-program collective
checks (``tests/test_executor.py:413-570``), which read the one collective
per sync from the collective counter here, since eager torch has no
lowered program.  The ranks are spawned once per world size for the whole
module (``torch_shard_workers.sharding_checks``) and every test reads
their output:

* alpha 0: no cross-chain term feeds back, so each chain is bit for bit
  the unsharded ``run``'s, at every W, unfused with per-chain noise and
  fused in Philox mode (the plain version's bits from the global element
  index: the kernel's ``chain_offset``);
* alpha 1: within the reference's float tolerance across W, and bit for bit
  at W = 1 (the all-reduce over one rank is exact);
* the replicated center state is bit-identical on every rank;
* exactly one all-reduce (raw) or one all-gather (int8) per sync, none
  between;
* a mesh without the chain axis, and K not divisible by W, are refused;
* the compressed exchange stays coupled and near the raw run.

These tests run in the plain pytest run: they are not marked
``multidevice``, which ``tests/conftest.py`` skips there.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_shard_workers as w
from repro_torch import core
from repro_torch.core import rng
from repro_torch.launch.mesh import spawn_local
from repro_torch.run import ChainExecutor

WORLDS = (1, 2, 4)
STATE = ("center", "center_momentum", "center_stale", "mean_theta_stale")


@pytest.fixture(scope="module")
def ranks():
    """{W: [rank outputs]} for every world size."""
    return {W: spawn_local(w.sharding_checks, W, timeout_s=240) for W in WORLDS}


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["unfused_a0", "fused_a0"])
@pytest.mark.parametrize("world", WORLDS)
def test_alpha0_bit_identical_to_unsharded_run(ranks, case, world):
    want = ranks[1][0]["unsharded"][case]["params"]
    for out in ranks[world]:
        assert _equal(out["cases"][case]["params"], want), (case, world, out["rank"])


@pytest.mark.parametrize("case", ["unfused_a1", "fused_a1"])
def test_alpha1_within_tolerance_across_worlds(ranks, case):
    base = ranks[1][0]["cases"][case]
    # over one rank the mean over ranks is exact: the unsharded run bit for bit
    assert _equal(base["params"], ranks[1][0]["unsharded"][case]["params"])
    for world in (2, 4):
        got = ranks[world][0]["cases"][case]
        for a, b in zip(got["params"], base["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"W={world}")
        for a, b in zip(got["state"]["center"], base["state"]["center"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"W={world}")


@pytest.mark.parametrize("world", (2, 4))
def test_replicated_center_bit_identical_across_ranks(ranks, world):
    for case in w.CASES:
        first = ranks[world][0]["cases"][case]["state"]
        for out in ranks[world][1:]:
            for name in STATE:
                assert _equal(out["cases"][case]["state"][name], first[name]), (case, name)


@pytest.mark.parametrize("world", WORLDS)
def test_one_collective_per_sync(ranks, world):
    syncs = w.STEPS // w.SYNC
    for case in w.CASES:
        counts = ranks[world][0]["cases"][case]["counts"]
        op, other = ("all_gather", "all_reduce") if case == "int8_a1" else ("all_reduce",
                                                                            "all_gather")
        assert counts[op]["calls"] == syncs and counts[other]["calls"] == 0, (case, counts)


def test_none_between_syncs(ranks):
    """Single-step runs over two sync periods at W = 2: the collective
    comes on the steps that end a period and on no other."""
    for case, op in (("unfused_a1", "all_reduce"), ("int8_a1", "all_gather")):
        per_step = ranks[2][0]["per_step"][case]
        calls = [c[op]["calls"] for c in per_step]
        assert calls == [int((t + 1) % w.SYNC == 0) for t in range(len(calls))], (case, calls)
        assert all(c[o]["calls"] == 0 for c in per_step for o in c if o != op), case


def test_wire_bytes_per_sync(ranks):
    """The raw exchange moves the f32 means, the compressed one their
    packed int8 encoding (``sync_wire_bytes`` per leaf)."""
    from repro_torch.distributed import packed_nbytes

    sizes = [15, 7]
    counts = ranks[2][0]["cases"]
    syncs = w.STEPS // w.SYNC
    assert counts["unfused_a1"]["counts"]["all_reduce"]["bytes"] == syncs * 4 * sum(sizes)
    assert counts["int8_a1"]["counts"]["all_gather"]["bytes"] == syncs * sum(
        packed_nbytes(n) for n in sizes)


def test_mesh_without_axis_or_indivisible_rejected(ranks):
    rejected = ranks[2][0]["rejected"]
    assert "no 'chain' axis" in rejected["axis"]
    assert "divisible" in rejected["divisible"]


def test_compressed_run_stays_coupled(ranks):
    """2048 steps on N((2, -1), I) over 4 ranks: the int8 exchange keeps
    the chains coupled around the target, near the raw exchange's run."""
    coupled = ranks[4][0]["coupled"]
    for name, out in coupled.items():
        assert np.all(np.isfinite(out["params"])), name
        np.testing.assert_allclose(out["mean"], [2.0, -1.0], atol=0.5, err_msg=name)
        assert float(np.abs(out["params"] - out["params"].mean(0)).mean()) < 3.0, name
    np.testing.assert_allclose(coupled["int8"]["mean"], coupled["raw"]["mean"], atol=0.05)
    assert coupled["int8"]["counts"]["all_gather"]["calls"] == 2048 // w.SYNC


def test_int8_exchange_at_one_rank_is_the_single_program_quantization(ranks):
    """Over one rank the packed all-gather decodes the one local mean: the
    unsharded sampler's quantized mean, bit for bit."""
    out = ranks[1][0]
    assert _equal(out["cases"]["int8_a1"]["params"], out["unsharded"]["int8_a1"]["params"])
    for name in STATE:
        assert _equal(out["cases"]["int8_a1"]["state"][name],
                      out["unsharded"]["int8_a1"]["state"][name]), name


def test_per_chain_noise_depends_on_the_global_chain_index_only():
    target = w.params0()
    full = core.tree_util.tree_random_normal_per_chain(rng.key(4), target)
    part = core.tree_util.tree_random_normal_per_chain(
        rng.key(4), core.tree_util.tree_map(lambda x: x[2:], target), offset=2)
    for a, b in zip(core.tree_util.tree_leaves(part), core.tree_util.tree_leaves(full)):
        assert torch.equal(a, b[2:])


def test_chain_axis_sampler_outside_run_sharded_raises():
    """As an unbound axis name does in JAX: the sampler needs the binding
    that run_sharded makes."""
    samp = w.sampler("unfused_a1", "chain")
    p = w.params0()
    st = samp.init(p)
    with pytest.raises(NameError, match="unbound axis name"):
        samp.update(core.tree_util.tree_map(torch.zeros_like, p), st, p, rng.key(0))


def test_lower_sharded_points_to_the_counter():
    ex = ChainExecutor(sampler=w.sampler("unfused_a1", "chain"), grad_fn=lambda t, b: t,
                       key_mode="fold")
    with pytest.raises(NotImplementedError, match="collective_counts"):
        ex.lower_sharded(w.params0(), None, num_steps=1, key=1, mesh=None)
