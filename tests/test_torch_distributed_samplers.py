"""The port's distributed sampler options against the reference's
unsharded update, on the CPU, with the reference's noise handed in.

* ``ec_sghmc(compression=int8_codec())`` in one process: the reduced
  chain mean is quantized at each sync, as the reference's single-program
  path does (unfused and fused, s = 1 and 4).
* ``ec_sghmc(chain_axis=...)`` and ``ec_sgld(chain_axis=...)`` on 2 gloo
  ranks of 2 chains each: every rank's chains and the replicated center
  trees follow the reference's unsharded update of all 4 chains (with
  per-chain noise: chain i's draw keyed by its global index), each rank
  handed its slice of the chains' noise and the whole center noise.

Tolerance: atol 2e-6, that of the existing sampler pairings
(``tests/test_torch_core_samplers.py``): the frameworks round Box-Muller
and a few contractions differently, and the mean over 2 ranks of 2-chain
means sums in another order than the reference's mean of 4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_workers as w
from repro import core as jcore
from repro.core import tree_util as jtu
from repro.distributed import int8_codec as j_int8
from repro_torch import _interop, core
from repro_torch.distributed import int8_codec
from repro_torch.launch.mesh import spawn_local

ATOL = 2e-6
K, MU = w.K, w.MU


def _params_np(seed):
    r = np.random.default_rng(seed)
    return {"a": (MU + r.normal(size=(K, 3, 5))).astype(np.float32),
            "b": {"w": (MU + r.normal(size=(K, 7))).astype(np.float32)}}


def _close(got, want, what):
    got = got if isinstance(got, list) else core.tree_util.tree_leaves(got)
    want = jax.tree.leaves(want)
    assert len(got) == len(want), what
    for x, y in zip(got, want):
        x = x.detach().numpy() if isinstance(x, torch.Tensor) else x
        np.testing.assert_allclose(x, np.asarray(y), atol=ATOL, rtol=0, err_msg=what)


def _fused_bits(k_p, params):
    """The per-leaf (bits1, bits2) the reference's fused dispatch draws
    (``kernels/ops.py:75`` then ``:56-57``), as uint32 patterns in int32
    numpy arrays shaped like each leaf."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(k_p, len(leaves))
    out = []
    for leaf, kk in zip(leaves, keys):
        n = leaf.size
        rows = -(-n // 8192) * 8
        k1, k2 = jax.random.split(kk)
        out.append(tuple(np.asarray(jax.random.bits(k, (rows, 1024), jnp.uint32)).reshape(-1)[:n]
                         .view(np.int32).reshape(leaf.shape).copy() for k in (k1, k2)))
    return jax.tree.unflatten(treedef, out)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _ec_noise(key, jstate, jparams, fused, per_chain):
    k_p, k_r = jax.random.split(key)
    if fused:
        noise_p = _fused_bits(k_p, jparams)
    elif per_chain:
        noise_p = _np_tree(jtu.tree_random_normal_per_chain(k_p, jstate.momentum, 0, jnp.float32))
    else:
        noise_p = _np_tree(jtu.tree_random_normal(k_p, jstate.momentum, jnp.float32))
    noise_r = _np_tree(jtu.tree_random_normal(k_r, jstate.center_momentum, jnp.float32))
    return {"p": noise_p, "r": noise_r}


def _to_torch(noise):
    conv = lambda x: (tuple(torch.from_numpy(b) for b in x) if isinstance(x, tuple)
                      else torch.from_numpy(x))
    return {k: jax.tree.map(conv, v, is_leaf=lambda x: isinstance(x, tuple)) for k, v in
            noise.items()}


EC_NAMES = ("momentum", "center", "center_momentum", "center_stale", "mean_theta_stale")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("s", [1, 4])
def test_ec_sghmc_int8_compression_matches_reference(fused, s):
    kw = dict(step_size=0.1, alpha=1.0, sync_every=s, friction=1.0, center_friction=1.0,
              fused=fused)
    jsamp = jcore.ec_sghmc(compression=j_int8(), **kw)
    tsamp = core.ec_sghmc(compression=int8_codec(), **kw)
    jparams = jax.tree.map(jnp.asarray, _params_np(3))
    params = _interop.tree_from_numpy(_params_np(3))
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    key = jax.random.PRNGKey(11)
    for t in range(6):
        kt = jax.random.fold_in(key, t)
        noise = _to_torch(_ec_noise(kt, jstate, jparams, fused, False))
        jup, jstate = jsamp.update(jax.tree.map(lambda x: x - MU, jparams), jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        up, state = tsamp.update(core.tree_util.tree_map(lambda x: x - MU, params), state,
                                 params, None, noise=noise)
        params = core.apply_updates(params, up)
        for name in EC_NAMES:
            _close(getattr(state, name), getattr(jstate, name), f"step {t} {name}")
        _close(params, jparams, f"step {t} params")


def _reference_steps(kind, fused, steps=6):
    """The reference's unsharded update of all K chains over ``steps``
    steps: (initial params, the noise of each step, the state after each)."""
    if kind == "ec_sghmc":
        kw = dict(step_size=0.1, alpha=1.0, sync_every=2, friction=1.0, center_friction=1.0,
                  fused=fused)
        jsamp = jcore.ec_sghmc(per_chain_noise=not fused, **kw)
    else:
        kw = dict(step_size=0.05, alpha=1.0, sync_every=2, center_friction=1.0)
        jsamp = jcore.ec_sgld(per_chain_noise=True, **kw)
    p0 = _params_np(7)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jsamp.init(jparams)
    key = jax.random.PRNGKey(23)
    noises, history = [], []
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        k_p, k_r = jax.random.split(kt)
        if kind == "ec_sghmc":
            noises.append(_ec_noise(kt, jstate, jparams, fused, not fused))
        else:
            noises.append({
                "theta": _np_tree(jtu.tree_random_normal_per_chain(k_p, jparams, 0,
                                                                   jnp.float32)),
                "r": _np_tree(jtu.tree_random_normal(k_r, jstate.center_momentum,
                                                     jnp.float32))})
        jup, jstate = jsamp.update(jax.tree.map(lambda x: x - MU, jparams), jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        history.append((jparams, jstate))
    return p0, noises, history, kw


JOBS = [("ec_sghmc", False), ("ec_sghmc", True), ("ec_sgld", False)]


@pytest.fixture(scope="module")
def two_ranks():
    """Each job's reference steps, and each rank's port steps."""
    refs = [_reference_steps(kind, fused) for kind, fused in JOBS]
    jobs = [(kind, p0, noises, kw) for (kind, _), (p0, noises, _, kw) in zip(JOBS, refs)]
    outs = spawn_local(w.sampler_steps_rank, 2, jobs, timeout_s=180)
    return refs, outs


@pytest.mark.parametrize("job", range(len(JOBS)),
                         ids=["ec_sghmc-unfused", "ec_sghmc-fused", "ec_sgld"])
def test_chain_axis_two_ranks_match_unsharded_reference(two_ranks, job):
    refs, outs = two_ranks
    kind, _ = JOBS[job]
    history = refs[job][2]
    names = EC_NAMES if kind == "ec_sghmc" else EC_NAMES[1:]
    kl = K // 2
    for rank, rank_out in enumerate(outs):
        for t, ((jparams, jstate), got) in enumerate(zip(history, rank_out[job])):
            cut = lambda tree: jax.tree.map(lambda x: x[rank * kl:(rank + 1) * kl], tree)
            _close(got["params"], cut(jparams), f"rank {rank} step {t} params")
            for name in names:
                want = getattr(jstate, name)
                _close(got[name], cut(want) if name == "momentum" else want,
                       f"rank {rank} step {t} {name}")
    # the replicated center trees are bit-identical on both ranks
    for a, b in zip(outs[0][job], outs[1][job]):
        for name in names[1:] if kind == "ec_sghmc" else names:
            assert all(np.array_equal(x, y) for x, y in zip(a[name], b[name])), name
