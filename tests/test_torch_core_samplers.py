"""The port's samplers against the reference's, on the CPU.

SGHMC and EC-SGHMC (unfused and fused, alpha in {0, 1}, s in {1, 4}) run
a few steps from the same state on both sides, with the reference's noise
handed to the port through ``update(..., noise=...)``: the normal draws of
the unfused paths, and for the fused path the kernel's per-leaf bits
exactly as ``repro.kernels.ops.fused_ec_update`` draws them (padded flat
layout, first n taken).  Params, momentum and every center tree must agree
at atol 2e-6, the reference suite's kernel tolerance: the two frameworks
round a few ops (Box-Muller's log/cos, XLA's contractions) differently.

Within the port, ``p_step`` must equal the plain fused update bit for bit
in f32 (the mirror of ``tests/test_fused_equivalence.py``), and the fused
wrapper's guards must raise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import tree_util as jtu
from repro.kernels import fused_ecsghmc as jfe
from repro.kernels import ref as jref
from repro_torch import _interop, core
from repro_torch.core import rng
from repro_torch.kernels import ops, ref

ATOL = 2e-6
MU, LAM = 1.5, 1.0
K = 4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_close(a, b, atol=ATOL, what=""):
    la, lb = core.tree_util.tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_np(x), np.asarray(y), atol=atol, rtol=0, err_msg=what)


def _params(seed, chains=K):
    r = np.random.default_rng(seed)
    return {"a": (MU + r.normal(size=(chains, 3, 5))).astype(np.float32),
            "b": {"w": (MU + r.normal(size=(chains, 7))).astype(np.float32)}}


def _grad_j(params):
    return jax.tree.map(lambda t: LAM * (t - MU), params)


def _grad_t(params):
    return core.tree_util.tree_map(lambda t: LAM * (t - MU), params)


def _fused_bits(k_p, params):
    """The per-leaf (bits1, bits2) the reference's fused dispatch draws
    (``kernels/ops.py:75`` then ``:56-57``), as int32 tensors."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(k_p, len(leaves))
    out = []
    for leaf, kk in zip(leaves, keys):
        n = leaf.size
        rows = -(-n // 8192) * 8
        k1, k2 = jax.random.split(kk)
        b = [np.asarray(jax.random.bits(k, (rows, 1024), jnp.uint32)).reshape(-1)[:n]
             for k in (k1, k2)]
        out.append(tuple(torch.from_numpy(x.view(np.int32).copy()) for x in b))
    return jax.tree.unflatten(treedef, out)


def _ec_noise(key, jstate, jparams, fused):
    k_p, k_r = jax.random.split(key)
    noise_r = jtu.tree_random_normal(k_r, jstate.center_momentum, jnp.float32)
    if fused:
        noise_p = _fused_bits(k_p, jparams)
    else:
        noise_p = _interop.tree_from_numpy(jax.tree.map(
            np.asarray, jtu.tree_random_normal(k_p, jstate.momentum, jnp.float32)))
    return {"p": noise_p, "r": _interop.tree_from_numpy(jax.tree.map(np.asarray, noise_r))}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("alpha", [0.0, 1.0])
@pytest.mark.parametrize("s", [1, 4])
def test_ec_sghmc_matches_reference(fused, alpha, s):
    kw = dict(step_size=0.1, alpha=alpha, sync_every=s, friction=1.0, center_friction=1.0,
              fused=fused)
    jsamp, tsamp = jcore.ec_sghmc(**kw), core.ec_sghmc(**kw)
    jparams = jax.tree.map(jnp.asarray, _params(3))
    params = _interop.tree_from_numpy(_params(3))
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    _assert_tree_close(state.center, jstate.center, what="init center")
    key = jax.random.PRNGKey(11)
    for t in range(6):  # s=4 syncs after step 4 (index 3); s=1 after every step
        kt = jax.random.fold_in(key, t)
        noise = _ec_noise(kt, jstate, jparams, fused)
        jup, jstate = jsamp.update(_grad_j(jparams), jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        up, state = tsamp.update(_grad_t(params), state, params, None, noise=noise)
        params = core.apply_updates(params, up)
        for name in ("momentum", "center", "center_momentum", "center_stale", "mean_theta_stale"):
            _assert_tree_close(getattr(state, name), getattr(jstate, name),
                               what=f"step {t} {name}")
        _assert_tree_close(params, jparams, what=f"step {t} params")
        assert state.step == int(jstate.step)
    jst = jsamp.stats(jstate, jparams)
    st = tsamp.stats(state, params)
    for k in ("momentum_norm", "center_momentum_norm", "chain_center_rms", "coupling_energy"):
        np.testing.assert_allclose(float(st[k]), float(jst[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("convention", ["eq4", "eq6"])
def test_sghmc_matches_reference(convention):
    kw = dict(step_size=0.05, friction=1.3, mass=2.0, noise_convention=convention)
    jsamp, tsamp = jcore.sghmc(**kw), core.sghmc(**kw)
    jparams = jax.tree.map(jnp.asarray, _params(5, chains=2))
    params = _interop.tree_from_numpy(_params(5, chains=2))
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    for t in range(4):
        kt = jax.random.PRNGKey(100 + t)
        noise = _interop.tree_from_numpy(jax.tree.map(
            np.asarray, jtu.tree_random_normal(kt, jstate.momentum, jnp.float32)))
        jup, jstate = jsamp.update(_grad_j(jparams), jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        up, state = tsamp.update(_grad_t(params), state, params, None, noise=noise)
        params = core.apply_updates(params, up)
        _assert_tree_close(state.momentum, jstate.momentum, what=f"step {t} momentum")
        _assert_tree_close(params, jparams, what=f"step {t} params")


def test_state_crosses_from_reference():
    jsamp = jcore.ec_sghmc(step_size=0.1, sync_every=2)
    jparams = jax.tree.map(jnp.asarray, _params(7))
    jstate = jsamp.init(jparams)
    jup, jstate = jsamp.update(_grad_j(jparams), jstate, jparams, jax.random.PRNGKey(0))
    state = _interop.state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    assert isinstance(state, core.ECSGHMCState) and state.step == 1
    for name in state._fields[:-1]:
        _assert_tree_close(getattr(state, name), getattr(jstate, name), atol=0.0)
    back = _interop.state_to_numpy(state)
    np.testing.assert_array_equal(back["momentum"]["a"], np.asarray(jstate.momentum["a"]))


# --- fused kernel: plain version, p_step and the wrapper ----------------------

SHAPE = (2, 4, 1024)


def _operands(seed):
    g = torch.Generator().manual_seed(seed)
    theta = torch.randn(SHAPE, generator=g)
    p = 0.1 * torch.randn(SHAPE, generator=g)
    grad = torch.randn(SHAPE, generator=g)
    c = torch.randn(SHAPE[1:], generator=g)
    bits = [torch.randint(-2**31, 2**31 - 1, SHAPE, generator=g, dtype=torch.int32)
            for _ in range(2)]
    return theta, p, grad, c, bits


HYPERS = [
    dict(eps=1e-2, friction=1.0, mass=1.0, alpha=0.7, sigma_p=0.05),
    dict(eps=0.1, friction=1.5, mass=2.0, alpha=1.0, sigma_p=0.2),
    dict(eps=5e-3, friction=0.0, mass=1.0, alpha=0.0, sigma_p=0.0),
]


@pytest.mark.parametrize("seed", [0, 42, 1234])
@pytest.mark.parametrize("hyper", HYPERS, ids=["paper", "heavy", "degenerate"])
def test_fused_plain_matches_p_step_bitwise(seed, hyper):
    theta, p, grad, c, (b1, b2) = _operands(seed)
    minv = 1.0 / hyper["mass"]
    scalars = ref.ec_scalars(hyper["eps"], hyper["friction"], minv, hyper["alpha"],
                             hyper["sigma_p"])
    t_f, p_f = ref.fused_ec_update(theta, p, grad, c, b1, b2, scalars=scalars,
                                   stochastic_round=False)
    p_u = core.p_step(p, grad, theta, c, ref.box_muller(b1, b2), eps=hyper["eps"],
                      friction=hyper["friction"], minv=minv, alpha=hyper["alpha"],
                      sigma_p=hyper["sigma_p"])
    t_u = theta + float(np.float32(hyper["eps"]) * np.float32(minv)) * p
    assert torch.equal(t_f, t_u), "theta' not bit-identical"
    assert torch.equal(p_f, p_u), "p' not bit-identical"
    # the wrapper's CPU path is the plain version
    t_w, p_w = ops.fused_ec_update(theta, p, grad, c, bits=(b1, b2), stochastic_round=False,
                                   **hyper)
    assert torch.equal(t_w, t_f) and torch.equal(p_w, p_f)


@pytest.mark.parametrize("hyper", HYPERS[:2], ids=["paper", "heavy"])
def test_fused_plain_matches_reference_kernel(hyper):
    """The plain version against the interpret-mode Pallas kernel on the
    same bits (one (8, 1024) block), f32: atol 2e-6."""
    theta, p, grad, c, (b1, b2) = _operands(9)
    flat = lambda x: jnp.asarray(_np(x).reshape(8, 1024))
    cb = c[None].expand(SHAPE).contiguous()
    jt, jp = jfe.fused_ec_update_flat(
        flat(theta), flat(p), flat(grad), flat(cb), flat(b1).view(jnp.uint32),
        flat(b2).view(jnp.uint32), stochastic_round=False, onchip_prng=False, interpret=True,
        **hyper)
    tt, tp = ops.fused_ec_update(theta, p, grad, c, bits=(b1, b2), stochastic_round=False,
                                 **hyper)
    np.testing.assert_allclose(_np(tt).reshape(8, 1024), np.asarray(jt), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tp).reshape(8, 1024), np.asarray(jp), atol=ATOL, rtol=0)


def test_stochastic_round_matches_reference_bitwise():
    theta, _, _, _, (b1, _) = _operands(5)
    got = ref.stochastic_round_bf16(theta, b1).view(torch.int16).numpy().view(np.uint16)
    want = jfe._stochastic_round_bf16(jnp.asarray(_np(theta)), jnp.asarray(_np(b1).view(np.uint32)))
    np.testing.assert_array_equal(got, np.asarray(want).view(np.uint16))


def test_box_muller_close_to_reference():
    _, _, _, _, (b1, b2) = _operands(6)
    want = jref.box_muller(jnp.asarray(_np(b1).view(np.uint32)), jnp.asarray(_np(b2).view(np.uint32)))
    np.testing.assert_allclose(_np(ref.box_muller(b1, b2)), np.asarray(want), atol=ATOL, rtol=0)


def test_bf16_fused_update_rounds_stochastically():
    """bf16 state: theta' and p' land on one of the two bf16 neighbours of
    the f32 result, and the rounding is unbiased on average."""
    theta, p, grad, c, bits = _operands(8)
    hyper = HYPERS[1]
    tb, pb, cb = theta.bfloat16(), p.bfloat16(), c.bfloat16()
    t_new, p_new = ops.fused_ec_update(tb, pb, grad, cb, bits=bits, **hyper)
    assert t_new.dtype == p_new.dtype == torch.bfloat16
    scalars = ref.ec_scalars(hyper["eps"], hyper["friction"], 1 / hyper["mass"], hyper["alpha"],
                             hyper["sigma_p"])
    t32, p32 = ref.fused_ec_update(tb.float(), pb.float(), grad, cb.float(), *bits,
                                   scalars=scalars, stochastic_round=False)
    for got, exact in ((t_new, t32), (p_new, p32)):
        ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - 8)
        assert ((got.float() - exact).abs() < ulp).all()
        bias = (got.float() - exact).mean().item()
        assert abs(bias) < 1e-3 * exact.abs().mean().item()


def test_philox_known_answers():
    """Philox-4x32-10 against Random123's known-answer vectors."""
    b1, b2 = ref.philox_bits(0, 0, 0, 2)
    assert [hex(x) for x in (b1[0], b2[0], b1[1], b2[1])] == [
        "0x6627e8d5", "0xe169c58d", "0xbc57ac4c", "0x9b00dbd8"]
    assert b1.dtype == b2.dtype == np.uint32


@pytest.mark.parametrize("start,n", [(0, 9), (1, 8), (7, 13), (8, 1), (3, 1)])
def test_philox_bits_from_a_start_element_are_the_slice_of_the_full_draw(start, n):
    full1, full2 = ref.philox_bits(0x5EED, 4, (1 << 32) + 3, start + n)
    b1, b2 = ref.philox_bits(0x5EED, 4, (1 << 32) + 3, n, start)
    np.testing.assert_array_equal(b1, full1[start:])
    np.testing.assert_array_equal(b2, full2[start:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [36, 37])  # the kernel's 4-wide and 1-wide paths
def test_fused_chain_offset_draws_the_unsplit_runs_noise(dtype, n):
    """A rank holding chains ``off..K-1`` of a split run updates them as
    the unsplit run does: Philox counts the global element index."""
    g = torch.Generator().manual_seed(n)
    theta, p, grad = (torch.randn(4, n, generator=g).to(dtype) for _ in range(3))
    c = torch.randn(n, generator=g).to(dtype)
    hyper = dict(eps=1e-2, friction=1.0, mass=1.0, alpha=1.0, sigma_p=0.3, seed=rng.key(3),
                 leaf=2, step=5)
    t_all, p_all = ops.fused_ec_update(theta, p, grad.float(), c, **hyper)
    for off in (1, 2, 3):
        t_k, p_k = ops.fused_ec_update(theta[off:].contiguous(), p[off:].contiguous(),
                                       grad[off:].float().contiguous(), c, chain_offset=off,
                                       **hyper)
        assert torch.equal(t_k, t_all[off:]) and torch.equal(p_k, p_all[off:]), off
    with pytest.raises(ValueError, match="Philox counter"):
        ops.fused_ec_update(theta, p, grad.float(), c, chain_offset=1 << 31, **hyper)


def test_philox_mode_is_a_function_of_seed_leaf_step():
    theta, p, grad, c, _ = _operands(3)
    hyper = dict(eps=0.0, friction=0.0, mass=1.0, alpha=0.0, sigma_p=1.0)
    z = torch.zeros_like
    run = lambda **kw: ops.fused_ec_update(z(theta), z(p), z(grad), z(c), **hyper, **kw)[1]
    a = run(seed=rng.key(1), leaf=2, step=5)
    assert torch.equal(a, run(seed=rng.key(1), leaf=2, step=5))
    for other in (dict(seed=rng.key(2), leaf=2, step=5), dict(seed=rng.key(1), leaf=3, step=5),
                  dict(seed=rng.key(1), leaf=2, step=6)):
        assert not torch.equal(a, run(**other))
    assert abs(a.mean().item()) < 0.05 and abs(a.var().item() - 1.0) < 0.05


# --- wrapper guards -----------------------------------------------------------


def _guard_cases():
    t = torch.zeros(2, 8)
    c = torch.zeros(8)
    bits = (torch.zeros(16, dtype=torch.int32),) * 2
    h = dict(eps=0.1, friction=1.0, mass=1.0, alpha=1.0, sigma_p=0.1)
    return {
        "no_noise": lambda: ops.fused_ec_update(t, t, t, c, **h),
        "both_noises": lambda: ops.fused_ec_update(t, t, t, c, bits=bits, seed=1, **h),
        "dtype_mix": lambda: ops.fused_ec_update(t, t.bfloat16(), t, c, seed=1, **h),
        "f16": lambda: ops.fused_ec_update(t.half(), t.half(), t, c.half(), seed=1, **h),
        "p_shape": lambda: ops.fused_ec_update(t, t[:1], t, c, seed=1, **h),
        "c_shape": lambda: ops.fused_ec_update(t, t, t, torch.zeros(3), seed=1, **h),
        "short_bits": lambda: ops.fused_ec_update(t, t, t, c, bits=(bits[0][:5],) * 2, **h),
        "bits_dtype": lambda: ops.fused_ec_update(t, t, t, c, bits=(bits[0].long(),) * 2, **h),
        "strided": lambda: ops.fused_ec_update(t.t(), t.t(), t.t(), torch.zeros(2), seed=1, **h),
        "device": lambda: ops.fused_ec_update(t.to("meta"), t.to("meta"), t.to("meta"),
                                              c.to("meta"), seed=1, **h),
        "bad_seed": lambda: ops.fused_ec_update(t, t, t, c, seed=-1, **h),
    }


@pytest.mark.parametrize("case", sorted(_guard_cases()))
def test_fused_wrapper_guards(case):
    with pytest.raises(ValueError):
        _guard_cases()[case]()


def test_fused_tree_in_place_and_launch_count():
    theta, p, grad, c, bits = _operands(4)
    before = dict(ops.launches)
    _, want = ops.fused_ec_update(theta, p, grad, c, bits=bits, **HYPERS[0])
    tree = lambda x: {"x": x}
    new_p = ops.fused_ec_update_tree(tree(theta), tree(p), tree(grad), tree(c),
                                     bits=tree(tuple(bits)), **HYPERS[0])
    assert new_p["x"] is p and torch.equal(p, want)
    assert ops.launches == before  # the CPU path launches no kernel


def test_schedules_match_reference():
    pairs = [
        (jcore.constant(0.1), core.constant(0.1)),
        (jcore.polynomial_decay(0.1, 10.0, 0.55), core.polynomial_decay(0.1, 10.0, 0.55)),
        (jcore.cosine(0.2, 100, 0.01), core.cosine(0.2, 100, 0.01)),
        (jcore.warmup_cosine(0.2, 10, 100), core.warmup_cosine(0.2, 10, 100)),
    ]
    for jfn, tfn in pairs:
        for t in (0, 1, 5, 10, 57, 100, 150):
            got, want = tfn(t), np.float32(jfn(jnp.int32(t)))
            assert isinstance(got, np.float32)
            np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_potential_matches_reference():
    params = _params(1, chains=1)
    params = {"a": params["a"][0], "b": {"w": params["b"]["w"][0]}}
    batch = np.random.default_rng(2).normal(size=(6, 5)).astype(np.float32)

    def jnll(p, b):
        r = b @ p["a"].T
        return jnp.sum(r**2) + jnp.sum(p["b"]["w"] ** 2), jnp.int32(b.shape[0])

    def tnll(p, b):
        r = b @ p["a"].T
        return torch.sum(r**2) + torch.sum(p["b"]["w"] ** 2), b.shape[0]

    jpot = jcore.make_potential(jnll, 100, jcore.gaussian_prior(1e-2))
    tpot = core.make_potential(tnll, 100, core.gaussian_prior(1e-2))
    jv, jg = jpot.value_and_grad(jax.tree.map(jnp.asarray, params), jnp.asarray(batch))
    tv, tg = tpot.value_and_grad(_interop.tree_from_numpy(params), torch.from_numpy(batch))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    _assert_tree_close(tg, jg, atol=1e-4)
    cpot = core.chainwise(tpot)
    stacked = _interop.tree_from_numpy(jax.tree.map(lambda x: np.stack([x, x + 1]), params))
    vals, grads = cpot.value_and_grad(stacked, torch.from_numpy(np.stack([batch, batch])))
    assert vals.shape == (2,) and grads["a"].shape == (2, 3, 5)
    np.testing.assert_allclose(float(vals[0]), float(jv), rtol=1e-6)


def test_resample_chain_from_center():
    samp = core.ec_sghmc(step_size=0.1, alpha=2.0)
    params = _interop.tree_from_numpy(_params(2))
    state = samp.init(params)
    new_params, new_state = core.resample_chain_from_center(state, 2.0, rng.key(0), 6)
    assert new_params["a"].shape == (6, 3, 5) and float(new_state.momentum["a"].abs().sum()) == 0
    assert new_state.center is state.center


# --- on the card (skipped without one; chip_smoke.py is the card's check) ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; chip_smoke.py runs these checks on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fused_kernel_matches_plain_version(card):
    theta, p, grad, c, bits = (x.to(card) if isinstance(x, torch.Tensor) else [b.to(card) for b in x]
                               for x in _operands(21))
    hyper = HYPERS[1]
    scalars = ref.ec_scalars(hyper["eps"], hyper["friction"], 1 / hyper["mass"], hyper["alpha"],
                             hyper["sigma_p"])
    t_k, p_k = ops.fused_ec_update(theta, p, grad, c, bits=bits, **hyper)
    t_r, p_r = ref.fused_ec_update(theta, p, grad, c, *bits, scalars=scalars, stochastic_round=True)
    assert torch.equal(t_k, t_r)
    torch.testing.assert_close(p_k, p_r, atol=1e-6, rtol=0)
    z = torch.zeros((2, 1001), device=card)
    a = ops.fused_ec_update(z, z, z, z[0], seed=7, leaf=1, step=3, **hyper)[1]
    b1, b2 = ref.philox_bits(7, 1, 3, z.numel())
    bits = [torch.from_numpy(b.view(np.int32)).to(card).view(z.shape) for b in (b1, b2)]
    assert torch.equal(a, ops.fused_ec_update(z, z, z, z[0], bits=bits, **hyper)[1])
    # chain_offset: chains 1.. of a split run draw the unsplit run's noise
    for n in (1000, 1001):  # the 4-wide and the 1-wide paths
        z = torch.zeros((4, n), device=card)
        full = ops.fused_ec_update(z, z, z, z[0], seed=7, leaf=1, step=3, **hyper)[1]
        part = ops.fused_ec_update(z[1:], z[1:], z[1:], z[0], seed=7, leaf=1, step=3,
                                   chain_offset=1, **hyper)[1]
        assert torch.equal(part, full[1:]), n
