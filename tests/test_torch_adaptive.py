"""The port's adaptive tier against the reference's, on the CPU.

* ``p_step`` with a tensor M⁻¹ equals the reference's ``p_step`` evaluated
  op by op (eager jnp) bit for bit, with the same noise and the sampler's
  f32 step size.
* The preconditioned kernel's plain version equals ``p_step`` + the θ line
  bit for bit (the port's mirror of tests/test_fused_equivalence.py:83),
  equals the body of the Pallas kernel ``_precond_kernel`` evaluated op by
  op bit for bit in θ' (and in p' without noise), and the compiled
  interpret-mode kernel (``fused_precond_ec_update_flat``) at atol 2e-6,
  the reference suite's kernel tolerance (measured: 1.2e-7 in θ', 6e-8 in
  p').  The compiled kernel is not bitwise: XLA contracts
  θ + (ε·M⁻¹)·p and the p' sums into FMAs, and its log/cos in Box-Muller
  round differently from PyTorch's (≤ 2.4e-7, ROADMAP Queue C).
* At M⁻¹ ≡ 1 the preconditioned update equals ``fused_ec_update(mass=1)``
  bit for bit, in parity and in Philox mode.
* Both preconditioners are positive, bit-frozen after burn-in and equal
  to ``frozen_mass_inv``; RMSProp equals the reference bit for bit.
* Identity preconditioning reproduces EC-SGHMC (fused and unfused), SGHMC
  and SGLD bit for bit, across sync boundaries.
* The samplers match the reference over several steps with its noise
  handed in (atol 2e-6, the reference suite's kernel tolerance), and
  ``FeedbackESS`` and the executor's adapt hook behave as the reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import tree_util as jtu
from repro.core.ec_sghmc import p_step as jp_step
from repro.kernels import fused_ecsghmc as jfe
from repro.kernels import ref as jref
from repro_torch import _interop, core
from repro_torch.core import rng
from repro_torch.core.tree_util import tree_leaves
from repro_torch.kernels import ops, ref
from repro_torch.run import ChainExecutor, ess_feedback_adapter

ATOL = 2e-6
MU, K = 1.5, 4
SHAPE = (8, 1024)  # one Pallas block
HYPERS = [dict(eps=1e-2, friction=1.0, alpha=0.7, sigma_p=0.05),
          dict(eps=0.1, friction=1.5, alpha=1.0, sigma_p=0.2)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _operands(seed, shape=SHAPE):
    r = np.random.default_rng(seed)
    f = lambda x: x.astype(np.float32)
    return dict(theta=f(r.normal(size=shape)), p=f(0.1 * r.normal(size=shape)),
                g=f(r.normal(size=shape)), c=f(r.normal(size=shape)),
                minv=f(np.exp(0.5 * r.normal(size=shape))),
                b1=r.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32),
                b2=r.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32))


def _t(x):
    return torch.from_numpy(np.array(x.view(np.int32) if x.dtype == np.uint32 else x))


def _f32(hyper):
    """The sampler's scalars: eps is an f32 step size, the rest Python floats
    that the reference rounds to f32 against it."""
    return {k: np.float32(v) if k == "eps" else v for k, v in hyper.items()}


def _plain(o, hyper, stochastic_round=False):
    return ref.fused_precond_ec_update(
        _t(o["theta"]), _t(o["p"]), _t(o["g"]), _t(o["c"]), _t(o["minv"]), _t(o["b1"]),
        _t(o["b2"]), scalars=ref.precond_scalars(**hyper), stochastic_round=stochastic_round)


# --- p_step and the kernel's plain version ------------------------------------


@pytest.mark.parametrize("seed", [0, 42, 1234])
@pytest.mark.parametrize("hyper", HYPERS, ids=["paper", "heavy"])
def test_p_step_array_minv_matches_reference_bitwise(seed, hyper):
    o = _operands(seed)
    noise = np.asarray(jref.box_muller(jnp.asarray(o["b1"]), jnp.asarray(o["b2"])))
    h = _f32(hyper)
    want = jp_step(jnp.asarray(o["p"]), jnp.asarray(o["g"]), jnp.asarray(o["theta"]),
                   jnp.asarray(o["c"]), jnp.asarray(noise), minv=jnp.asarray(o["minv"]), **h)
    got = core.p_step(_t(o["p"]), _t(o["g"]), _t(o["theta"]), _t(o["c"]), _t(noise),
                      minv=_t(o["minv"]), **h)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("hyper", HYPERS, ids=["paper", "heavy"])
def test_precond_plain_matches_p_step_bitwise(seed, hyper):
    o = _operands(seed)
    t_f, p_f = _plain(o, hyper)
    noise = ref.box_muller(_t(o["b1"]), _t(o["b2"]))
    p_u = core.p_step(_t(o["p"]), _t(o["g"]), _t(o["theta"]), _t(o["c"]), noise,
                      minv=_t(o["minv"]), **hyper)
    t_u = _t(o["theta"]) + (_t(o["minv"]) * float(np.float32(hyper["eps"]))) * _t(o["p"])
    assert torch.equal(t_f, t_u), "theta' not bit-identical"
    assert torch.equal(p_f, p_u), "p' not bit-identical"
    # the wrapper's CPU path is the plain version
    t_w, p_w = ops.fused_precond_ec_update(_t(o["theta"]), _t(o["p"]), _t(o["g"]), _t(o["c"]),
                                           _t(o["minv"]), bits=(_t(o["b1"]), _t(o["b2"])),
                                           stochastic_round=False, **hyper)
    assert torch.equal(t_w, t_f) and torch.equal(p_w, p_f)


class _Ref:
    """A stand-in for a Pallas ref: ``[...]`` reads and writes an array."""

    def __init__(self, value=None, dtype=jnp.float32):
        self.value, self.dtype = value, dtype

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


@pytest.mark.parametrize("hyper", HYPERS + [dict(HYPERS[1], sigma_p=0.0)],
                         ids=["paper", "heavy", "noiseless"])
def test_precond_plain_matches_pallas_body_op_by_op(hyper):
    """``_precond_kernel``'s body run eagerly (no XLA fusion, so no FMA
    contraction): the port rounds as the kernel's own term grouping."""
    o = _operands(7)
    h = _f32(hyper)
    scal = jnp.stack([jnp.asarray(h["eps"], jnp.float32),
                      jnp.asarray(h["eps"] * h["friction"], jnp.float32),
                      jnp.asarray(h["eps"] * h["alpha"], jnp.float32),
                      jnp.asarray(h["sigma_p"], jnp.float32)])
    refs = [_Ref(jnp.asarray(o[k])) for k in ("theta", "p", "g", "c", "minv", "b1", "b2")]
    t_out, p_out = _Ref(), _Ref()
    jfe._precond_kernel(_Ref(scal), *refs, t_out, p_out, stochastic_round=False,
                        onchip_prng=False)
    t_f, p_f = _plain(o, hyper)
    np.testing.assert_array_equal(_np(t_f), np.asarray(t_out.value))
    if hyper["sigma_p"] == 0.0:
        np.testing.assert_array_equal(_np(p_f), np.asarray(p_out.value))
    else:  # Box-Muller's log/cos: PyTorch's and XLA's differ by <= 2.4e-7
        np.testing.assert_allclose(_np(p_f), np.asarray(p_out.value),
                                   atol=hyper["sigma_p"] * 3e-7 + 1e-7, rtol=0)


@pytest.mark.parametrize("hyper", HYPERS, ids=["paper", "heavy"])
def test_precond_plain_matches_pallas_kernel(hyper):
    """Against the compiled interpret-mode kernel on the same bits."""
    o = _operands(9)
    jt, jp = jax.jit(lambda *a: jfe.fused_precond_ec_update_flat(
        *a, stochastic_round=False, onchip_prng=False, interpret=True, **_f32(hyper)))(
        *(o[k] for k in ("theta", "p", "g", "c", "minv", "b1", "b2")))
    t_f, p_f = _plain(o, hyper)
    np.testing.assert_allclose(_np(t_f), np.asarray(jt), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(p_f), np.asarray(jp), atol=ATOL, rtol=0)


def test_stochastic_rounding_of_precond_update():
    """bf16 state: theta' and p' land on one of the two bf16 neighbours of
    the f32 result, unbiased on average, with the bits of the scalar-mass
    update's rounding."""
    o = _operands(8, shape=(2, 4, 1024))
    hyper = HYPERS[1]
    tb, pb = _t(o["theta"]).bfloat16(), _t(o["p"]).bfloat16()
    cb = _t(o["c"][0]).bfloat16()
    bits = (_t(o["b1"]), _t(o["b2"]))
    t_new, p_new = ops.fused_precond_ec_update(tb, pb, _t(o["g"]), cb, _t(o["minv"]), bits=bits,
                                               **hyper)
    assert t_new.dtype == p_new.dtype == torch.bfloat16
    t32, p32 = ref.fused_precond_ec_update(tb.float(), pb.float(), _t(o["g"]), cb.float(),
                                           _t(o["minv"]), *bits,
                                           scalars=ref.precond_scalars(**hyper),
                                           stochastic_round=False)
    for got, exact in ((t_new, t32), (p_new, p32)):
        ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - 8)
        assert ((got.float() - exact).abs() < ulp).all()
        assert abs((got.float() - exact).mean().item()) < 1e-3 * exact.abs().mean().item()
    one = torch.ones_like(_t(o["minv"]))
    t1, p1 = ops.fused_precond_ec_update(tb, pb, _t(o["g"]), cb, one, bits=bits, **hyper)
    t2, p2 = ops.fused_ec_update(tb, pb, _t(o["g"]), cb, bits=bits, mass=1.0, **hyper)
    assert torch.equal(t1, t2) and torch.equal(p1, p2)


@pytest.mark.parametrize("mode", ["parity", "philox"])
@pytest.mark.parametrize("n", [1024, 1001])
def test_unit_minv_equals_scalar_mass_update(mode, n):
    o = _operands(3, shape=(K, n))
    noise = dict(bits=(_t(o["b1"]), _t(o["b2"]))) if mode == "parity" else \
        dict(seed=rng.key(5), leaf=2, step=9)
    args = (_t(o["theta"]), _t(o["p"]), _t(o["g"]), _t(o["c"][0]))
    for hyper in HYPERS:
        a = ops.fused_precond_ec_update(*args, torch.ones(K, n), **noise, **hyper)
        b = ops.fused_ec_update(*args, mass=1.0, **noise, **hyper)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _guard_cases():
    t, c, m = torch.zeros(2, 8), torch.zeros(8), torch.ones(2, 8)
    h = dict(eps=0.1, friction=1.0, alpha=1.0, sigma_p=0.1)
    return {
        "minv_dtype": lambda: ops.fused_precond_ec_update(t, t, t, c, m.double(), seed=1, **h),
        "minv_bf16": lambda: ops.fused_precond_ec_update(t, t, t, c, m.bfloat16(), seed=1, **h),
        "minv_shape": lambda: ops.fused_precond_ec_update(t, t, t, c, m[0], seed=1, **h),
        "minv_strided": lambda: ops.fused_precond_ec_update(
            t, t, t, c, torch.ones(8, 2).t(), seed=1, **h),
        "minv_device": lambda: ops.fused_precond_ec_update(t, t, t, c, m.to("meta"), seed=1, **h),
        "no_noise": lambda: ops.fused_precond_ec_update(t, t, t, c, m, **h),
        "dtype_mix": lambda: ops.fused_precond_ec_update(t, t.bfloat16(), t, c, m, seed=1, **h),
        "c_shape": lambda: ops.fused_precond_ec_update(t, t, t, torch.zeros(3), m, seed=1, **h),
    }


@pytest.mark.parametrize("case", sorted(_guard_cases()))
def test_precond_wrapper_guards(case):
    with pytest.raises(ValueError):
        _guard_cases()[case]()


def test_precond_tree_in_place_and_launch_count():
    o = _operands(4, shape=(2, 4, 1024))
    args = [_t(o[k]) for k in ("theta", "p", "g")] + [_t(o["c"][0]), _t(o["minv"])]
    bits = (_t(o["b1"]), _t(o["b2"]))
    before = dict(ops.launches)
    _, want = ops.fused_precond_ec_update(*args, bits=bits, **HYPERS[0])
    tree = lambda x: {"x": x}
    p = args[1]
    new_p = ops.fused_precond_ec_update_tree(*map(tree, args), bits=tree(bits), **HYPERS[0])
    assert new_p["x"] is p and torch.equal(p, want)
    assert ops.launches == before  # the CPU path launches no kernel


# --- preconditioners -------------------------------------------------------------

FAMILIES = ["rmsprop", "adam"]


def _grads(shape, n, seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    return [(scale * r.normal(size=shape)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("name", FAMILIES)
def test_minv_strictly_positive(name):
    pre = core.get_preconditioner(name, burnin=8, decay=0.9, eps=1e-8)
    state = pre.init(torch.zeros(4, 3))
    for g in _grads((4, 3), 20, seed=1, scale=10.0) + [np.zeros((4, 3), np.float32)] * 3:
        minv, state = pre.update(state, torch.from_numpy(g))
        assert torch.isfinite(minv).all() and (minv > 0).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_minv_bit_frozen_after_burnin(name):
    burnin = 6
    pre = core.get_preconditioner(name, burnin=burnin, decay=0.9, eps=1e-8)
    state = pre.init(torch.zeros(2, 4))
    v0 = state.v.clone()
    frozen = None
    for t, g in enumerate(_grads((2, 4), burnin + 10, seed=5, scale=3.0)):
        minv, state = pre.update(state, torch.from_numpy(g))
        if t == 0:
            assert not torch.equal(state.v, v0), "V̂ must move before burn-in"
        if t == burnin:
            frozen, frozen_v = minv.clone(), state.v.clone()
        elif t > burnin:
            assert torch.equal(minv, frozen) and torch.equal(state.v, frozen_v)
    if name == "rmsprop":  # frozen_mass_inv reproduces the update's M⁻¹
        assert torch.equal(core.frozen_mass_inv(state, eps=1e-8), frozen)


def test_update_leaf_writes_v_in_place_like_the_tree_form():
    pre = core.rmsprop_preconditioner(decay=0.9, burnin=3)
    params = {"a": torch.zeros(2, 3), "b": torch.zeros(5)}
    tree_state, leaf_v = pre.init(params), pre.init(params).v
    for t, g in enumerate(_grads((2, 3), 5, seed=2)):
        grads = {"a": torch.from_numpy(g), "b": torch.from_numpy(g[0, :2].repeat(3)[:5])}
        minv, tree_state = pre.update(tree_state, grads)
        for k in ("a", "b"):
            before = leaf_v[k]
            m, v = pre.update_leaf(leaf_v[k], grads[k], t)
            assert v is before and torch.equal(m, minv[k]) and torch.equal(v, tree_state.v[k])


@pytest.mark.parametrize("name", FAMILIES)
def test_preconditioners_match_reference(name):
    """RMSProp bit for bit; Adam's bias correction takes numpy's f32 pow,
    XLA's differs in the last place, so it is held at rtol 1e-6."""
    jp = jcore.get_preconditioner(name, burnin=5, decay=0.9, eps=1e-8)
    tp = core.get_preconditioner(name, burnin=5, decay=0.9, eps=1e-8)
    js, ts = jp[0](jnp.zeros((3, 4))), tp.init(torch.zeros(3, 4))
    for g in _grads((3, 4), 8, seed=6, scale=2.0):
        jm, js = jp[1](js, jnp.asarray(g))
        tm, ts = tp.update(ts, torch.from_numpy(g))
        np.testing.assert_array_equal(_np(ts.v), np.asarray(js.v))
        if name == "rmsprop":
            np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        else:
            np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-6)
        assert ts.step == int(js.step)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown preconditioner"):
        core.get_preconditioner("nesterov", burnin=1, decay=0.9, eps=1e-8)


# --- identity preconditioning is bit-exact ------------------------------------------

PREC = torch.tensor([3.0, 0.5])
STEPS = 30
IDENTITY = dict(decay=1.0, precond_eps=0.0, burnin=10)  # V̂ ≡ 1, M⁻¹ ≡ 1.0


def _grad(th):
    return PREC * (th - 0.7) if th.shape[-1] == 2 else 1.3 * (th - 0.7)


def _traj(sampler, shape=(4, 2), seed=0):
    params = torch.from_numpy(np.random.default_rng(11).normal(size=shape).astype(np.float32))
    state = sampler.init(params)
    out = []
    for k in rng.split(rng.key(seed), STEPS):
        upd, state = sampler.update(_grad(params), state, params, k)
        params = core.apply_updates(params, upd)
        out.append(params.clone())
    return torch.stack(out)


def test_sa_ec_sghmc_equals_ec_sghmc():
    kw = dict(step_size=0.05, alpha=1.0, friction=1.0, center_friction=1.0, sync_every=4,
              noise_convention="eq6", center_noise_in_p=True)
    assert torch.equal(_traj(core.scale_adapted_ec_sghmc(**kw, **IDENTITY)),
                       _traj(core.ec_sghmc(mass=1.0, **kw)))


def test_sa_ec_sghmc_equals_ec_sghmc_fused():
    kw = dict(step_size=0.05, alpha=0.7, sync_every=2, fused=True)
    assert torch.equal(_traj(core.scale_adapted_ec_sghmc(**kw, **IDENTITY), shape=(2, 128)),
                       _traj(core.ec_sghmc(mass=1.0, **kw), shape=(2, 128)))


def test_sa_sghmc_equals_sghmc():
    kw = dict(step_size=0.05, friction=1.5, noise_convention="eq4")
    assert torch.equal(_traj(core.scale_adapted_sghmc(**kw, **IDENTITY)),
                       _traj(core.sghmc(mass=1.0, **kw)))


def test_psgld_equals_sgld():
    kw = dict(step_size=0.05, temperature=0.8)
    assert torch.equal(_traj(core.preconditioned_sgld(**kw, **IDENTITY)), _traj(core.sgld(**kw)))


def test_identity_minv_is_exactly_one():
    pre = core.rmsprop_preconditioner(decay=1.0, eps=0.0, burnin=10)
    st = pre.init(torch.zeros(3, 5))
    for value in (7.3, -123.4):
        minv, st = pre.update(st, torch.full((3, 5), value))
        assert (minv == 1.0).all()


# --- the samplers against the reference, noise handed in ------------------------------


def _params(seed, chains=K):
    r = np.random.default_rng(seed)
    return {"a": (MU + r.normal(size=(chains, 3, 5))).astype(np.float32),
            "b": {"w": (MU + r.normal(size=(chains, 1001))).astype(np.float32)}}


def _jgrad(params):
    return jax.tree.map(lambda t: 2.0 * (t - MU) * jnp.arange(1, t.shape[-1] + 1) / t.shape[-1],
                        params)


def _tgrad(params):
    return core.tree_util.tree_map(
        lambda t: 2.0 * (t - MU) * torch.arange(1, t.shape[-1] + 1) / t.shape[-1], params)


def _close(a, b, atol=ATOL, rtol=0.0, what=""):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_np(x), np.asarray(y), atol=atol, rtol=rtol, err_msg=what)


# V̂ ~ g² is held relatively: the gradients inherit the params' 2e-6
V_RTOL = 1e-5


def _fused_bits(k_p, params):
    """The per-leaf (bits1, bits2) the reference's fused dispatch draws
    (``kernels/ops.py:140`` then ``:119-120``), as int32 tensors."""
    leaves, treedef = jax.tree.flatten(params)
    out = []
    for leaf, kk in zip(leaves, jax.random.split(k_p, len(leaves))):
        rows = -(-leaf.size // 8192) * 8
        b = [np.asarray(jax.random.bits(k, (rows, 1024), jnp.uint32)).reshape(-1)[:leaf.size]
             for k in jax.random.split(kk)]
        out.append(tuple(torch.from_numpy(x.view(np.int32).copy()) for x in b))
    return jax.tree.unflatten(treedef, out)


def _tree_np(tree):
    return _interop.tree_from_numpy(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("s", [1, 4])
def test_sa_ec_sghmc_matches_reference(fused, s):
    """Eight steps across the burn-in freeze (burnin 5) and the syncs."""
    kw = dict(step_size=0.05, alpha=1.0, sync_every=s, burnin=5, decay=0.9, fused=fused)
    jsamp, tsamp = jcore.scale_adapted_ec_sghmc(**kw), core.scale_adapted_ec_sghmc(**kw)
    jparams = jax.tree.map(jnp.asarray, _params(3))
    params = _interop.tree_from_numpy(_params(3))
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    for t in range(8):
        kt = jax.random.fold_in(jax.random.PRNGKey(11), t)
        k_p, k_r = jax.random.split(kt)
        noise = {"r": _tree_np(jtu.tree_random_normal(k_r, jstate.center_momentum, jnp.float32)),
                 "p": _fused_bits(k_p, jparams) if fused else
                 _tree_np(jtu.tree_random_normal(k_p, jstate.momentum, jnp.float32))}
        jup, jstate = jsamp.update(_jgrad(jparams), jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        up, state = tsamp.update(_tgrad(params), state, params, None, noise=noise)
        params = core.apply_updates(params, up)
        for name in ("momentum", "center", "center_momentum", "center_stale", "mean_theta_stale"):
            _close(getattr(state, name), getattr(jstate, name), what=f"step {t} {name}")
        _close(state.precond.v, jstate.precond.v, atol=0.0, rtol=V_RTOL, what=f"step {t} V̂")
        _close(params, jparams, what=f"step {t} params")
        assert state.step == int(jstate.step) and state.precond.step == int(jstate.precond.step)
    jst, st = jsamp.stats(jstate, jparams), tsamp.stats(state, params)
    assert set(st) == set(jst)
    for k in set(st) - {"step"}:
        np.testing.assert_allclose(float(st[k]), float(jst[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("which", ["sa_sghmc", "psgld", "psgld_adam"])
def test_single_chain_samplers_match_reference(which):
    make = {
        "sa_sghmc": lambda c: c.scale_adapted_sghmc(step_size=0.05, friction=1.3, burnin=4,
                                                    decay=0.9),
        "psgld": lambda c: c.preconditioned_sgld(step_size=0.02, temperature=0.8, burnin=4,
                                                 decay=0.9),
        "psgld_adam": lambda c: c.preconditioned_sgld(step_size=0.02, burnin=4, decay=0.99,
                                                      precond="adam"),
    }[which]
    jsamp, tsamp = make(jcore), make(core)
    jparams = jax.tree.map(jnp.asarray, _params(5, chains=2))
    params = _interop.tree_from_numpy(_params(5, chains=2))
    jstate, state = jsamp.init(jparams), tsamp.init(params)
    for t in range(7):
        kt = jax.random.PRNGKey(100 + t)
        target = jstate.momentum if which == "sa_sghmc" else jparams
        noise = _tree_np(jtu.tree_random_normal(kt, target, jnp.float32))
        jup, jstate = jsamp.update(_jgrad(jparams), jstate, jparams, kt)
        jparams = jtu.apply_updates(jparams, jup)
        up, state = tsamp.update(_tgrad(params), state, params, None, noise=noise)
        params = core.apply_updates(params, up)
        _close(params, jparams, what=f"step {t} params")
        _close(state.precond.v, jstate.precond.v, atol=0.0, rtol=V_RTOL, what=f"step {t} V̂")
    jst, st = jsamp.stats(jstate, jparams), tsamp.stats(state, params)
    for k in set(st) - {"step"}:
        np.testing.assert_allclose(float(st[k]), float(jst[k]), rtol=1e-5, err_msg=k)


# --- FeedbackESS -------------------------------------------------------------------


def test_feedback_frozen_matches_constant_schedule():
    fb = core.feedback_ess(3e-3, target_ess_rate=0.1, freeze_at=0)
    fb.update(1e9, step=0)  # past freeze_at: freezes without moving
    for t in (0, 1, 17, 10_000):
        got = fb(t)
        assert isinstance(got, np.float32) and got == core.constant(3e-3)(t)


def test_feedback_frozen_update_is_noop():
    fb = core.feedback_ess(1e-2, target_ess_rate=0.5)
    fb.freeze()
    before = fb.value
    for rate in (0.0, 0.25, 5.0):
        assert fb.update(rate) == before
    assert fb.value == before


def test_feedback_moves_toward_target_and_respects_bounds():
    fb = core.feedback_ess(1e-2, target_ess_rate=0.5, gain=0.5)
    v0 = fb.value
    fb.update(0.05)  # mixing too slow -> grow eps
    assert fb.value > v0
    v1 = fb.value
    fb.update(5.0)  # mixing plenty -> shrink back
    assert fb.value < v1
    fb = core.feedback_ess(1e-2, target_ess_rate=0.5, gain=10.0, bounds=(0.5, 2.0))
    for _ in range(50):
        fb.update(0.0)
    assert fb.value == pytest.approx(2e-2)
    for _ in range(50):
        fb.update(100.0)
    assert fb.value == pytest.approx(5e-3)
    assert core.as_schedule(fb) is fb


def test_feedback_matches_reference_controller():
    kw = dict(gain=0.7, bounds=(0.2, 5.0), freeze_at=40)
    jfb, tfb = jcore.feedback_ess(2e-3, 0.3, **kw), core.feedback_ess(2e-3, 0.3, **kw)
    rates = np.random.default_rng(8).uniform(0.0, 1.0, size=12)
    for i, r in enumerate(rates):
        assert tfb.update(r, step=5 * i) == jfb.update(r, step=5 * i)
        assert tfb(i) == np.float32(jfb(jnp.int32(i)))
    assert tfb.frozen == jfb.frozen


# --- the executor's adapt hook --------------------------------------------------------

ESTEPS = 96
TARGET = torch.tensor([2.0, -1.0])


def _grad_u(p):
    return p - TARGET


def _start():
    return torch.zeros(4, 2)


def test_value_updates_rebuild_the_sampler_per_chunk():
    calls, boundaries = [], []

    def factory(h):
        calls.append(float(h["eps"]))
        return core.sgld(step_size=h["eps"])

    def adapt(step_end, carry, h):
        assert set(carry) == {"params", "state", "t", "wf", "ess"} and carry["t"] == step_end
        boundaries.append(step_end)
        return {"eps": np.float32(1e-2 / (1.0 + len(boundaries)))}

    ex = ChainExecutor(sampler_factory=factory, grad_fn=lambda t, _b: _grad_u(t),
                       trace_fn=lambda p: p, chunk_steps=16, key_mode="keys")
    p0 = _start()
    res = ex.run(p0, core.sgld(step_size=1e-2).init(p0), num_steps=ESTEPS,
                 keys=rng.split(rng.key(40), ESTEPS), hyper={"eps": np.float32(1e-2)},
                 sweep=False, adapt_fn=adapt)
    assert res.steps == ESTEPS
    assert boundaries == list(range(16, ESTEPS, 16))  # every boundary but the last
    assert calls == [np.float32(1e-2 / (1.0 + i)) for i in range(ESTEPS // 16)]


def test_noop_adapter_bit_identical_chunked_vs_unchunked():
    def factory(h):
        return core.ec_sghmc(step_size=h["eps"], alpha=1.0, sync_every=4)

    keys = rng.split(rng.key(41), ESTEPS)
    outs = []
    for chunk, adapt in ((ESTEPS, None), (16, lambda s, c, h: {"eps": h["eps"]})):
        ex = ChainExecutor(sampler_factory=factory, grad_fn=lambda t, _b: _grad_u(t),
                           trace_fn=lambda p: p, chunk_steps=chunk, key_mode="keys")
        p0 = _start()
        hyper = {"eps": np.float32(1e-2)}
        res = ex.run(p0, factory(hyper).init(p0), num_steps=ESTEPS, keys=keys, hyper=hyper,
                     sweep=False, adapt_fn=adapt)
        outs.append(res.trace)
    assert torch.equal(outs[0], outs[1])


def test_adapted_value_reaches_the_dynamics():
    ex = ChainExecutor(sampler_factory=lambda h: core.sgld(step_size=h["eps"]),
                       grad_fn=lambda t, _b: _grad_u(t), trace_fn=lambda p: p,
                       chunk_steps=16, key_mode="keys")
    p0 = _start()
    res = ex.run(p0, core.sgld(step_size=1e-2).init(p0), num_steps=ESTEPS,
                 keys=rng.split(rng.key(42), ESTEPS), hyper={"eps": np.float32(1e-2)},
                 sweep=False, adapt_fn=lambda s, c, h: {"eps": np.float32(0.0)})
    traj = res.trace
    assert not torch.equal(traj[0], traj[15])  # moved while eps > 0
    assert torch.equal(traj[16:], traj[16].expand_as(traj[16:]))


def test_ess_feedback_adapter_closes_the_loop():
    controller = core.feedback_ess(1e-2, target_ess_rate=0.9, gain=0.5)
    ex = ChainExecutor(
        sampler_factory=lambda h: core.sghmc(step_size=h["step_size"], friction=1.0),
        grad_fn=lambda t, _b: _grad_u(t), chunk_steps=256, key_mode="keys",
        ess_probe_fn=lambda p: p[0], ess_batch_len=32)
    n = 1024
    p0 = _start()
    res = ex.run(p0, core.sghmc(step_size=1e-2).init(p0), num_steps=n,
                 keys=rng.split(rng.key(43), n), hyper={"step_size": np.float32(controller.eps0)},
                 sweep=False, adapt_fn=ess_feedback_adapter(controller))
    assert res.steps == n
    # an ESS rate of 0.9/step is unattainable -> the controller grew eps
    assert controller.value > controller.eps0
    assert controller.lo <= controller.value <= controller.hi


def test_adapter_requires_ess_probe():
    ex = ChainExecutor(
        sampler_factory=lambda h: core.sghmc(step_size=h["step_size"], friction=1.0),
        grad_fn=lambda t, _b: _grad_u(t), chunk_steps=16, key_mode="keys")
    p0 = _start()
    with pytest.raises(ValueError, match="ess_probe_fn"):
        ex.run(p0, core.sghmc(step_size=1e-2).init(p0), num_steps=ESTEPS,
               keys=rng.split(rng.key(44), ESTEPS), hyper={"step_size": np.float32(1e-2)},
               sweep=False, adapt_fn=ess_feedback_adapter(core.feedback_ess(1e-2, 0.5)))


def test_factory_needs_hyper():
    ex = ChainExecutor(sampler_factory=lambda h: core.sgld(step_size=h["eps"]),
                       grad_fn=lambda t, _b: _grad_u(t), key_mode="keys")
    with pytest.raises(ValueError, match="needs hyper"):
        ex.run(_start(), core.sgld(1e-2).init(_start()), num_steps=1, keys=[1], sweep=False)


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_center_mass_is_the_reference_chain_mean(k):
    """M_c⁻¹: the sum in chain order times f32(1/K) equals ``jnp.mean``
    over the chain axis on the CPU bit for bit."""
    from repro_torch.core.scale_adapted import _chain_mean

    x = np.exp(np.random.default_rng(k).normal(size=(k, 3, 1001))).astype(np.float32)
    np.testing.assert_array_equal(_np(_chain_mean(torch.from_numpy(x))),
                                  np.asarray(jnp.mean(jnp.asarray(x), axis=0)))


# --- on the card (skipped without one; chip_smoke.py is the card's check) ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; chip_smoke.py runs these checks on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_precond_kernel_matches_plain_version(card):
    o = _operands(21, shape=(K, 1001))
    args = [_t(o[k]).to(card) for k in ("theta", "p", "g")]
    c, minv = _t(o["c"][0]).to(card), _t(o["minv"]).to(card)
    bits = (_t(o["b1"]).to(card), _t(o["b2"]).to(card))
    hyper = HYPERS[1]
    t_k, p_k = ops.fused_precond_ec_update(*args, c, minv, bits=bits, **hyper)
    t_r, p_r = ref.fused_precond_ec_update(*args, c, minv, *bits,
                                           scalars=ref.precond_scalars(**hyper),
                                           stochastic_round=True)
    assert torch.equal(t_k, t_r) and torch.equal(p_k, p_r)
    one = torch.ones_like(minv)
    a = ops.fused_precond_ec_update(*args, c, one, seed=7, leaf=1, step=3, **hyper)
    b = ops.fused_ec_update(*args, c, mass=1.0, seed=7, leaf=1, step=3, **hyper)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
