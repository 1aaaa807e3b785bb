"""The RG-LRU scan's gradient on the CPU: the port's ``torch.autograd.Function``
(``repro_torch.kernels.ops.rglru_scan``) against autograd through the plain
forward loop and against the reference's ``jax.vjp``, and the SMOKE
recurrentgemma training gradient against ``jax.grad`` of the reference's.

On a CPU tensor the Function's backward is the backward kernel's plain
version, ``repro_torch.kernels.ref.rglru_scan_bwd``; ``chip_smoke.py`` holds
the CUDA kernel against it bit for bit on the card.  Against autograd
through the plain forward loop the Function is bitwise except for the sign
of exact zeros: autograd sums each step's slice gradient into zeros, and
-0.0 + 0.0 is +0.0, where the reverse scan keeps g_0 * 0 = -0.0 (da at
t = 0 without h0, whenever g_0 < 0).  The reference's scan is
``jax.lax.associative_scan``, so its gradient sums in another order: the
tolerance is the reference suite's (``tests/test_kernels.py::TestRGLRU``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.kernels import ref as jref
from repro_torch.kernels import launches, ops, ref

RTOL = ATOL = 1e-5  # the reference suite's (tests/test_kernels.py::TestRGLRU)

CASES = {
    "b2_s64_r16": (2, 64, 16, False),
    "b2_s64_r16_h0": (2, 64, 16, True),
    "b1_s300_r7_h0": (1, 300, 7, True),
    "b3_s1_r5": (3, 1, 5, False),
    "b3_s33_r40_h0": (3, 33, 40, True),
}


def _inputs(seed, B, S, R, h0=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, R)).astype(np.float32)
    x = rng.standard_normal((B, S, R)).astype(np.float32)
    dh = rng.standard_normal((B, S, R)).astype(np.float32)
    h = rng.standard_normal((B, R)).astype(np.float32) if h0 else None
    return a, x, dh, h


def _leaves(a, x, h0):
    return [torch.tensor(v, requires_grad=True) for v in (a, x, h0) if v is not None]


def _assert_bitwise_but_zero_sign(got, want):
    assert torch.equal(got, want)
    differ = got.view(torch.int32) != want.view(torch.int32)
    assert (got[differ] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_autograd_through_plain_loop(case):
    a, x, dh, h0 = _inputs(1, *CASES[case])
    leaves = _leaves(a, x, h0)
    before = dict(launches)
    got = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, torch.tensor(dh))
    assert launches == before  # the plain versions ran; no kernel was counted
    leaves2 = _leaves(a, x, h0)
    want = torch.autograd.grad(ref.rglru_scan(*leaves2), leaves2, torch.tensor(dh))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _assert_bitwise_but_zero_sign(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_is_the_function_backward(case):
    """The Function's gradient is ``ref.rglru_scan_bwd`` of (a, h, dh, h0)
    bit for bit, and dh0 is None without h0."""
    a, x, dh, h0 = _inputs(2, *CASES[case])
    leaves = _leaves(a, x, h0)
    h = ops.rglru_scan(*leaves)
    got = torch.autograd.grad(h, leaves, torch.tensor(dh))
    want = ref.rglru_scan_bwd(torch.tensor(a), h.detach(), torch.tensor(dh),
                              None if h0 is None else torch.tensor(h0))
    assert (want[2] is None) == (h0 is None)
    for g, w in zip(got, [w for w in want if w is not None]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_reference_vjp(case):
    a, x, dh, h0 = _inputs(3, *CASES[case])
    args = [jnp.asarray(v) for v in (a, x, h0) if v is not None]
    _, vjp = jax.vjp(jax.jit(jref.rglru_scan), *args)
    want = vjp(jnp.asarray(dh))
    leaves = _leaves(a, x, h0)
    got = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, torch.tensor(dh))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.float16, torch.float32),
                                    (torch.float32, torch.bfloat16)])
def test_gradients_come_back_in_each_input_dtype(dtypes):
    """a and x of any float type: the scan runs in f32 and each gradient is
    the f32 one cast to its input's dtype; h0's comes back in h0's."""
    a, x, dh, h0 = _inputs(4, 2, 20, 8, True)
    at = torch.tensor(a).to(dtypes[0]).requires_grad_()
    xt = torch.tensor(x).to(dtypes[1]).requires_grad_()
    ht = torch.tensor(h0).to(torch.bfloat16).requires_grad_()
    ga, gx, gh = torch.autograd.grad(ops.rglru_scan(at, xt, ht), [at, xt, ht], torch.tensor(dh))
    assert (ga.dtype, gx.dtype, gh.dtype) == (dtypes[0], dtypes[1], torch.bfloat16)
    h = ref.rglru_scan(at.detach(), xt.detach(), ht.detach())
    da, dx, dh0 = ref.rglru_scan_bwd(at.detach(), h, torch.tensor(dh), ht.detach())
    assert torch.equal(ga, da.to(dtypes[0])) and torch.equal(gx, dx.to(dtypes[1]))
    assert torch.equal(gh, dh0.to(torch.bfloat16))


def test_only_the_inputs_that_need_it_get_a_gradient():
    a, x, dh, _ = _inputs(5, 1, 10, 4)
    at, xt = torch.tensor(a), torch.tensor(x, requires_grad=True)
    (gx,) = torch.autograd.grad(ops.rglru_scan(at, xt), [xt], torch.tensor(dh))
    assert torch.equal(gx, ref.rglru_scan_bwd(at, ref.rglru_scan(at, xt.detach()),
                                              torch.tensor(dh))[1])
    with torch.no_grad():
        assert not ops.rglru_scan(at, xt).requires_grad


def test_func_transforms():
    """``torch.func.grad`` works through the Function on the CPU; ``vmap``
    has no rule (a ctypes launch cannot run on batched tensors) and raises."""
    a, x, _, _ = _inputs(6, 2, 12, 3)
    at, xt = torch.tensor(a), torch.tensor(x)
    g = torch.func.grad(lambda x_: ops.rglru_scan(at, x_).sum())(xt)
    want = ref.rglru_scan_bwd(at, ref.rglru_scan(at, xt), torch.ones_like(xt))[1]
    assert torch.equal(g, want)
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(lambda a_: ops.rglru_scan(a_, a_))(at[None].expand(2, -1, -1, -1))


def test_smoke_train_gradient_matches_reference():
    """The SMOKE recurrentgemma ``train_nll`` gradient through the
    Function, leaf by leaf, against ``jax.grad`` of the reference's (whose
    block differentiates through ``associative_scan``), at
    ``torch_parity``'s tolerance."""
    s = tp.setup("recurrentgemma-2b", seed=3)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 24)).astype(np.int32)
    tp.check_grads(s, {"tokens": toks, "labels": labels}, jit=True)
