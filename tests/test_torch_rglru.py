"""The port's RG-LRU scan on the CPU against the reference's.

On a CPU tensor ``repro_torch.kernels.ops.rglru_scan`` runs the kernel's
plain version (``repro_torch.kernels.ref.rglru_scan``, a sequential f32
loop).  These tests hold both against ``repro.kernels.ref.rglru_scan`` and,
at the shapes it accepts, against ``repro.kernels.ops.rglru_scan`` (the
Pallas kernel, in interpret mode on the CPU), on the same numpy inputs, at
the reference suite's tolerance (``tests/test_kernels.py::TestRGLRU``).
The CUDA kernels (the scan and its backward) run only on a card:
``chip_smoke.py`` holds them against the plain versions there, bit for bit,
and the ``cuda``-marked test below skips without one.  The gradient's CPU
tests are in ``test_torch_rglru_grad.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jkernels
from repro.kernels import ref as jref
from repro_torch.kernels import launches, ops, ref

RTOL = ATOL = 1e-5  # the reference suite's (tests/test_kernels.py::TestRGLRU)


def _inputs(seed, B, S, R, h0=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, R)).astype(np.float32)
    x = rng.standard_normal((B, S, R)).astype(np.float32)
    h = rng.standard_normal((B, R)).astype(np.float32) if h0 else None
    return a, x, h


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# Pallas takes these (S a multiple of min(256, S)); "ragged_r" has R = 200,
# which the reference's dispatch pads to 256.
PALLAS_CASES = {
    "b2_s64_r128": (2, 64, 128, False),
    "b1_s256_r256": (1, 256, 256, False),
    "b3_s128_r96": (3, 128, 96, False),
    "b2_s64_r128_h0": (2, 64, 128, True),
    "ragged_r_h0": (2, 32, 200, True),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_scan_matches_reference_kernel(case):
    B, S, R, with_h0 = PALLAS_CASES[case]
    a, x, h0 = _inputs(1, B, S, R, with_h0)
    plain = ref.rglru_scan(_t(a), _t(x), _t(h0)).numpy()
    got = ops.rglru_scan(_t(a), _t(x), _t(h0)).numpy()
    np.testing.assert_array_equal(got, plain)
    want_ref = np.asarray(jref.rglru_scan(_j(a), _j(x), _j(h0)))
    want_pallas = np.asarray(jkernels.rglru_scan(_j(a), _j(x), _j(h0)))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)
    assert launches["rglru_scan"] == 0  # the CPU path launches nothing


@pytest.mark.parametrize("B,S,R,with_h0", [(2, 300, 64, False), (1, 1000, 33, True),
                                           (3, 1, 17, True)])
def test_scan_at_lengths_pallas_refuses(B, S, R, with_h0):
    """S = 300 and 1000 are not multiples of the Pallas block (256): the
    port takes any S, and is held against the reference's plain scan."""
    a, x, h0 = _inputs(2, B, S, R, with_h0)
    got = ops.rglru_scan(_t(a), _t(x), _t(h0)).numpy()
    want = np.asarray(jref.rglru_scan(_j(a), _j(x), _j(h0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_version_is_the_unfused_sequential_loop():
    """The plain version rounds after the multiply and after the add, in
    order: bit for bit a numpy f32 loop (what the kernel's __fmul_rn and
    __fadd_rn compute)."""
    a, x, h0 = _inputs(3, 2, 50, 40, True)
    h = h0.copy()
    want = np.empty_like(a)
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + x[:, t]
        want[:, t] = h
    np.testing.assert_array_equal(ref.rglru_scan(_t(a), _t(x), _t(h0)).numpy(), want)


def test_carry_across_blocks():
    """a = 0.99, x = 0, h0 = 1 gives h_t = 0.99^(t+1): the initial state
    reaches every step (the reference's test_carry_across_blocks)."""
    B, S, R = 1, 128, 128
    a = torch.full((B, S, R), 0.99)
    out = ops.rglru_scan(a, torch.zeros(B, S, R), torch.ones(B, R))
    want = 0.99 ** np.arange(1, S + 1)
    np.testing.assert_allclose(out[0, :, 0].numpy(), want, rtol=1e-4)
    np.testing.assert_array_equal(out[0].numpy(), np.repeat(out[0, :, :1].numpy(), R, axis=1))


def test_bf16_inputs_scan_in_f32():
    a, x, h0 = _inputs(4, 2, 40, 24, True)
    ab, xb = torch.tensor(a).to(torch.bfloat16), torch.tensor(x).to(torch.bfloat16)
    got = ops.rglru_scan(ab, xb, torch.tensor(h0))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 24)
    torch.testing.assert_close(got, ref.rglru_scan(ab.float(), xb.float(), torch.tensor(h0)),
                               rtol=0, atol=0)
    want = np.asarray(jref.rglru_scan(jnp.asarray(ab.float().numpy()),
                                      jnp.asarray(xb.float().numpy()), jnp.asarray(h0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtypes", [("float16", "float16"), ("float16", "float32"),
                                    ("float32", "bfloat16"), ("bfloat16", "float16")])
def test_narrow_and_mixed_dtypes_match_reference(dtypes):
    """Any float a and x, as the reference takes them: both are widened to
    f32 (exactly, from f16 and bf16) before the scan."""
    a, x, h0 = _inputs(7, 2, 40, 24, True)
    at, xt = (torch.tensor(v).to(getattr(torch, d)) for v, d in zip((a, x), dtypes))
    got = ops.rglru_scan(at, xt, torch.tensor(h0))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 24)
    torch.testing.assert_close(got, ref.rglru_scan(at.float(), xt.float(), torch.tensor(h0)),
                               rtol=0, atol=0)
    want = np.asarray(jref.rglru_scan(jnp.asarray(at.float().numpy()),
                                      jnp.asarray(xt.float().numpy()), jnp.asarray(h0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_path_is_differentiable():
    """On the CPU the scan is differentiable (the reference trains through
    its scan): the gradient runs the plain reverse-time scan, as the card
    runs its backward kernel."""
    a, x, _ = _inputs(5, 1, 8, 4)
    at, xt = torch.tensor(a, requires_grad=True), torch.tensor(x, requires_grad=True)
    ops.rglru_scan(at, xt).sum().backward()
    assert at.grad is not None and torch.isfinite(xt.grad).all()


def _ax(B=1, S=4, R=3, dtype=torch.float32):
    return torch.zeros(B, S, R, dtype=dtype), torch.zeros(B, S, R, dtype=dtype)


RGLRU_GUARDS = {
    "mixed_device": lambda: (*(t.to(d) for t, d in zip(_ax(), ("cpu", "meta"))), None),
    "h0_on_other_device": lambda: (*_ax(), torch.zeros(1, 3, device="meta")),
    "rank": lambda: (torch.zeros(4, 3), torch.zeros(4, 3), None),
    "shape_mismatch": lambda: (torch.zeros(1, 4, 3), torch.zeros(1, 5, 3), None),
    # any float pair is taken (cast to f32); an integer input is not
    "dtype_mismatch": lambda: (torch.zeros(1, 4, 3), torch.zeros(1, 4, 3, dtype=torch.int32),
                               None),
    "unsupported_dtype": lambda: (*_ax(dtype=torch.int64), None),
    "h0_shape": lambda: (*_ax(), torch.zeros(1, 4)),
    "h0_integer": lambda: (*_ax(), torch.zeros(1, 3, dtype=torch.int32)),
    "non_contiguous": lambda: (torch.zeros(1, 3, 4).transpose(1, 2), torch.zeros(1, 4, 3), None),
}


@pytest.mark.parametrize("guard", sorted(RGLRU_GUARDS))
def test_rglru_guards(guard):
    with pytest.raises(ValueError):
        ops.rglru_scan(*RGLRU_GUARDS[guard]())


# ---------------------------------------------------------------------------
# on the card (skipped without one; chip_smoke.py is the card's check)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; chip_smoke.py runs these checks on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_bitwise(card):
    for B, S, R, with_h0 in ((1, 128, 2560, False), (3, 1000, 1000, True), (2, 7, 5, True)):
        a, x, h0 = (None if v is None else torch.tensor(v, device=card)
                    for v in _inputs(6, B, S, R, with_h0))
        before = launches["rglru_scan"]
        got = ops.rglru_scan(a, x, h0)
        assert launches["rglru_scan"] == before + 1
        assert torch.equal(got, ref.rglru_scan(a, x, h0))
    ab, xb = a.to(torch.bfloat16), x.to(torch.bfloat16)
    assert torch.equal(ops.rglru_scan(ab, xb, h0), ref.rglru_scan(ab, xb, h0))
    # f16, and a mixed pair, cast to f32 before the kernel
    for da, dx in ((torch.float16, torch.float16), (torch.float32, torch.bfloat16)):
        assert torch.equal(ops.rglru_scan(a.to(da), x.to(dx), h0),
                           ref.rglru_scan(a.to(da), x.to(dx), h0))
    # R = 77 in bf16 is not made of whole 16-byte pieces: tiles staged by plain loads
    a, x, h0 = (None if v is None else torch.tensor(v, device=card)
                for v in _inputs(8, 2, 300, 77, True))
    ab, xb = a.to(torch.bfloat16), x.to(torch.bfloat16)
    assert torch.equal(ops.rglru_scan(ab, xb, h0), ref.rglru_scan(ab, xb, h0))
    # the gradient runs the backward kernel, bit for bit the plain backward
    for B, S, R, with_h0 in ((4, 64, 2560, False), (2, 300, 77, True)):
        a, x, h0 = (None if v is None else torch.tensor(v, device=card, requires_grad=True)
                    for v in _inputs(9, B, S, R, with_h0))
        dh = torch.randn((B, S, R), device=card)
        h = ops.rglru_scan(a, x, h0)
        before = launches["rglru_scan_bwd"]
        got = torch.autograd.grad(h, [t for t in (a, x, h0) if t is not None], dh)
        assert launches["rglru_scan_bwd"] == before + 1
        want = ref.rglru_scan_bwd(a.detach(), h.detach(), dh, None if h0 is None else h0.detach())
        for g, w in zip(got, [w for w in want if w is not None]):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
