"""Binding of the hand-written fused EC-SGHMC update kernel
(``csrc/fused_ecsghmc.cu``), which replaces the Pallas kernel
``repro/kernels/fused_ecsghmc.py::_kernel``.  Call it through
``ops.fused_ec_update``, which checks the arguments and forms the
scalars."""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _LL, _ULL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float)


def _fn():
    fn = _build.library("fused_ecsghmc").fused_ec_update
    fn.argtypes = [_P] * 8 + [_LL, _LL, _I, _I, _I, _ULL, _U, _ULL] + [_F] * 5 + [_P]
    fn.restype = _I
    return fn


def launch(theta, p, g, c, bits1, bits2, theta_out, p_out, *, K, N, seed, leaf, step, scalars,
           stochastic_round):
    """All tensors contiguous on one CUDA device: theta, p, theta_out, p_out
    (K, N) in one dtype (f32 or bf16), g f32 like theta, c (N,) in theta's
    dtype, bits1/bits2 int32 like theta or both None (Philox mode)."""
    ptrs = [t.data_ptr() for t in (theta, p, g, c, theta_out, p_out)]
    if bits1 is not None:
        ptrs += [bits1.data_ptr(), bits2.data_ptr()]
    vec = N % 4 == 0 and all(x % 16 == 0 for x in ptrs)
    rc = _fn()(
        theta.data_ptr(), p.data_ptr(), g.data_ptr(), c.data_ptr(),
        bits1.data_ptr() if bits1 is not None else None,
        bits2.data_ptr() if bits2 is not None else None,
        theta_out.data_ptr(), p_out.data_ptr(), K, N, int(theta.dtype == torch.bfloat16),
        int(bool(stochastic_round)), int(vec), seed, leaf, step, *scalars,
        torch.cuda.current_stream(theta.device).cuda_stream,
    )
    _build.check(rc, "fused_ec_update")
