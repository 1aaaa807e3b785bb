"""Binding of the hand-written fused EC-SGHMC update kernels
(``csrc/fused_ecsghmc.cu``), which replace the Pallas kernels
``repro/kernels/fused_ecsghmc.py::_kernel`` (scalar mass) and
``::_precond_kernel`` (streamed diagonal M^-1).  Call them through
``ops.fused_ec_update`` / ``ops.fused_precond_ec_update``, which check the
arguments and form the scalars."""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _LL, _ULL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float)


def _fn(name: str, n_ptrs: int, n_scalars: int, chain_offset: bool):
    fn = getattr(_build.library("fused_ecsghmc"), name)
    fn.argtypes = ([_P] * n_ptrs + [_LL, _LL] + [_LL] * chain_offset + [_I, _I, _I, _ULL, _U, _ULL]
                   + [_F] * n_scalars + [_P])
    fn.restype = _I
    return fn


def _vec(N, *tensors) -> bool:
    """The 4-wide path: N % 4 == 0 and every pointer 16-byte aligned."""
    return N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def launch(theta, p, g, c, bits1, bits2, theta_out, p_out, *, K, N, seed, leaf, step, scalars,
           stochastic_round, chain_offset=0):
    """All tensors contiguous on one CUDA device: theta, p, theta_out, p_out
    (K, N) in one dtype (f32 or bf16), g f32 like theta, c (N,) in theta's
    dtype, bits1/bits2 int32 like theta or both None (Philox mode).
    ``chain_offset``: the global index of chain 0 (Philox counters)."""
    tensors = (theta, p, g, c, bits1, bits2, theta_out, p_out)
    rc = _fn("fused_ec_update", 8, 5, True)(
        *map(_ptr, tensors), K, N, int(chain_offset), int(theta.dtype == torch.bfloat16),
        int(bool(stochastic_round)), int(_vec(N, *tensors)), seed, leaf, step, *scalars,
        torch.cuda.current_stream(theta.device).cuda_stream,
    )
    _build.check(rc, "fused_ec_update")


def launch_precond(theta, p, g, minv, c, bits1, bits2, theta_out, p_out, *, K, N, seed, leaf,
                   step, scalars, stochastic_round):
    """As ``launch``, with ``minv`` (K, N) f32 and the four scalars of
    ``ref.precond_scalars``."""
    tensors = (theta, p, g, minv, c, bits1, bits2, theta_out, p_out)
    rc = _fn("fused_precond_ec_update", 9, 4, False)(
        *map(_ptr, tensors), K, N, int(theta.dtype == torch.bfloat16),
        int(bool(stochastic_round)), int(_vec(N, *tensors)), seed, leaf, step, *scalars,
        torch.cuda.current_stream(theta.device).cuda_stream,
    )
    _build.check(rc, "fused_precond_ec_update")
