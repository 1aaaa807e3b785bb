"""Binding of the hand-written RG-LRU scan kernel (``csrc/rglru.cu``),
which replaces the Pallas kernel ``repro/kernels/rglru.py::_rglru_kernel``.
Call it through ``ops.rglru_scan``, which checks the arguments."""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn():
    fn = _build.library("rglru").rglru_scan_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _LL, _I, _I, _P]
    fn.restype = _I
    return fn


def launch(a, x, h0, out) -> None:
    """a, x (B, S, R) contiguous CUDA tensors of one dtype (f32 or bf16);
    h0 (B, R) f32 or None; out (B, S, R) f32."""
    B, S, R = a.shape
    rc = _fn()(
        a.data_ptr(), x.data_ptr(), h0.data_ptr() if h0 is not None else None, out.data_ptr(),
        B, S, R, int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "rglru_scan")
