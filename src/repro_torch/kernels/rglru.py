"""Binding of the hand-written RG-LRU scan kernels (``csrc/rglru.cu``): the
forward, which replaces the Pallas kernel
``repro/kernels/rglru.py::_rglru_kernel``, and its backward, a reverse-time
scan of the same shape.  Call them through ``ops.rglru_scan``, which checks
the arguments and carries the gradient."""
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


def _bwd_fn():
    fn = _build.library("rglru").rglru_scan_bwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _P]
    fn.restype = _I
    return fn


def _ptr(t):
    return t.data_ptr() if t is not None else None


def launch(a, x, h0, out) -> None:
    """a, x (B, S, R) contiguous CUDA tensors of one dtype (f32 or bf16);
    h0 (B, R) f32 or None; out (B, S, R) f32."""
    B, S, R = a.shape
    rc = _fn()(
        a.data_ptr(), x.data_ptr(), _ptr(h0), out.data_ptr(),
        B, S, R, int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "rglru_scan")


def launch_bwd(a, h, dh, h0, da, dx, dh0) -> None:
    """The backward: a, h (the forward's output), dh (B, S, R) contiguous
    f32 CUDA tensors; h0 (B, R) f32 or None; writes da, dx (B, S, R) f32
    and, where h0 is given, dh0 (B, R) f32."""
    B, S, R = a.shape
    rc = _bwd_fn()(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), _ptr(h0), da.data_ptr(), dx.data_ptr(),
        _ptr(dh0), B, S, R, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "rglru_scan_bwd")
