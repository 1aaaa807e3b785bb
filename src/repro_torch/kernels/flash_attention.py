"""Binding of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``), which replaces the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``, at head dims 64, 128
and 256.  Call it through ``ops.flash_attention``, which checks the
arguments and zero-pads any head dim up to 256 to the next of those."""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
    fn.restype = _I
    return fn


def launch(q, k, v, out, *, causal, window, softcap, scale) -> None:
    """q, out (B, Hq, S, d); k, v (B, Hkv, S, d); contiguous CUDA tensors
    of one dtype (f32 or bf16), d in {64, 128, 256}."""
    B, Hq, S, d = q.shape
    rc = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, k.shape[1], S, d, int(q.dtype == torch.bfloat16),
        int(bool(causal)), int(window or 0), float(softcap or 0.0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_attention")
