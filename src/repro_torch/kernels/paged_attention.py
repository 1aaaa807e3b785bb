"""Binding of the hand-written paged-decode kernel
(``csrc/paged_attention.cu``), which replaces the Pallas kernel
``repro/kernels/paged_attention.py::_paged_kernel``.  Call it through
``ops.paged_attention``, which checks the arguments."""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = _build.library("paged_attention").paged_attention_fwd
    fn.argtypes = [_P] * 6 + [_I] * 8 + [_F, _F, _P]
    fn.restype = _I
    return fn


def launch(q, k_pages, v_pages, block_tables, context_lens, out, *, scale, window, softcap) -> None:
    """q, out (B, Hkv, G, d); pages (P, bs, Hkv, d) of q's dtype; tables
    (B, M) and context_lens (B,) int32; all contiguous CUDA tensors."""
    B, Hkv, G, d = q.shape
    rc = _fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        B, Hkv, G, d, k_pages.shape[1], block_tables.shape[1],
        int(q.dtype == torch.bfloat16), int(window or 0),
        float(softcap or 0.0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_attention")
