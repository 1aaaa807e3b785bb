"""Binding of the hand-written BMA mixture + selection kernels
(``csrc/bma_select.cu``), which replace the Pallas kernel
``repro/kernels/bma_select.py::_bma_select_kernel``.  Call them through
``ops.fused_bma_select``, which checks the arguments and draws the Gumbel
noise."""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_K = 16  # members; the mixture pass keeps one logZ per member in shared memory

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = _build.library("bma_select").bma_select_fwd
    fn.argtypes = [_P] * 6 + [_I] * 5 + [_F, _I, _P]
    fn.restype = _I
    return fn


def launch(logits, gumbel, *, mode, temperature, top_k, chunk):
    """logits (K, S, V) contiguous f32 CUDA; gumbel (S, V) f32 or None when
    temperature <= 0.  Returns (tokens (S,) int32, logp (S, V) f32)."""
    K, S, V = logits.shape
    dev = logits.device
    logp = torch.empty((S, V), dtype=torch.float32, device=dev)
    tok = torch.empty((S,), dtype=torch.int32, device=dev)
    C = -(-V // chunk)
    # per-(slot, chunk) member (max, sum-exp) pairs, the row's (max, sum-exp)
    # pairs and argmax candidates, then one top-k threshold per slot
    scratch = torch.empty((S * C * (2 * K + 2 + 1) + S,), dtype=torch.float32, device=dev)
    iscratch = torch.empty((S * C,), dtype=torch.int32, device=dev)
    if gumbel is not None and (gumbel.shape != (S, V) or gumbel.dtype != torch.float32
                               or not gumbel.is_contiguous() or gumbel.device != dev):
        raise ValueError("gumbel must be a contiguous (S, V) f32 tensor on the logits' device")
    rc = _fn()(
        logits.data_ptr(), gumbel.data_ptr() if gumbel is not None else None,
        logp.data_ptr(), tok.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(),
        K, S, V, chunk, int(mode == "logprobs"), float(temperature), int(top_k),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "bma_select")
    return tok, logp
