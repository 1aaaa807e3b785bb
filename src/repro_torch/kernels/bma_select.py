"""Binding of the hand-written BMA mixture + selection kernels
(``csrc/bma_select.cu``), which replace the Pallas kernel
``repro/kernels/bma_select.py::_bma_select_kernel``.  Call them through
``ops.fused_bma_select``, which checks the arguments and draws the Gumbel
noise."""
from __future__ import annotations

import ctypes

import torch

from . import _build

# mirrored from csrc/bma_select.cu
MAX_K = 16  # members; the mixture pass keeps one logZ per member in shared memory
CHUNK = 2048  # vocabulary elements per block
KCAP = 128  # largest top_k of the candidate scheme; above it, radix passes
WARPS = 8  # warps per block, each reporting its largest selection key
BINS = 256  # radix histogram bins
LIST = 4096  # candidates per slot

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _fn():
    fn = _build.library("bma_select").bma_select_fwd
    fn.argtypes = [_P] * 5 + [_LL] + [_I] * 4 + [_F, _I, _P]
    fn.restype = _I
    return fn


def scratch_words(K: int, S: int, V: int) -> int:
    """4-byte words of scratch one call takes.  Per (slot, chunk): K member
    (max, sum-exp) pairs, the chunk's argmax (value, index), its warps'
    largest keys and a radix histogram.  Per slot: a list of LIST
    candidates (key, value, index), the radix state and lower bound (4), the
    threshold, a block counter and the list's length."""
    C = -(-V // CHUNK)
    return S * C * (2 * K + 2 + WARPS + BINS) + S * (3 * LIST + 7)


def launch(logits, gumbel, *, mode, temperature, top_k):
    """logits (K, S, V) contiguous f32 CUDA; gumbel (S, V) f32 or None when
    temperature <= 0.  Returns (tokens (S,) int32, logp (S, V) f32)."""
    K, S, V = logits.shape
    dev = logits.device
    logp = torch.empty((S, V), dtype=torch.float32, device=dev)
    tok = torch.empty((S,), dtype=torch.int32, device=dev)
    n = scratch_words(K, S, V)
    scratch = torch.empty((n,), dtype=torch.int32, device=dev)
    if gumbel is not None and (gumbel.shape != (S, V) or gumbel.dtype != torch.float32
                               or not gumbel.is_contiguous() or gumbel.device != dev):
        raise ValueError("gumbel must be a contiguous (S, V) f32 tensor on the logits' device")
    rc = _fn()(
        logits.data_ptr(), gumbel.data_ptr() if gumbel is not None else None,
        logp.data_ptr(), tok.data_ptr(), scratch.data_ptr(), n,
        K, S, V, int(mode == "logprobs"), float(temperature), int(top_k),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "bma_select")
    return tok, logp
