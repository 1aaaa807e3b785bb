"""Dispatch wrappers for the hand-written kernels: argument guards, head-dim
padding, and device selection.  A CPU tensor goes to the plain version in
``ref``; a CUDA tensor goes to the CUDA kernel, or the call raises.  There
is no fallback from one to the other.

Each wrapper adds one to its entry in ``launches`` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels.

Each kernel's launch is a ``torch.library`` custom op (``repro_torch::<name>``,
``OPS``): on the card the wrappers call it, and its implementation
launches the kernel.  Its fake implementation gives the kernel's output
shapes, so fake tensors (the dry run, ``FakeTensorMode``) trace through
every wrapper, and meta tensors through the ops, with no launch and no
allocation.  The plain versions run on the CPU as before.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import ref

launches = {"flash_attention": 0, "paged_attention": 0, "bma_select": 0, "fused_ec_update": 0,
            "fused_precond_ec_update": 0, "rglru_scan": 0, "rglru_scan_bwd": 0}

_ATTN_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _abstract(*tensors) -> bool:
    """True for fake tensors (``FakeTensorMode``): the custom op's fake
    implementation then stands for the kernel."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in tensors)


def _on_card(*tensors) -> bool:
    """True for CUDA tensors and for fake tensors (the kernel's custom op
    then runs its fake form), False for CPU tensors; raises on a mix of
    devices or any other device type (meta tensors reach the custom ops,
    ``torch.ops.repro_torch.*``, directly)."""
    if _abstract(*tensors):
        return True
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cuda"


def _records_grad(*tensors) -> bool:
    """True when autograd would record a call on ``tensors``: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _require_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


FLASH_HEAD_DIMS = (64, 128, 256)  # instantiated in csrc/flash_attention.cu
PAGED_HEAD_DIMS = (64, 128)  # instantiated in csrc/paged_attention.cu


def _padded_head_dim(d: int, dims) -> int:
    """The smallest of a kernel's head dims ``dims`` that holds d; a smaller
    head is zero-padded to it."""
    for dp in dims:
        if 1 <= d <= dp:
            return dp
    raise ValueError(f"head_dim {d} not in [1, {dims[-1]}]")


def _binding(name: str):
    """The ctypes binding module ``kernels.<name>``.  ``from . import
    flash_attention`` could give the package's attribute of that name, which
    is this module's wrapper function until the submodule is first imported."""
    return importlib.import_module(f"{__package__}.{name}")


def _pad_last(x, dp: int):
    d = x.shape[-1]
    return x if d == dp else F.pad(x, (0, dp - d))


# --- flash attention ---------------------------------------------------------


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """(B, Hq, S, d) x (B, Hkv, S, d)^2 -> (B, Hq, S, d) in q's dtype.
    Pads d to 64, 128 or 256; the softmax scale keeps the ORIGINAL head
    dim.  The CUDA kernel has no backward, so on the card a call that
    autograd would record raises (its output would carry no gradient to q,
    k and v); the plain version on the CPU carries autograd."""
    on_card = _on_card(q, k, v)
    if on_card and _records_grad(q, k, v):
        raise NotImplementedError("the flash_attention kernel has no backward: call it under "
                                  "torch.no_grad(), or on inputs that do not require grad")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, d)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ATTN_DTYPES:
        raise ValueError(f"q/k/v dtypes must match and be f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    _require_contiguous(q=q, k=k, v=v)
    B, Hq, S, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, d):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    dp = _padded_head_dim(d, FLASH_HEAD_DIMS)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v = _pad_last(q, dp), _pad_last(k, dp), _pad_last(v, dp)
    if not on_card:
        out = ref.attention(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    else:
        out = torch.ops.repro_torch.flash_attention(q, k, v, causal, window, softcap, scale)
    return out[..., :d] if dp != d else out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int | None, softcap: float | None, scale: float) -> torch.Tensor:
    out = torch.empty_like(q)
    _binding("flash_attention").launch(q, k, v, out, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    launches["flash_attention"] += 1
    return out


@_flash_op.register_fake
def _(q, k, v, causal, window, softcap, scale):
    return torch.empty_like(q)


# --- paged attention (decode) ------------------------------------------------


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    *, scale=None, window=None, softcap=None):
    """q (B, Hkv, G, d) vs paged pool (num_pages, bs, Hkv, d) through
    (B, M) int32 block tables -> (B, Hkv, G, d).  Pads d to 64 or 128 (the
    softmax scale keeps the ORIGINAL head dim); context_lens (B,) int32 is
    the inclusive current position."""
    on_card = _on_card(q, k_pages, v_pages, block_tables, context_lens)
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.ndim != 4:
        raise ValueError("q must be (B, Hkv, G, d) and pages (P, bs, Hkv, d)")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in _ATTN_DTYPES:
        raise ValueError(f"q/page dtypes must match and be f32 or bf16, got {q.dtype}, {k_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables and context_lens must be int32")
    _require_contiguous(q=q, k_pages=k_pages, v_pages=v_pages,
                        block_tables=block_tables, context_lens=context_lens)
    B, Hkv, G, d = q.shape
    P, bs = k_pages.shape[:2]
    if v_pages.shape != k_pages.shape or k_pages.shape[2:] != (Hkv, d):
        raise ValueError(f"page shape {tuple(k_pages.shape)} does not match q {tuple(q.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("block_tables must be (B, M) and context_lens (B,)")
    if not 1 <= G <= 8 or not 1 <= bs <= 128:
        raise ValueError(f"kernel takes 1 <= G <= 8 and 1 <= block_size <= 128, got G={G}, bs={bs}")
    dp = _padded_head_dim(d, PAGED_HEAD_DIMS)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k_pages, v_pages = _pad_last(q, dp), _pad_last(k_pages, dp), _pad_last(v_pages, dp)
    if not on_card:
        out = ref.paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                                  scale=scale, window=window, softcap=softcap)
    else:
        out = torch.ops.repro_torch.paged_attention(q, k_pages, v_pages, block_tables,
                                                    context_lens, scale, window, softcap)
    return out[..., :d] if dp != d else out


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=())
def _paged_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              block_tables: torch.Tensor, context_lens: torch.Tensor, scale: float,
              window: int | None, softcap: float | None) -> torch.Tensor:
    out = torch.empty_like(q)
    _binding("paged_attention").launch(q, k_pages, v_pages, block_tables, context_lens, out,
                                       scale=scale, window=window, softcap=softcap)
    launches["paged_attention"] += 1
    return out


@_paged_op.register_fake
def _(q, k_pages, v_pages, block_tables, context_lens, scale, window, softcap):
    return torch.empty_like(q)


# --- RG-LRU scan --------------------------------------------------------------


def _scan_fwd(a, x, h0, on_card):
    """h (B, S, R) f32: the plain version on the CPU, the kernel on CUDA
    (a and x both f32 or both bf16; any other pair is cast to f32)."""
    if not on_card:
        return ref.rglru_scan(a, x, h0)
    if not (a.dtype == x.dtype and a.dtype in _ATTN_DTYPES):
        a, x = a.float(), x.float()
    return torch.ops.repro_torch.rglru_scan(a, x, h0)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _scan_op(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    from . import rglru as _rg

    _rg.launch(a, x, h0, out)
    launches["rglru_scan"] += 1
    return out


@_scan_op.register_fake
def _(a, x, h0):
    return torch.empty(a.shape, dtype=torch.float32, device=a.device)


def _scan_bwd(a, h, dh, h0, on_card):
    """(da, dx, dh0) f32, dh0 None without h0: the plain version on the
    CPU, the backward kernel on CUDA (a and dh cast to f32)."""
    if not on_card:
        return ref.rglru_scan_bwd(a, h, dh, h0)
    a, dh = a.float().contiguous(), dh.float().contiguous()
    da, dx, dh0 = torch.ops.repro_torch.rglru_scan_bwd(a, h, dh, h0)
    return da, dx, dh0 if h0 is not None else None


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _scan_bwd_op(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                 h0: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    da, dx = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0) if h0 is not None else a.new_empty((0,))
    if a.numel() == 0:
        return da, dx, dh0.zero_()
    from . import rglru as _rg

    _rg.launch_bwd(a, h, dh, h0, da, dx, dh0 if h0 is not None else None)
    launches["rglru_scan_bwd"] += 1
    return da, dx, dh0


@_scan_bwd_op.register_fake
def _(a, h, dh, h0):
    return (torch.empty_like(a), torch.empty_like(a),
            torch.empty_like(h0) if h0 is not None else a.new_empty((0,)))


class _RGLRUScan(torch.autograd.Function):
    """The scan with its gradient: forward and backward are the kernels on
    CUDA and their plain versions on the CPU.  Saves a and the output h;
    returns each gradient in its input's dtype.  It has no vmap rule (a
    ctypes launch cannot run on batched tensors), so ``torch.func.vmap``
    over it raises; ``torch.func.grad`` works on the CPU."""

    @staticmethod
    def forward(a, x, h0, on_card):
        return _scan_fwd(a, x, h0, on_card)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, x, h0, ctx.on_card = inputs
        ctx.save_for_backward(a, output, h0)
        ctx.x_dtype = x.dtype

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, dx, dh0 = _scan_bwd(a, h, dh, h0, ctx.on_card)
        need_a, need_x, need_h0, _ = ctx.needs_input_grad
        return (da.to(a.dtype) if need_a else None, dx.to(ctx.x_dtype) if need_x else None,
                dh0 if need_h0 else None, None)


def rglru_scan(a, x, h0=None):
    """The linear recurrence h_t = a_t * h_{t-1} + x_t over axis 1.  a, x:
    (B, S, R) of any float dtype, as the reference takes them; h0: (B, R) or
    None, the carry before step 0.  Returns h (B, S, R) f32.  The kernel
    reads a and x both f32 or both bf16; any other pair is cast to f32
    first, as the reference casts its inputs (f16 and bf16 widen to f32
    exactly).  Differentiable in a, x and h0: the backward runs the
    reverse-time kernel on the card (``launches["rglru_scan_bwd"]``)."""
    on_card = _on_card(*(t for t in (a, x, h0) if t is not None))
    if a.ndim != 3 or x.shape != a.shape:
        raise ValueError(f"a and x must be (B, S, R) of one shape, got {tuple(a.shape)}, "
                         f"{tuple(x.shape)}")
    if not (a.is_floating_point() and x.is_floating_point()):
        raise ValueError(f"a and x must be floating point, got {a.dtype}, {x.dtype}")
    B, _, R = a.shape
    if h0 is not None:
        if h0.shape != (B, R) or not h0.is_floating_point():
            raise ValueError(f"h0 must be a float tensor of shape {(B, R)}, got "
                             f"{h0.dtype} {tuple(h0.shape)}")
        h0 = h0.float().contiguous()
    _require_contiguous(a=a, x=x)
    if on_card and B > 65535:
        raise ValueError(f"kernel takes B <= 65535, got {B}")
    return _RGLRUScan.apply(a, x, h0, on_card)


# --- fused BMA mixture + selection -------------------------------------------


def fused_bma_select(logits, generator=None, *, mode="probs", temperature=0.0, top_k=0,
                     gumbel=None):
    """(K, S, V) member logits -> (tokens (S,) int32, mixture logp (S, V)
    f32) in one kernel.  The Gumbel draw happens HERE, from ``generator``,
    exactly as ``sampling.select_tokens`` draws it, so sampled tokens of
    the fused and unfused paths are bit-identical given the same mixture;
    ``gumbel`` (S, V) f32, when given, is the draw instead."""
    from repro_torch.serve.sampling import gumbel_noise

    if mode not in ("probs", "logprobs"):
        raise ValueError(f"mode must be 'probs' or 'logprobs', got {mode!r}")
    if logits.ndim != 3:
        raise ValueError(f"logits must be (K, S, V), got shape {tuple(logits.shape)}")
    K, S, V = logits.shape
    if K < 1 or S < 1 or V < 1:
        raise ValueError(f"need K, S, V >= 1, got {(K, S, V)}")
    if not logits.is_floating_point():
        raise ValueError(f"logits must be floating point, got {logits.dtype}")
    if top_k < 0:
        raise ValueError("top_k must be >= 0")
    _require_contiguous(logits=logits)
    on_card = _on_card(logits)
    logits = logits.float()
    if temperature <= 0.0:
        gumbel = None
    elif gumbel is None:
        if generator is None:
            raise ValueError("temperature > 0 sampling needs a generator")
        gumbel = gumbel_noise((S, V), generator, logits.device)
    elif tuple(gumbel.shape) != (S, V) or gumbel.dtype != torch.float32:
        raise ValueError(f"gumbel must be ({S}, {V}) float32, got {tuple(gumbel.shape)} "
                         f"{gumbel.dtype}")
    else:
        _require_contiguous(gumbel=gumbel)
        _on_card(logits, gumbel)
    if not on_card:
        return ref.bma_select(logits, gumbel, mode=mode, temperature=temperature, top_k=top_k)
    from . import bma_select as _bs

    if K > _bs.MAX_K:
        raise ValueError(f"kernel takes K <= {_bs.MAX_K} members, got {K}")
    return torch.ops.repro_torch.bma_select(logits, gumbel, mode, float(temperature),
                                            int(top_k))


@torch.library.custom_op("repro_torch::bma_select", mutates_args=())
def _bma_op(logits: torch.Tensor, gumbel: torch.Tensor | None, mode: str, temperature: float,
            top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    from . import bma_select as _bs

    tok, logp = _bs.launch(logits, gumbel, mode=mode, temperature=temperature, top_k=top_k)
    launches["bma_select"] += 1
    return tok, logp


@_bma_op.register_fake
def _(logits, gumbel, mode, temperature, top_k):
    _, S, V = logits.shape
    return (logits.new_empty((S,), dtype=torch.int32),
            logits.new_empty((S, V), dtype=torch.float32))


# --- fused EC-SGHMC update ---------------------------------------------------

_EC_DTYPES = (torch.float32, torch.bfloat16)


def _chain_layout(theta, c_tilde):
    """(K, N): chains and elements per chain.  c̃ is shaped like one chain
    (``theta.shape[1:]``) or like theta itself (K = 1)."""
    if c_tilde.shape == theta.shape:
        return 1, theta.numel()
    if theta.ndim >= 1 and c_tilde.shape == theta.shape[1:]:
        return int(theta.shape[0]), c_tilde.numel()
    raise ValueError(f"c_tilde shape {tuple(c_tilde.shape)} is neither theta's "
                     f"{tuple(theta.shape)} nor one chain of it")


def _ec_operands(theta, p, g, c_tilde, bits, seed, p_out, chain_offset=0):
    """The checks both fused updates share.  Returns (on_card, K, N, g in
    f32, bits1, bits2), the bits flat and contiguous, or both None in
    Philox mode, whose counters take the global element index (chains
    from ``chain_offset`` on)."""
    on_card = _on_card(theta, p, g, c_tilde)
    if (bits is None) == (seed is None):
        raise ValueError("pass exactly one of bits= (parity mode) or seed= (Philox mode)")
    if theta.dtype not in _EC_DTYPES or p.dtype != theta.dtype or c_tilde.dtype != theta.dtype:
        raise ValueError(f"theta, p and c_tilde must share one dtype of f32 or bf16, got "
                         f"{theta.dtype}, {p.dtype}, {c_tilde.dtype}")
    if p.shape != theta.shape or g.shape != theta.shape:
        raise ValueError(f"p {tuple(p.shape)} and g {tuple(g.shape)} must be shaped like "
                         f"theta {tuple(theta.shape)}")
    K, N = _chain_layout(theta, c_tilde)
    g = g.float()
    _require_contiguous(theta=theta, p=p, g=g, c_tilde=c_tilde)
    n = theta.numel()
    if p_out is not None and (p_out.shape != p.shape or p_out.dtype != p.dtype
                              or p_out.device != p.device or not p_out.is_contiguous()):
        raise ValueError("p_out must be a contiguous tensor like p")
    b1 = b2 = None
    if bits is not None:
        b1, b2 = bits
        for b in (b1, b2):
            if b.dtype != torch.int32 or b.numel() < n or b.device != theta.device:
                raise ValueError(f"bits must be int32 tensors of >= {n} elements on {theta.device}")
        b1, b2 = b1.reshape(-1)[:n].contiguous(), b2.reshape(-1)[:n].contiguous()
    elif not 0 <= int(seed) < 1 << 64:
        raise ValueError("seed must be a 64-bit key")
    elif chain_offset < 0 or ((chain_offset + K) * N + 1) // 2 > 1 << 32:
        raise ValueError(f"chains {chain_offset}..{chain_offset + K - 1} of {N} elements exceed "
                         "the Philox counter (2^33 elements)")
    return on_card, K, N, g, b1, b2


def _plain_bits(b1, b2, seed, leaf, step, shape, start=0):
    """The bits the plain version takes: the given ones, or the Philox bits
    of (seed, leaf, step) from global element ``start`` on, shaped like
    theta."""
    if b1 is None:
        n = math.prod(shape)
        h1, h2 = ref.philox_bits(int(seed), int(leaf), int(step), n, start)
        b1, b2 = torch.from_numpy(h1.view(np.int32)), torch.from_numpy(h2.view(np.int32))
    return b1.view(shape), b2.view(shape)


def fused_ec_update(theta, p, g, c_tilde, *, eps, friction, mass, alpha, sigma_p,
                    stochastic_round=True, bits=None, seed=None, leaf=0, step=0, p_out=None,
                    chain_offset=0):
    """One leaf's fused Eq. 6 update.  Returns (theta', p') in theta's and
    p's dtypes.

    Noise: ``bits=(bits1, bits2)``, int32 tensors of uint32 bit patterns
    with at least ``theta.numel()`` elements in the leaf's flat order
    (parity mode), or ``seed`` (a 64-bit key) for Philox bits countered by
    ``(leaf, step, global element)`` (production mode; on the CPU the plain
    version computes the same bits).  ``chain_offset``: the global index of
    theta's first chain when the chains are split over ranks; chain k's
    element j is global element ``(chain_offset + k) * N + j``, so the
    rank draws the unsplit run's noise of its chains.  ``p_out`` (p itself,
    for an in-place update) receives p'."""
    on_card, K, N, g, b1, b2 = _ec_operands(theta, p, g, c_tilde, bits, seed, p_out,
                                            int(chain_offset))
    scalars = ref.ec_scalars(eps, friction, 1.0 / mass, alpha, sigma_p)
    if theta.numel() == 0:
        return theta.clone(), (p_out if p_out is not None else p.clone())
    if not on_card:
        b1, b2 = _plain_bits(b1, b2, seed, leaf, step, theta.shape, int(chain_offset) * N)
        t_new, p_new = ref.fused_ec_update(theta, p, g, c_tilde, b1, b2, scalars=scalars,
                                           stochastic_round=stochastic_round)
        return t_new, (p_out.copy_(p_new) if p_out is not None else p_new)
    p_new = p_out if p_out is not None else torch.empty_like(p)
    seed = 0 if seed is None else int(seed)
    t_new = torch.ops.repro_torch.fused_ec_update(
        theta, p, g, c_tilde, b1, b2, p_new, K, N, seed >> 32, seed & 0xFFFFFFFF, int(leaf),
        int(step), [float(v) for v in scalars], stochastic_round, int(chain_offset))
    return t_new, p_new


@torch.library.custom_op("repro_torch::fused_ec_update", mutates_args=("p_new",))
def _fused_ec_op(theta: torch.Tensor, p: torch.Tensor, g: torch.Tensor, c_tilde: torch.Tensor,
                 b1: torch.Tensor | None, b2: torch.Tensor | None, p_new: torch.Tensor, K: int,
                 N: int, seed_hi: int, seed_lo: int, leaf: int, step: int,
                 scalars: list[float], stochastic_round: bool,
                 chain_offset: int) -> torch.Tensor:
    from . import fused_ecsghmc as _fe

    t_new = torch.empty_like(theta)
    _fe.launch(theta, p, g, c_tilde, b1, b2, t_new, p_new, K=K, N=N,
               seed=(seed_hi << 32) | seed_lo, leaf=leaf, step=step, scalars=tuple(scalars),
               stochastic_round=stochastic_round, chain_offset=chain_offset)
    launches["fused_ec_update"] += 1
    return t_new


@_fused_ec_op.register_fake
def _(theta, p, g, c_tilde, b1, b2, p_new, K, N, seed_hi, seed_lo, leaf, step, scalars,
      stochastic_round, chain_offset):
    return torch.empty_like(theta)


def fused_precond_ec_update(theta, p, g, c_tilde, minv, *, eps, friction, alpha, sigma_p,
                            stochastic_round=True, bits=None, seed=None, leaf=0, step=0,
                            p_out=None):
    """One leaf's preconditioned fused Eq. 6 update: ``fused_ec_update``
    with the scalar mass replaced by ``minv``, the per-chain diagonal
    M^-1, an f32 tensor shaped like theta (not broadcast).  The same noise
    modes: for the same (seed, leaf, step) both updates draw the same
    bits, so at M^-1 == 1 they agree bit for bit."""
    on_card, K, N, g, b1, b2 = _ec_operands(theta, p, g, c_tilde, bits, seed, p_out)
    if minv.dtype != torch.float32 or minv.shape != theta.shape or minv.device != theta.device:
        raise ValueError(f"minv must be an f32 tensor shaped like theta {tuple(theta.shape)} on "
                         f"{theta.device}, got {minv.dtype} {tuple(minv.shape)} on {minv.device}")
    _require_contiguous(minv=minv)
    scalars = ref.precond_scalars(eps, friction, alpha, sigma_p)
    if theta.numel() == 0:
        return theta.clone(), (p_out if p_out is not None else p.clone())
    if not on_card:
        b1, b2 = _plain_bits(b1, b2, seed, leaf, step, theta.shape)
        t_new, p_new = ref.fused_precond_ec_update(theta, p, g, c_tilde, minv, b1, b2,
                                                   scalars=scalars,
                                                   stochastic_round=stochastic_round)
        return t_new, (p_out.copy_(p_new) if p_out is not None else p_new)
    p_new = p_out if p_out is not None else torch.empty_like(p)
    seed = 0 if seed is None else int(seed)
    t_new = torch.ops.repro_torch.fused_precond_ec_update(
        theta, p, g, c_tilde, minv, b1, b2, p_new, K, N, seed >> 32, seed & 0xFFFFFFFF,
        int(leaf), int(step), [float(v) for v in scalars], stochastic_round)
    return t_new, p_new


@torch.library.custom_op("repro_torch::fused_precond_ec_update", mutates_args=("p_new",))
def _fused_precond_op(theta: torch.Tensor, p: torch.Tensor, g: torch.Tensor,
                      c_tilde: torch.Tensor, minv: torch.Tensor, b1: torch.Tensor | None,
                      b2: torch.Tensor | None, p_new: torch.Tensor, K: int, N: int,
                      seed_hi: int, seed_lo: int, leaf: int, step: int, scalars: list[float],
                      stochastic_round: bool) -> torch.Tensor:
    from . import fused_ecsghmc as _fe

    t_new = torch.empty_like(theta)
    _fe.launch_precond(theta, p, g, minv, c_tilde, b1, b2, t_new, p_new, K=K, N=N,
                       seed=(seed_hi << 32) | seed_lo, leaf=leaf, step=step,
                       scalars=tuple(scalars), stochastic_round=stochastic_round)
    launches["fused_precond_ec_update"] += 1
    return t_new


@_fused_precond_op.register_fake
def _(theta, p, g, c_tilde, minv, b1, b2, p_new, K, N, seed_hi, seed_lo, leaf, step, scalars,
      stochastic_round):
    return torch.empty_like(theta)


OPS = ("flash_attention", "paged_attention", "bma_select", "fused_ec_update",
       "fused_precond_ec_update", "rglru_scan", "rglru_scan_bwd")  # torch.ops.repro_torch.*


def fused_ec_update_tree(params, momentum, grads, center_stale, *, bits=None, seed=None,
                         step=0, chain_offset=0, **hyper):
    """Tree-level fused update, one kernel launch per leaf in flatten order,
    writing each p' over its p.  ``bits``: a tree of (bits1, bits2) pairs
    (parity mode), or ``seed`` for Philox noise with the leaf's flatten
    index as its ``leaf`` (and ``chain_offset``, the global index of the
    first chain).  Returns the momentum tree.  Each leaf's theta'
    is written by the kernel and dropped after its launch: the one caller,
    EC-SGHMC, takes the position step from its ``updates``, as the
    reference does, so only one leaf's theta' is ever held."""
    _tree_launches(fused_ec_update, (params, momentum, grads, center_stale), bits, seed, step,
                   dict(hyper, chain_offset=chain_offset))
    return momentum


def fused_precond_ec_update_tree(params, momentum, grads, center_stale, minv, *, bits=None,
                                 seed=None, step=0, **hyper):
    """Tree-level preconditioned update, as ``fused_ec_update_tree`` with a
    tree of per-leaf M^-1 (f32, shaped like params): one launch per leaf,
    p' over p, theta' dropped, the leaf's flatten index as its Philox
    ``leaf``, so the two tree forms see the same per-leaf noise.  Returns
    the momentum tree."""
    _tree_launches(fused_precond_ec_update, (params, momentum, grads, center_stale, minv), bits,
                   seed, step, hyper)
    return momentum


def _tree_launches(update, trees, bits, seed, step, hyper):
    """``update`` on every leaf of ``trees`` (params, momentum, ... in the
    update's argument order), with p' written over the momentum leaf.  A
    (bits1, bits2) pair is a leaf of the bits tree."""
    from repro_torch.models.common import tree_leaves

    leaves = list(zip(*map(tree_leaves, trees)))
    leaves_b = tree_leaves(bits) if bits is not None else [None] * len(leaves)
    for i, (args, b) in enumerate(zip(leaves, leaves_b)):
        update(*args, bits=b, seed=seed, leaf=i, step=step, p_out=args[1], **hyper)
