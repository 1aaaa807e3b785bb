"""Plain PyTorch versions of every hand-written kernel: what the CPU path
runs, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.  Counterparts of ``repro/kernels/ref.py``."""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


# --- flash attention ---------------------------------------------------------


def attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q: (B, Hq, S, d); k/v: (B, Hkv, S, d); GQA by head broadcast.
    Full-materialisation reference; returns q's dtype."""
    B, Hq, S, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qr = q.reshape(B, Hkv, G, S, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qr * scale, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(B, Hq, S, d).to(q.dtype)


# --- paged attention (single-token decode) -----------------------------------


def gather_pages(pages, block_tables):
    """(num_pages, bs, Hkv, d) pool + (B, M) int32 tables -> the dense
    per-sequence cache (B, M*bs, Hkv, d) a slot-resident engine would hold."""
    B, M = block_tables.shape
    _, bs, Hkv, d = pages.shape
    return pages[block_tables.long()].reshape(B, M * bs, Hkv, d)


def paged_attention(
    q, k_pages, v_pages, block_tables, context_lens,
    *, scale=None, window=None, softcap=None,
):
    """Dense full-materialisation reference for the paged decode kernel:
    gather every page into a contiguous cache, then masked softmax in f32.
    q: (B, Hkv, G, d); context_lens (B,) is the INCLUSIVE current position.
    Returns (B, Hkv, G, d) in q's dtype."""
    B, Hkv, G, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = gather_pages(k_pages, block_tables).float()  # (B, T, Hkv, d)
    v = gather_pages(v_pages, block_tables).float()
    s = torch.einsum("bhgd,bthd->bhgt", q.float() * scale, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]  # (1, T)
    ctx = context_lens[:, None].long()
    mask = kpos <= ctx
    if window is not None:
        mask &= (ctx - kpos) < window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgt,bthd->bhgd", w, v).to(q.dtype)


# --- fused BMA mixture + selection -------------------------------------------


def bma_select(logits, gumbel, *, mode, temperature, top_k):
    """Unfused version of the bma_select kernel: mixture via the serving
    helper, selection via argmax over (scaled, top-k-masked) + Gumbel.
    ``gumbel`` (S, V) f32 is ignored (and may be None) when
    ``temperature <= 0``.  Returns (tokens (S,) int32, logp (S, V) f32)."""
    from repro_torch.serve.engine.bma import mixture_logprobs
    from repro_torch.serve.sampling import _top_k_mask

    logp = mixture_logprobs(logits, mode)  # (S, V) f32
    if temperature <= 0.0:
        return torch.argmax(logp, dim=-1).to(torch.int32), logp
    sel = logp / float(temperature)
    if top_k:
        sel = _top_k_mask(sel, top_k)
    tok = torch.argmax(sel + gumbel.float(), dim=-1).to(torch.int32)
    return tok, logp


# --- fused EC-SGHMC update ---------------------------------------------------

_F32 = np.float32
_M32 = np.uint64(0xFFFFFFFF)
PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
SR_SALT = 0x9E3779B9  # XORed into the bits of p's stochastic rounding


def ec_scalars(eps, friction, minv, alpha, sigma_p):
    """The five scalars of the Eq. 6 update, (eps*M^-1, 1 - eps*V*M^-1, eps,
    eps*alpha, sigma_p), formed in float32 exactly as the reference forms
    them (each Python constant rounded to f32, then f32 products).  The
    kernel's arguments, this module's plain version and
    ``core.ec_sghmc.p_step`` all take their scalars from here.  Returned as
    Python floats that hold f32 values exactly."""
    e = _F32(eps)
    return (
        float(e * _F32(minv)),
        float(_F32(1.0) - e * _F32(friction) * _F32(minv)),
        float(e),
        float(e * _F32(alpha)),
        float(_F32(sigma_p)),
    )


def precond_scalars(eps, friction, alpha, sigma_p):
    """The four scalars of the preconditioned Eq. 6 update, (eps, eps*V,
    eps*alpha, sigma_p), formed in float32 as ``ec_scalars`` forms them, so
    that at M^-1 == 1 the two updates round alike.  The preconditioned
    kernel's arguments, its plain version and ``core.ec_sghmc.p_step`` with
    an array M^-1 take their scalars from here."""
    e = _F32(eps)
    return float(e), float(e * _F32(friction)), float(e * _F32(alpha)), float(_F32(sigma_p))


def philox_bits(seed: int, leaf: int, step: int, n: int, start: int = 0):
    """The production-mode noise bits of the fused kernel for elements
    ``start .. start + n - 1`` of a leaf (global element indices: a rank's
    chains start at ``chain_offset * N``), as two uint32 numpy arrays.
    Philox-4x32-10 with key (seed lo, seed hi) and counter (element // 2,
    leaf, step lo, step hi); element 2q takes words (0, 1) of block q and
    element 2q+1 words (2, 3)."""
    if start < 0 or (start + n + 1) // 2 > 1 << 32:
        raise ValueError(f"elements {start}..{start + n - 1} do not fit the Philox counter")
    q0 = start // 2
    m = (start + n + 1) // 2 - q0
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    keys = []
    for _ in range(10):
        keys.append((np.uint64(k0), np.uint64(k1)))
        k0, k1 = (k0 + PHILOX_W[0]) & 0xFFFFFFFF, (k1 + PHILOX_W[1]) & 0xFFFFFFFF
    s32 = np.uint64(32)
    c0 = np.arange(q0, q0 + m, dtype=np.uint64)
    c1, c2, c3 = np.uint64(leaf & 0xFFFFFFFF), np.uint64(step & 0xFFFFFFFF), np.uint64((step >> 32) & 0xFFFFFFFF)
    for kk0, kk1 in keys:
        p0, p1 = PHILOX_M[0] * c0, PHILOX_M[1] * c2
        c0, c1, c2, c3 = (p1 >> s32) ^ c1 ^ kk0, p1 & _M32, (p0 >> s32) ^ c3 ^ kk1, p0 & _M32
    bits1, bits2 = np.empty(2 * m, np.uint32), np.empty(2 * m, np.uint32)
    bits1[0::2], bits1[1::2], bits2[0::2], bits2[1::2] = c0, c2, c1, c3
    lo = start - 2 * q0
    return bits1[lo:lo + n], bits2[lo:lo + n]


def _u32(bits):
    """int32 tensor of uint32 bit patterns -> int64 tensor of their values."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def _bits_to_unit(bits):
    """uint32 -> uniform (0, 1) f32 from the top 24 bits."""
    return (_u32(bits) >> 8).float() * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def box_muller(bits1, bits2):
    """Standard normal f32 from two int32 tensors of uint32 bits."""
    u1 = _bits_to_unit(bits1)
    u2 = _bits_to_unit(bits2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def stochastic_round_bf16(x, bits):
    """f32 -> bf16, rounding up with probability equal to the dropped
    fraction: add the low 16 of ``bits`` to the f32 pattern, truncate."""
    xi = (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) + (_u32(bits) & 0xFFFF)
    xi = xi & 0xFFFF0000
    xi = torch.where(xi >= 1 << 31, xi - (1 << 32), xi)
    return xi.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def fused_ec_update(theta, p, g, c_tilde, bits1, bits2, *, scalars, stochastic_round):
    """Plain version of the fused Eq. 6 chain update:

        theta' = theta + (eps*M^-1) * p
        p'     = decay * p - eps * g - coupling * (theta - c̃) + sigma_p * n

    n = box_muller(bits1, bits2); ``scalars`` is ``ec_scalars(...)``;
    c̃ broadcasts over theta's leading (chain) axis; bits are shaped like
    theta.  Returns (theta', p') in theta's and p's dtypes, stored through
    stochastic rounding when that is on and the dtype is bf16, else by a
    plain cast."""
    eps_minv, decay, eps, coupling, sigma_p = scalars
    t32, p32 = theta.float(), p.float()
    noise = box_muller(bits1, bits2)
    theta_new = t32 + eps_minv * p32
    p_new = decay * p32 - eps * g.float() - coupling * (t32 - c_tilde.float()) + sigma_p * noise
    return _store(theta, p, theta_new, p_new, bits1, bits2, stochastic_round)


def fused_precond_ec_update(theta, p, g, c_tilde, minv, bits1, bits2, *, scalars,
                            stochastic_round):
    """Plain version of the preconditioned fused update, ``minv`` the f32
    diagonal M^-1 shaped like theta:

        theta' = theta + (eps*M^-1) * p
        p'     = (1 - eps*V*M^-1) * p - eps * g - coupling * (theta - c̃) + sigma_p * n

    ``scalars`` is ``precond_scalars(...)``; otherwise as
    ``fused_ec_update``."""
    eps, ef, coupling, sigma_p = scalars
    t32, p32 = theta.float(), p.float()
    noise = box_muller(bits1, bits2)
    theta_new = t32 + (minv * eps) * p32
    p_new = ((1.0 - ef * minv) * p32 - eps * g.float() - coupling * (t32 - c_tilde.float())
             + sigma_p * noise)
    return _store(theta, p, theta_new, p_new, bits1, bits2, stochastic_round)


def _store(theta, p, theta_new, p_new, bits1, bits2, stochastic_round):
    """(theta', p') in theta's and p's dtypes: stochastic rounding to bf16
    with the kernel's bits when that is on, else a plain cast."""
    if stochastic_round and theta.dtype == torch.bfloat16:
        sr = bits1 ^ bits2
        return (stochastic_round_bf16(theta_new, sr),
                stochastic_round_bf16(p_new, sr ^ (SR_SALT - (1 << 32))))  # as int32
    return theta_new.to(theta.dtype), p_new.to(p.dtype)


# --- RG-LRU scan -------------------------------------------------------------


def rglru_scan(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t over axis 1, sequentially in f32, each
    step a multiply and then an add (no fused multiply-add), so the CUDA
    kernel equals it bit for bit.  a, x: (B, S, R), any float type; h0:
    (B, R) or None, the carry before step 0 (the reference's
    ``x[:, 0] += a[:, 0] * h0``).  Returns h (B, S, R) f32."""
    a, x = a.float(), x.float()
    B, S, R = a.shape
    h = h0.float() if h0 is not None else torch.zeros((B, R), dtype=a.dtype, device=a.device)
    out = torch.empty((B, S, R), dtype=a.dtype, device=a.device)
    for t in range(S):
        h = a[:, t] * h + x[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd(a, h, dh, h0=None):
    """The scan's gradient: given a (B, S, R), the forward's output h, its
    cotangent dh, and h0 (B, R) or None, returns (da, dx, dh0), f32, dh0
    None without h0.  Walks t from S-1 down to 0, sequentially in f32,
    each step a multiply and then an add, so the CUDA kernel equals it bit
    for bit:

        g_{S-1} = dh_{S-1},  g_t = dh_t + a_{t+1} * g_{t+1}
        dx_t = g_t,  da_t = g_t * h_{t-1} (h_{-1} = h0, or zeros),
        dh0 = a_0 * g_0."""
    a, h, dh = a.float(), h.float(), dh.float()
    S = a.shape[1]
    dx = torch.empty_like(dh)
    g = dh[:, S - 1]
    dx[:, S - 1] = g
    for t in range(S - 2, -1, -1):
        g = dh[:, t] + a[:, t + 1] * g
        dx[:, t] = g
    h_prev = torch.cat([(h0.float() if h0 is not None else torch.zeros_like(h[:, 0]))[:, None],
                        h[:, :-1]], dim=1)
    da = dx * h_prev
    dh0 = a[:, 0] * dx[:, 0] if h0 is not None else None
    return da, dx, dh0
