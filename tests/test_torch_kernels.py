"""The port's kernel dispatch on the CPU against the reference kernels.

On a CPU tensor each wrapper in ``repro_torch.kernels.ops`` runs the
kernel's plain version (``repro_torch.kernels.ref``); these tests hold it,
with the wrappers' head-dim padding, against ``repro.kernels.ops`` (the
Pallas kernels, in interpret mode on the CPU) and ``repro.kernels.ref`` on
the same numpy inputs.  The CUDA kernels themselves run only on a card:
``chip_smoke.py`` holds them against the same plain versions there, and
the ``cuda``-marked tests below skip without one.  Every guard of the
wrappers has a test.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jkernels
from repro.kernels import bma_select as jbma
from repro.kernels import ref as jref
from repro_torch.kernels import bma_select as kbma
from repro_torch.kernels import launches, ops, ref
from repro_torch.serve.engine.bma import mixture_logprobs
from repro_torch.serve.sampling import SamplingParams, _top_k_mask, gumbel_noise, select_tokens
from util import import_hypothesis

given, settings, st = import_hypothesis()

# The reference suite's tolerance for these pairings (tests/test_paged_attention.py).
# Measured gaps on these inputs: attention <= 7.0e-7, paged and bma below that.
ATOL = 2e-6


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


FLASH_CASES = {
    "causal": dict(B=2, Hq=4, Hkv=4, S=32, d=64),
    "gqa": dict(B=1, Hq=4, Hkv=2, S=32, d=128),
    "window": dict(B=1, Hq=4, Hkv=2, S=32, d=64, window=8),
    "softcap": dict(B=1, Hq=2, Hkv=1, S=16, d=64, softcap=5.0),
    "d16_padded": dict(B=1, Hq=4, Hkv=2, S=16, d=16),
    "d256_mqa_window": dict(B=1, Hq=4, Hkv=1, S=32, d=256, window=8),
    "d200_padded": dict(B=1, Hq=2, Hkv=1, S=16, d=200),
    "noncausal": dict(B=1, Hq=2, Hkv=2, S=16, d=64, causal=False),
    "ragged_gqa_d128": dict(B=1, Hq=4, Hkv=2, S=37, d=128),  # S past every 32-row tile edge
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_matches_reference_kernel(case):
    c = dict(FLASH_CASES[case])
    B, Hq, Hkv, S, d = (c.pop(k) for k in ("B", "Hq", "Hkv", "S", "d"))
    causal = c.pop("causal", True)
    q, k, v = _np(1, B, Hq, S, d), _np(2, B, Hkv, S, d), _np(3, B, Hkv, S, d)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              causal=causal, **c).numpy()
    want_ref = np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, **c))
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    if causal:  # the Pallas kernel is causal-only in the reference's dispatch
        want = np.asarray(jkernels.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), causal=True, **c))
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert launches["flash_attention"] == 0  # the CPU path launches nothing


# The card's bf16 flash kernel rounds P (exp(s - m), in [0, 1]) to bf16 before
# the PV product on the tensor cores; chip_smoke.py holds it at this tolerance.
FLASH_ATOL = 2e-2
FLASH_PATH_SHAPES = {  # the serving path's prefill shapes
    "qwen3_d128": dict(Hq=16, Hkv=8, S=128, d=128, window=None),
    "recurrentgemma_d256_mqa_window16": dict(Hq=10, Hkv=1, S=128, d=256, window=16),
}


def _flash_bf16_p(q, k, v, *, window, scale, tile=64, halves=2):
    """The bf16 kernel's arithmetic in plain torch: f32 scores; for each
    half of every 64-key tile (one warp each), an online softmax over the
    tiles with l summed from the f32 P and P rounded to bf16 before PV;
    then the halves merge."""
    B, Hq, S, d = q.shape
    G = Hq // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, dim=1) for x in (k, v))
    pos = torch.arange(S)
    w = tile // halves
    parts = []
    for h in range(halves):
        m = torch.full((B, Hq, S, 1), -1e30)
        l = torch.zeros((B, Hq, S, 1))
        acc = torch.zeros((B, Hq, S, d))
        for t0 in range(h * w, S, tile):
            keys = slice(t0, t0 + w)
            s = qf @ kf[:, :, keys].transpose(-1, -2) * scale
            lag = pos[:, None] - pos[None, keys]
            keep = lag >= 0
            if window is not None:
                keep &= lag < window
            s = s.masked_fill(~keep, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.bfloat16().float() @ vf[:, :, keys]
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(pl * torch.exp(pm - m) for pm, pl, _ in parts)
    acc = sum(pa * torch.exp(pm - m) for pm, _, pa in parts)
    return acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("shape", sorted(FLASH_PATH_SHAPES))
def test_flash_bf16_p_rounding_fits_tolerance(shape):
    c = FLASH_PATH_SHAPES[shape]
    B, Hq, Hkv, S, d = 1, c["Hq"], c["Hkv"], c["S"], c["d"]
    q, k, v = (torch.tensor(_np(20 + i, B, h, S, d)).to(torch.bfloat16)
               for i, h in enumerate((Hq, Hkv, Hkv)))
    scale = 1.0 / np.sqrt(d)
    got = _flash_bf16_p(q, k, v, window=c["window"], scale=scale)
    want = ref.attention(q.float(), k.float(), v.float(), window=c["window"], scale=scale)
    gap = (got - want).abs().max().item()
    assert 0 < gap < FLASH_ATOL / 4, gap


def test_flash_bf16_keeps_dtype():
    q = torch.tensor(_np(4, 1, 2, 16, 64)).to(torch.bfloat16)
    out = ops.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


def _paged_case(seed, *, B, Hkv, G, d, bs, M, permute=False, ctx=None):
    P = B * M + 1
    q = _np(seed, B, Hkv, G, d)
    kp, vp = _np(seed + 1, P, bs, Hkv, d), _np(seed + 2, P, bs, Hkv, d)
    pages = np.arange(1, P, dtype=np.int32)
    if permute:
        pages = np.random.default_rng(seed).permutation(pages).astype(np.int32)
    tables = pages.reshape(B, M)
    if ctx is None:
        ctx = np.random.default_rng(seed + 3).integers(0, M * bs, size=B).astype(np.int32)
    return q, kp, vp, tables, np.asarray(ctx, np.int32)


PAGED_CASES = {
    "bs8": dict(B=3, Hkv=2, G=2, d=16, bs=8, M=3),
    "bs16_permuted": dict(B=4, Hkv=2, G=2, d=64, bs=16, M=3, permute=True),
    "bs64": dict(B=2, Hkv=1, G=4, d=32, bs=64, M=2),
    "ctx0": dict(B=3, Hkv=2, G=1, d=16, bs=8, M=2, ctx=[0, 0, 5]),
    "window": dict(B=3, Hkv=2, G=2, d=16, bs=8, M=4, window=11),
    "softcap": dict(B=2, Hkv=2, G=2, d=16, bs=8, M=3, softcap=3.0),
    "ragged_window": dict(B=4, Hkv=2, G=2, d=64, bs=16, M=4, ctx=[0, 17, 40, 63], window=20),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_matches_reference_kernel(case):
    c = dict(PAGED_CASES[case])
    kw = {k: c.pop(k) for k in ("window", "softcap") if k in c}
    q, kp, vp, tab, ctx = _paged_case(len(case), **c)
    got = ops.paged_attention(*(torch.tensor(a) for a in (q, kp, vp, tab, ctx)), **kw).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tab, ctx)]
    want = np.asarray(jkernels.paged_attention(*jargs, **kw))
    want_ref = np.asarray(jref.paged_attention(*jargs, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    assert launches["paged_attention"] == 0


def test_gather_pages_matches_reference():
    q, kp, vp, tab, ctx = _paged_case(9, B=2, Hkv=2, G=1, d=8, bs=4, M=3, permute=True)
    np.testing.assert_array_equal(ref.gather_pages(torch.tensor(kp), torch.tensor(tab)).numpy(),
                                  np.asarray(jref.gather_pages(jnp.asarray(kp), jnp.asarray(tab))))


# ---------------------------------------------------------------------------
# BMA mixture + selection
# ---------------------------------------------------------------------------


def _bma_inputs(seed, K=3, S=4, V=37):
    logits = _np(seed, K, S, V, scale=4.0)
    # slot 1: a forced tie at the argmax (identical columns in every member)
    logits[:, 1, 7] = logits[:, 1, 20] = logits[:, 1].max() + 1.0
    # slot 2: forced ties at the top-5 boundary (three equal 4th..6th values)
    logits[:, 2, :] = -3.0
    logits[:, 2, [3, 9, 30]] = 5.0
    logits[:, 2, [11, 12, 13]] = 2.0
    gumbel = _np(seed + 1, S, V)
    return logits, gumbel


@pytest.mark.parametrize("mode", ["probs", "logprobs"])
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (1.3, 0), (0.7, 5), (2.0, 1)])
def test_bma_select_matches_reference_kernel(mode, temperature, top_k):
    logits, gumbel = _bma_inputs(17)
    kw = dict(mode=mode, temperature=temperature, top_k=top_k)
    tok, logp = ref.bma_select(torch.tensor(logits), torch.tensor(gumbel), **kw)
    jt, jl = jbma.bma_select(jnp.asarray(logits), jnp.asarray(gumbel), interpret=True, **kw)
    rt, rl = jref.bma_select(jnp.asarray(logits), jnp.asarray(gumbel), **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rt))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(rl), atol=ATOL)


def test_bma_forced_ties():
    logits, gumbel = _bma_inputs(17)
    tok, _ = ref.bma_select(torch.tensor(logits), None, mode="probs", temperature=0.0, top_k=0)
    assert int(tok[1]) == 7  # first of the tied maxima
    # top-3 at slot 2 keeps exactly the three 5.0 columns; top-5 keeps the
    # 2.0 ties too (duplicates count toward k, ties at the k-th are kept)
    from repro_torch.serve.sampling import _top_k_mask

    row = mixture_logprobs(torch.tensor(logits), "probs")[2:3]
    assert torch.isfinite(_top_k_mask(row, 3)).sum() == 3
    assert torch.isfinite(_top_k_mask(row, 5)).sum() == 6


# The select kernel never sorts a row.  For 0 < top_k <= KCAP it bounds the
# row's threshold from below by L, the k-th largest chunk maximum of sel (the
# k-th largest warp maximum where there are fewer than k chunks; none where
# there are fewer than k warps).  It lists the elements above L, and for each
# warp holding elements at L the best of them by sel + gumbel; the threshold
# is the k-th largest entry above L where there are k, else L (by one
# counting pass up to 256 keys, a four-pass radix select up to SLIST, over the
# whole row beyond).  Above KCAP it radix-selects over the whole row.  The
# mirror below follows csrc/bma_select.cu with its constants and element
# layout, and is held against serve.sampling._top_k_mask.
SLIST = 2048


def _f2key(x):
    """The kernel's order-preserving uint32 image of f32 values, as int64."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)


def _key2f(k: int) -> float:
    u = (k & 0x7FFFFFFF) if k >= 0x80000000 else (~k) & 0xFFFFFFFF
    return float(np.array([u], np.uint32).view(np.float32)[0])


def _radix_kth(keys, k: int) -> int:
    """block_kth_largest / the radix passes: four 8-bit digits, top first."""
    prefix = mask = 0
    for shift in (24, 16, 8, 0):
        live = keys[(keys & mask) == prefix]
        hist = torch.bincount((live >> shift) & 255, minlength=256)
        suffix = hist.flip(0).cumsum(0).flip(0)  # keys at this digit or above
        d = int(((suffix >= k) & (suffix - hist < k)).nonzero()[0])
        k -= int(suffix[d] - hist[d])
        prefix |= d << shift
        mask |= 255 << shift
    return prefix


def _counting_kth(keys, k: int) -> int:
    """block_kth_small: the key with fewer than k above and >= k at or above."""
    gt = (keys[None, :] > keys[:, None]).sum(1)
    ge = (keys[None, :] >= keys[:, None]).sum(1)
    return int(keys[(gt < k) & (k <= ge)][0])


def _kth(keys, k: int) -> int:
    return _counting_kth(keys, k) if keys.numel() <= 256 else _radix_kth(keys, k)


def _mirror_select(sel, gumbel, k):
    """(threshold, token, path) of one row as the kernel computes them."""
    V = sel.numel()
    k_eff = min(k, V)
    keys = _f2key(sel)
    if k > kbma.KCAP:
        th, path = _radix_kth(keys, k_eff), "radix"
    else:
        C = -(-V // kbma.CHUNK)
        padded = torch.zeros(C * kbma.CHUNK, dtype=torch.int64)  # past V: key 0
        padded[:V] = keys
        off = torch.arange(kbma.CHUNK)
        warp = (off % (kbma.CHUNK // 2)) // (kbma.CHUNK // (2 * kbma.WARPS))  # elem_off's layout
        wmax = torch.stack([padded.view(C, kbma.CHUNK)[:, warp == w].max(1).values
                            for w in range(kbma.WARPS)], 1)  # (C, WARPS)
        if C >= k_eff:
            bound, path = _kth(wmax.max(1).values, k_eff), "chunk maxima"
        elif C * kbma.WARPS >= k_eff:
            bound, path = _kth(wmax.reshape(-1), k_eff), "warp maxima"
        else:
            bound, path = 0, "no bound"
        above = (keys > bound).nonzero()[:, 0]
        at = torch.zeros(C * kbma.CHUNK, dtype=torch.bool)
        at[:V] = keys == bound
        score = torch.full((C * kbma.CHUNK,), float("-inf"))
        score[:V] = sel + gumbel
        ties = []  # per (chunk, warp) holding elements at the bound: its best
        for c in range(C):
            for w in range(kbma.WARPS):
                idx = c * kbma.CHUNK + off[warp == w]  # ascending
                if at[idx].any():
                    sc_w = torch.where(at[idx], score[idx], float("-inf"))
                    ties.append(int(idx[torch.argmax(sc_w)]))
        listed = torch.cat([above, torch.tensor(ties, dtype=torch.int64)])
        if listed.numel() > SLIST:
            th, path = _radix_kth(keys, k_eff), path + ", whole row"
        else:
            th = _kth(keys[listed], k_eff) if above.numel() >= k_eff else bound
            kept = listed[keys[listed] >= th]
            val = (sel + gumbel)[kept]
            best = kept[val == val.max()].min()  # the first maximum
            return _key2f(th), int(best), path
    kept = keys >= th
    val = torch.where(kept, sel + gumbel, torch.tensor(float("-inf")))
    return _key2f(th), int(torch.argmax(val)), path  # torch.argmax: the first maximum


def _topk_row(seed, V, levels):
    """A row of sel values; ``levels`` > 0 rounds them to that many steps per
    unit, so exact duplicates sit at every threshold; -1 makes them all
    equal."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(V)).astype(np.float32)
    if levels < 0:
        x[:] = -1.5
    elif levels:
        x = (np.round(x * levels) / levels).astype(np.float32)
    return torch.tensor(x) / 0.7, torch.tensor(rng.gumbel(size=V).astype(np.float32))


def _check_mirror(sel, gumbel, k):
    th, tok, path = _mirror_select(sel, gumbel, k)
    masked = _top_k_mask(sel[None], k)[0]
    want = torch.where(sel < th, float("-inf"), sel)
    torch.testing.assert_close(want, masked, rtol=0, atol=0)
    assert tok == int(torch.argmax(masked + gumbel)), path
    return path


# (V, levels, top_k): k = 1, at the candidate capacity, above it, and V, on
# rows with wide ties at the threshold and a ragged last chunk; each path of
# the bound (chunk maxima, warp maxima, none) and of the select
TOPK_CASES = {
    "k1_ragged": (3 * 2048 + 300, 0, 1, "chunk maxima"),
    "k50_ties": (60 * 2048 + 77, 2, 50, "chunk maxima"),
    "kcap_warp_bound": (20 * 2048 + 5, 4, kbma.KCAP, "warp maxima"),
    "kcap_ties_no_bound": (5 * 2048 + 1000, 1, kbma.KCAP, "no bound, whole row"),
    "flat": (60 * 2048 + 5, -1, 50, "chunk maxima"),
    "kcap_small_row": (300, 3, kbma.KCAP, "no bound"),
    "above_kcap": (3 * 2048 + 300, 2, kbma.KCAP + 1, "radix"),
    "k_is_V": (2 * 2048 + 9, 0, 2 * 2048 + 9, "radix"),
    "k_above_V": (100, 0, 120, "no bound"),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_kernel_topk_scheme_matches_top_k_mask(case):
    V, levels, k, path = TOPK_CASES[case]
    sel, gumbel = _topk_row(sorted(TOPK_CASES).index(case), V, levels)
    assert _check_mirror(sel, gumbel, k) == path


@settings(max_examples=60, deadline=None, derandomize=True)
@given(V=st.integers(1, 24 * 2048 + 100), levels=st.sampled_from([0, 1, 3, 50]),
       kind=st.sampled_from(["1", "kcap", "kcap+1", "V", "any"]), k_any=st.integers(1, 400),
       seed=st.integers(0, 2**16))
def test_kernel_topk_scheme_property(V, levels, kind, k_any, seed):
    k = {"1": 1, "kcap": kbma.KCAP, "kcap+1": kbma.KCAP + 1, "V": V, "any": k_any}[kind]
    sel, gumbel = _topk_row(seed, V, levels)
    _check_mirror(sel, gumbel, k)


def test_kth_selects_agree():
    """The counting pass and the radix select give the same key, duplicates
    counted, at every k."""
    keys = _f2key(torch.tensor(np.round(np.random.default_rng(3).standard_normal(200) * 2)
                               .astype(np.float32)))
    for k in range(1, 201):
        assert _counting_kth(keys, k) == _radix_kth(keys, k) == int(keys.sort(descending=True)
                                                                     .values[k - 1])


@pytest.mark.parametrize("mode", ["probs", "logprobs"])
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (1.3, 0), (0.7, 5)])
def test_fused_select_bit_equal_to_unfused(mode, temperature, top_k):
    """The wrapper draws its Gumbel tensor exactly as select_tokens does:
    with the same generator seed the tokens are bit-equal."""
    logits = torch.tensor(_np(23, 3, 5, 151))
    sampling = SamplingParams(temperature=temperature, top_k=top_k)
    tok, logp = ops.fused_bma_select(logits, torch.Generator().manual_seed(5), mode=mode,
                                     temperature=temperature, top_k=top_k)
    want_logp = mixture_logprobs(logits, mode)
    want = select_tokens(want_logp, torch.Generator().manual_seed(5), sampling)
    torch.testing.assert_close(tok, want, rtol=0, atol=0)
    torch.testing.assert_close(logp, want_logp, rtol=0, atol=0)
    assert launches["bma_select"] == 0


def test_sampling_helpers_match_reference():
    from repro.serve import sampling as jsampling
    from repro_torch.serve.sampling import _top_k_mask, mask_after_eos

    x = _np(31, 4, 50)
    x[1, [4, 9]] = x[1].max() + 1.0  # a tie at the argmax
    np.testing.assert_array_equal(select_tokens(torch.tensor(x)).numpy(),
                                  np.asarray(jsampling.select_tokens(jnp.asarray(x))))
    for k in (1, 5, 50):
        np.testing.assert_array_equal(_top_k_mask(torch.tensor(x), k).numpy(),
                                      np.asarray(jsampling._top_k_mask(jnp.asarray(x), k)))
    toks = np.random.default_rng(0).integers(0, 6, size=(5, 12)).astype(np.int32)
    np.testing.assert_array_equal(mask_after_eos(torch.tensor(toks), 3, pad_id=-1).numpy(),
                                  np.asarray(jsampling.mask_after_eos(jnp.asarray(toks), 3, -1)))


def test_gumbel_noise_is_standard_gumbel():
    g = gumbel_noise((200_000,), torch.Generator().manual_seed(0), "cpu").double()
    assert abs(g.mean().item() - 0.5772156649) < 0.01  # Euler–Mascheroni
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.03


# ---------------------------------------------------------------------------
# wrapper guards: one test per check
# ---------------------------------------------------------------------------


def _qkv(S=8, d=64, Hq=2, Hkv=1, dtype=torch.float32):
    return (torch.zeros(1, Hq, S, d, dtype=dtype), torch.zeros(1, Hkv, S, d, dtype=dtype),
            torch.zeros(1, Hkv, S, d, dtype=dtype))


FLASH_GUARDS = {
    "mixed_device": lambda q, k, v: (q, k.to("meta"), v),
    "dtype_mismatch": lambda q, k, v: (q, k.double(), v),
    "unsupported_dtype": lambda q, k, v: (q.half(), k.half(), v.half()),
    "non_contiguous": lambda q, k, v: (q.transpose(2, 3), k, v),
    "rank": lambda q, k, v: (q[0], k, v),
    "kv_shape": lambda q, k, v: (q, k[:, :, :4].contiguous(), v),
    "heads_not_multiple": lambda q, k, v: (q[:, :1].repeat(1, 3, 1, 1), k.repeat(1, 2, 1, 1),
                                           v.repeat(1, 2, 1, 1)),
    "head_dim_too_large": lambda q, k, v: (torch.zeros(1, 2, 8, 320), torch.zeros(1, 1, 8, 320),
                                           torch.zeros(1, 1, 8, 320)),
}


@pytest.mark.parametrize("guard", sorted(FLASH_GUARDS))
def test_flash_guards(guard):
    with pytest.raises(ValueError):
        ops.flash_attention(*FLASH_GUARDS[guard](*_qkv()))


def test_flash_grad_guard_condition():
    """The flash kernel has no backward: its wrapper asks whether autograd
    would record the call (grad mode on and an input requiring grad)."""
    q, k, v = _qkv()
    assert not ops._records_grad(q, k, v)
    assert ops._records_grad(q, k.clone().requires_grad_(), v)
    with torch.no_grad():
        assert not ops._records_grad(q.clone().requires_grad_(), k, v)
    # the plain version on the CPU carries the gradient
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    (g,) = torch.autograd.grad(ops.flash_attention(q, k[:, :1], v[:, :1]).sum(), [q])
    assert g.shape == q.shape


def test_flash_card_branch_refuses_grad(monkeypatch):
    """On the card, a call that autograd would record raises before the
    kernel (whose output would carry no gradient to q, k and v)."""
    monkeypatch.setattr(ops, "_on_card", lambda *t: True)
    q, k, v = _qkv()
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)


def _paged_args(G=2, bs=4, d=64):
    return dict(q=torch.zeros(2, 1, G, d), k_pages=torch.zeros(5, bs, 1, d),
                v_pages=torch.zeros(5, bs, 1, d),
                block_tables=torch.ones(2, 2, dtype=torch.int32),
                context_lens=torch.zeros(2, dtype=torch.int32))


PAGED_GUARDS = {
    "int64_tables": lambda a: {**a, "block_tables": a["block_tables"].long()},
    "int64_positions": lambda a: {**a, "context_lens": a["context_lens"].long()},
    "mixed_device": lambda a: {**a, "q": a["q"].to("meta")},
    "dtype_mismatch": lambda a: {**a, "k_pages": a["k_pages"].to(torch.bfloat16)},
    "non_contiguous": lambda a: {**a, "k_pages": torch.zeros(5, 4, 1, 128)[..., ::2]},
    "page_shape": lambda a: {**a, "v_pages": torch.zeros(5, 4, 2, 64)},
    "table_rows": lambda a: {**a, "block_tables": torch.ones(3, 2, dtype=torch.int32)},
    "group_too_large": lambda a: _paged_args(G=9),
    "block_too_large": lambda a: _paged_args(bs=129),
    "head_dim_too_large": lambda a: _paged_args(d=160),
    "head_dim_256": lambda a: _paged_args(d=256),  # flash takes 256, the paged kernel does not
}


@pytest.mark.parametrize("guard", sorted(PAGED_GUARDS))
def test_paged_guards(guard):
    with pytest.raises(ValueError):
        ops.paged_attention(**PAGED_GUARDS[guard](_paged_args()))


BMA_GUARDS = {
    "no_members": dict(logits=torch.zeros(0, 2, 5)),
    "empty_vocab": dict(logits=torch.zeros(2, 2, 0)),
    "rank": dict(logits=torch.zeros(2, 5)),
    "integer_logits": dict(logits=torch.zeros(2, 2, 5, dtype=torch.int32)),
    "non_contiguous": dict(logits=torch.zeros(2, 5, 2).transpose(1, 2)),
    "mode": dict(logits=torch.zeros(2, 2, 5), mode="median"),
    "negative_top_k": dict(logits=torch.zeros(2, 2, 5), top_k=-1),
    "sampling_without_generator": dict(logits=torch.zeros(2, 2, 5), temperature=1.0),
    "meta_device": dict(logits=torch.zeros(2, 2, 5, device="meta")),
}


@pytest.mark.parametrize("guard", sorted(BMA_GUARDS))
def test_bma_guards(guard):
    with pytest.raises(ValueError):
        ops.fused_bma_select(**BMA_GUARDS[guard])


# The card branch of each wrapper whose kernel has a ctypes binding, in a
# fresh interpreter (so no binding module is imported yet), with the
# library, the device test and the stream stubbed: the wrapper reaches its
# kernel's C entry once and counts it.  The child prints what the entry was
# given; the test holds the binding's argtypes against the C signature in
# csrc/ and the bma_select scratch against scratch_words.
_CARD_BRANCH = """
import ctypes, json, types, torch
from repro_torch.kernels import _build, ops
calls = []
def entry(name):
    def fn(*args):
        calls.append((name, args))
        return 0
    return fn
lib = types.SimpleNamespace(**{n: entry(n) for n in (
    "flash_attention_fwd", "paged_attention_fwd", "bma_select_fwd", "rglru_scan_fwd",
    "rglru_scan_bwd", "fused_ec_update", "fused_precond_ec_update")})
_build.library = lambda name: lib
ops._on_card = lambda *t: True
torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
x = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16)
if WRAPPER == "flash_attention":
    ops.flash_attention(x, x[:, :1].contiguous(), x[:, :1].contiguous())
elif WRAPPER == "paged_attention":
    pages = torch.zeros((3, 8, 2, 64), dtype=torch.bfloat16)
    ops.paged_attention(x[:, :, :2].contiguous(), pages, pages,
                        torch.ones((1, 2), dtype=torch.int32), torch.ones(1, dtype=torch.int32))
elif WRAPPER == "fused_bma_select":
    ops.fused_bma_select(torch.zeros((4, 3, 5000)), torch.Generator().manual_seed(0),
                         mode="logprobs", temperature=0.7, top_k=50)
elif WRAPPER == "fused_ec_update":  # chains 2 and 3 of a split run, Philox mode
    z = torch.zeros((2, 12))
    ops.fused_ec_update(z, z, z, z[0], eps=1e-2, friction=1.0, mass=1.0, alpha=1.0, sigma_p=0.1,
                        seed=9, leaf=1, step=3, chain_offset=2)
elif WRAPPER == "fused_precond_ec_update":
    z = torch.zeros((2, 12))
    ops.fused_precond_ec_update(z, z, z, z[0], z, eps=1e-2, friction=1.0, alpha=1.0,
                                sigma_p=0.1, seed=9, leaf=1, step=3)
elif WRAPPER == "rglru_scan_bwd":  # the forward, then its backward through autograd
    a = torch.zeros((2, 8, 32), dtype=torch.float16, requires_grad=True)
    h0 = torch.zeros((2, 32), requires_grad=True)
    ops.rglru_scan(a, torch.zeros((2, 8, 32)), h0).sum().backward()
    assert a.grad.dtype == torch.float16 and h0.grad.shape == (2, 32)
else:  # an f16 a with an f32 x: the kernel reads both as f32
    ops.rglru_scan(torch.zeros((2, 8, 32), dtype=torch.float16), torch.zeros((2, 8, 32)))
name, args = calls[-1]
fn = getattr(lib, name)
kinds = ["ptr" if t is ctypes.c_void_p else "float" if t is ctypes.c_float
         else "int%d" % (8 * ctypes.sizeof(t)) for t in fn.argtypes]
counter = "bma_select" if WRAPPER == "fused_bma_select" else WRAPPER
print(json.dumps(dict(name=name, kinds=kinds, launches=ops.launches[counter], calls=len(calls),
                      args=[a if isinstance(a, (int, float)) or a is None else repr(a) for a in args])))
"""

_SOURCES = {"flash_attention": "flash_attention", "paged_attention": "paged_attention",
            "fused_bma_select": "bma_select", "rglru_scan": "rglru", "rglru_scan_bwd": "rglru",
            "fused_ec_update": "fused_ecsghmc", "fused_precond_ec_update": "fused_ecsghmc"}


def _c_signature(source: str, entry: str):
    """The parameter kinds of ``extern "C" int entry(...)`` in csrc/<source>.cu."""
    import pathlib
    import re

    text = (pathlib.Path(kbma.__file__).parent / "csrc" / f"{source}.cu").read_text()
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text).group(1)
    kinds = []
    for p in params.split(","):
        decl = " ".join(p.split()[:-1])
        kinds.append("ptr" if "*" in p else "float" if decl == "float"
                     else "int64" if decl.endswith("long long") else "int32")
    return kinds


@pytest.mark.parametrize("wrapper", ["flash_attention", "paged_attention", "fused_bma_select",
                                     "rglru_scan", "rglru_scan_bwd", "fused_ec_update",
                                     "fused_precond_ec_update"])
def test_card_branch_reaches_the_c_entry(wrapper):
    import json
    import subprocess
    import sys

    code = f"WRAPPER = {wrapper!r}\n" + _CARD_BRANCH
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["launches"] == 1
    assert got["calls"] == (2 if wrapper == "rglru_scan_bwd" else 1)
    assert got["kinds"] == _c_signature(_SOURCES[wrapper], got["name"])
    assert len(got["args"]) == len(got["kinds"])
    if wrapper == "fused_bma_select":  # logits (4, 3, 5000), logprobs, T 0.7, top-k 50
        assert got["args"][5] == kbma.scratch_words(4, 3, 5000)
        assert got["args"][6:10] == [4, 3, 5000, 1] and got["args"][11] == 50
    if wrapper == "rglru_scan":  # (B, S, R, is_bf16)
        assert got["args"][4:8] == [2, 8, 32, 0]
    if wrapper == "rglru_scan_bwd":  # h0 and dh0 given, then (B, S, R)
        assert got["name"] == "rglru_scan_bwd"
        assert got["args"][3] is not None and got["args"][6] is not None
        assert got["args"][7:10] == [2, 8, 32]
    if wrapper == "fused_ec_update":  # (K, N, chain_offset), then seed, leaf, step
        assert got["args"][8:11] == [2, 12, 2] and got["args"][14:17] == [9, 1, 3]
    if wrapper == "fused_precond_ec_update":  # (K, N), no chain_offset
        assert got["args"][9:11] == [2, 12] and got["args"][14:17] == [9, 1, 3]


def test_bma_scratch_words():
    """Per (slot, chunk): K member pairs, the argmax pair, the warp maxima and
    a radix histogram; per slot: the candidate list and six words."""
    C = -(-151936 // kbma.CHUNK)
    assert C == 75
    per_chunk = 2 * 4 + 2 + kbma.WARPS + kbma.BINS
    assert kbma.scratch_words(4, 8, 151936) == 8 * C * per_chunk + 8 * (3 * kbma.LIST + 7)
    assert kbma.scratch_words(1, 1, 1) == 2 + 2 + kbma.WARPS + kbma.BINS + 3 * kbma.LIST + 7


# ---------------------------------------------------------------------------
# on the card (skipped without one; chip_smoke.py is the card's check)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; chip_smoke.py runs these checks on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(card):
    q, k, v = (torch.tensor(_np(i, 1, 4, 64, 128), device=card).to(torch.bfloat16)
               for i in (1, 2, 3))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                               ref.attention(q, k, v).float(), atol=2e-2, rtol=0)
    q, k, v = (torch.tensor(_np(i, 1, 10, 64, 256), device=card).to(torch.bfloat16)
               for i in (7, 8, 9))
    k, v = k[:, :1].contiguous(), v[:, :1].contiguous()
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=16).float(),
                               ref.attention(q, k, v, window=16).float(), atol=2e-2, rtol=0)
    for S, kw in ((100, {}), (128, dict(softcap=50.0))):  # ragged S; gemma2's softcap
        q, k, v = (torch.tensor(_np(i, 1, h, S, 128), device=card).to(torch.bfloat16)
                   for i, h in ((10, 16), (11, 8), (12, 8)))
        torch.testing.assert_close(ops.flash_attention(q, k, v, **kw).float(),
                                   ref.attention(q, k, v, **kw).float(), atol=2e-2, rtol=0)
    args = [torch.tensor(a, device=card) for a in _paged_case(3, B=4, Hkv=2, G=2, d=64, bs=16,
                                                                 M=3, permute=True)]
    torch.testing.assert_close(ops.paged_attention(*args), ref.paged_attention(*args),
                               atol=1e-5, rtol=0)
    args = [torch.tensor(a, device=card) for a in _paged_case(4, B=4, Hkv=2, G=2, d=64, bs=16,
                                                                 M=4, ctx=[0, 17, 40, 63])]
    torch.testing.assert_close(ops.paged_attention(*args, window=20),
                               ref.paged_attention(*args, window=20), atol=1e-5, rtol=0)
    # the select kernel: K = 3 (any member count) and 4 (the main path's), V
    # with a ragged last chunk, V % 4 != 0 (no 16-byte copies), ties at the
    # top-k threshold, top_k at and above the candidate capacity, and V
    ties = torch.tensor(np.round(_np(7, 4, 4, 6000, scale=2.0)), device=card)
    cases = [(torch.tensor(_np(5, 3, 4, 5000), device=card), 10),
             (torch.tensor(_np(8, 4, 4, 4099, scale=3.0), device=card), 50),
             (ties, 50), (ties, kbma.KCAP), (ties, kbma.KCAP + 1), (ties, 6000)]
    for logits, top_k in cases:
        V = logits.shape[-1]
        gum = torch.tensor(_np(6, 4, V), device=card)
        for mode in ("probs", "logprobs"):
            for T, k, g in ((0.0, 0, None), (0.7, 0, gum), (0.7, top_k, gum)):
                tok, logp = kbma.launch(logits, g, mode=mode, temperature=T, top_k=k)
                rtok, rlogp = ref.bma_select(logits, g, mode=mode, temperature=T, top_k=k)
                torch.testing.assert_close(logp, rlogp, atol=1e-5, rtol=0)
                torch.testing.assert_close(tok, rtok, atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_flash_refuses_grad(card):
    q, k, v = (torch.zeros(1, 2, 8, 64, device=card) for _ in range(3))
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k[:, :1].contiguous(), v[:, :1].contiguous())
    with torch.no_grad():
        assert ops.flash_attention(q, k[:, :1].contiguous(), v[:, :1].contiguous()).shape == q.shape
