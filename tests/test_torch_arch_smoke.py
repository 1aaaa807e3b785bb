"""Per-architecture smoke tests of the port, beside the reference's
(``tests/test_arch_smoke.py`` and the model part of
``tests/test_model_properties.py``), for all ten architectures; each
family's batch is built as the reference's test builds it (vlm: 8 patch
embeddings on a 2 x 4 grid of M-RoPE positions before 24 text tokens;
audio: frame embeddings for the encoder).

At the SMOKE size, on params carried across from the reference's init and
the same inputs on both sides: the train forward (finite, near-uniform
NLL per token, equal to the reference's), finite gradients on both sides,
prefill and decode shapes with greedy tokens equal to the reference's,
decode == prefill incremental (2e-4; 5e-4 for the recurrent block, as in
the reference), attention causality and window locality, and the two MoE
properties (output finite and shaped; capacity factor 8 == 64).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.models import layers as jL
from repro.models import moe as jM
from repro_torch import _interop
from repro_torch.models import get_model, tree_leaves
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.common import tree_unflatten

ARCHS = ("qwen3-0.6b", "h2o-danube-1.8b", "gemma2-27b", "gemma3-27b", "olmoe-1b-7b",
         "grok-1-314b", "recurrentgemma-2b", "xlstm-350m", "qwen2-vl-7b", "whisper-base")
B, S = 2, 32
N_PATCH = 8


@pytest.fixture(scope="module")
def arch_setup():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = tp.setup(arch, seed=0)
        return cache[arch]

    return get


def _batch(cfg, seed, labels=True):
    """tokens (and labels) (B, n_text), plus the family's inputs: vlm patch
    embeddings with (t, h, w) positions, patches at (0, i // 4, i % 4) and
    text continuing at 1, 2, ... on every stream; audio frame embeddings."""
    rng = np.random.default_rng(seed + 200)
    n_text = S
    batch = {}
    if cfg.family == "vlm":
        n_text = S - N_PATCH
        batch["patch_embeds"] = (0.02 * rng.standard_normal((B, N_PATCH, cfg.d_model))).astype(
            np.float32)
        i, text = np.arange(N_PATCH), np.arange(n_text) + 1
        pos = np.stack([np.concatenate([np.zeros(N_PATCH, np.int64), text]),
                        np.concatenate([i // 4, text]), np.concatenate([i % 4, text])])
        batch["positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, B, S))).astype(np.int32)
    if cfg.family == "audio":
        batch["frame_embeds"] = (0.02 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))).astype(
            np.float32)
    batch["tokens"] = tp.tokens(seed, (B, n_text), cfg.vocab_size)
    if labels:
        batch["labels"] = tp.tokens(seed + 100, (B, n_text), cfg.vocab_size)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward(arch, arch_setup):
    jcfg, jmodel, jparams, cfg, params = arch_setup(arch)
    b = _batch(cfg, 1)
    jn, jc = jax.jit(lambda p, bb: jmodel.train_nll(jcfg, p, bb))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    n, c = get_model(cfg).train_nll(cfg, params, {k: torch.tensor(v) for k, v in b.items()})
    assert np.isfinite(float(n)) and int(c) == int(jc) == B * b["labels"].shape[1]
    per_tok = float(n) / float(c)  # untrained: near uniform, NLL/token near log V
    assert 0.5 * np.log(cfg.vocab_size) < per_tok < 2.0 * np.log(cfg.vocab_size), per_tok
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6, atol=tp.ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_grads_finite(arch, arch_setup):
    jcfg, jmodel, jparams, cfg, params = arch_setup(arch)
    b = _batch(cfg, 2)

    def jloss(p):
        s, c = jmodel.train_nll(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()})
        return s / c

    jgrads = jax.tree.leaves(jax.jit(jax.grad(jloss))(jparams))
    leaves = [a.clone().requires_grad_(True) for a in tree_leaves(params)]
    s, c = get_model(cfg).train_nll(cfg, tree_unflatten(params, leaves),
                                    {k: torch.tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(s / c, leaves)
    assert len(grads) == len(jgrads)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert tuple(g.shape) == tuple(jg.shape), i
        assert torch.isfinite(g).all(), f"{arch}: non-finite port grad at leaf {i}"
        assert np.all(np.isfinite(np.asarray(jg))), f"{arch}: non-finite reference grad {i}"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode(arch, arch_setup):
    jcfg, jmodel, jparams, cfg, params = arch_setup(arch)
    model = get_model(cfg)
    b = _batch(cfg, 3, labels=False)
    max_seq = S + 8
    jl, jcache = jmodel.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in b.items()}, max_seq)
    tl, cache = model.prefill(cfg, params, {k: torch.tensor(v) for k, v in b.items()}, max_seq)
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size) and torch.isfinite(tl).all()
    assert int(cache["t"]) == S
    for step in range(3):
        tp.assert_close(tl, jl, what=f"{arch} step {step}")
        tok = tl[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jnp.argmax(jl[:, -1], -1))[:, None])
        jl, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(tok.numpy()))
        tl, cache = model.decode_step(cfg, params, cache, tok)
        assert tuple(tl.shape) == (B, 1, cfg.vocab_size) and torch.isfinite(tl).all()
    tp.assert_close(tl, jl, what=f"{arch} last step")


# decode after a prefill of N tokens == the last position of a prefill of
# N + 1..N + 4 tokens; windowed archs start past the SMOKE window of 8.  The
# MoE archs run with a capacity no prefill fills: a prefill group drops
# entries past its capacity where a one-token decode never does.  The audio
# family's prefills share one set of frames; the vlm family's prompts are
# text (its decode continues every stream at t)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_incremental(arch, arch_setup):
    *_, cfg, params = arch_setup(arch)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=64.0)
    model = get_model(cfg)
    windowed = any(k.window for k in cfg.layer_kinds)
    n0 = 10 if windowed else 8
    tol = 5e-4 if cfg.family in ("hybrid", "ssm") else 2e-4
    toks = torch.tensor(tp.tokens(7, (1, n0 + 4), cfg.vocab_size))
    extra = {k: torch.tensor(v[:1]) for k, v in _batch(cfg, 7).items() if k == "frame_embeds"}

    def last_logits(n):
        return model.prefill(cfg, params, {"tokens": toks[:, :n], **extra}, 16)[0][0, 0].numpy()

    lg, cache = model.prefill(cfg, params, {"tokens": toks[:, :n0], **extra}, 16)
    np.testing.assert_allclose(lg[0, 0].numpy(), last_logits(n0), rtol=tol, atol=tol)
    for t in range(n0, n0 + 4):
        lg, cache = model.decode_step(cfg, params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(lg[0, 0].numpy(), last_logits(t + 1), rtol=tol, atol=tol,
                                   err_msg=f"{arch} decode at t={t}")


def _attn_pair(flash):
    jcfg = jconfigs.get_config("h2o-danube-1.8b", smoke=True)
    jp = jinit_params(jL.attn_specs(jcfg), jax.random.PRNGKey(0))
    cfg = _interop.config_from(jcfg).replace(use_flash_kernel=flash)
    return jcfg, jp, cfg, _interop.tree_from_numpy(jax.tree.map(np.asarray, jp))


def _attn_both(pair, x, window, Sx):
    jcfg, jp, cfg, p = pair
    pos = np.broadcast_to(np.arange(Sx, dtype=np.int32)[None], (1, Sx))
    got = L.attention(cfg, p, torch.tensor(x), torch.tensor(pos), window=window).numpy()
    want = np.asarray(jL.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), window=window))
    tp.assert_close(got, want, what=f"attention window={window}")
    return got


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_causality(seed, flash):
    """Changing future tokens does not change past outputs."""
    pair = _attn_pair(flash)
    Sx = 16
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((1, Sx, pair[2].d_model)).astype(np.float32)
    x2 = x1.copy()
    x2[:, Sx // 2:] = rng.standard_normal((1, Sx // 2, pair[2].d_model))
    o1, o2 = _attn_both(pair, x1, None, Sx), _attn_both(pair, x2, None, Sx)
    np.testing.assert_allclose(o1[:, :Sx // 2], o2[:, :Sx // 2], rtol=1e-5, atol=1e-5)
    assert not np.allclose(o1[:, Sx // 2:], o2[:, Sx // 2:], atol=1e-3)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("window", [2, 4, 8])
def test_window_locality(window, flash):
    """With window w, a token further than w back has no influence."""
    pair = _attn_pair(flash)
    Sx = 16
    x1 = np.random.default_rng(2).standard_normal((1, Sx, pair[2].d_model)).astype(np.float32)
    x2 = x1.copy()
    x2[:, 0] += 1.0  # perturb only position 0: outputs at t >= window are unchanged
    o1, o2 = _attn_both(pair, x1, window, Sx), _attn_both(pair, x2, window, Sx)
    np.testing.assert_allclose(o1[:, window:], o2[:, window:], rtol=1e-5, atol=1e-5)
    assert not np.allclose(o1[:, :window], o2[:, :window], atol=1e-3)


def _moe_pair(**replace):
    jcfg = jconfigs.get_config("olmoe-1b-7b", smoke=True).replace(**replace)
    jp = jinit_params(jM.moe_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jp, _interop.config_from(jcfg), _interop.tree_from_numpy(
        jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_moe_output_finite_and_shaped(seed):
    jcfg, jp, cfg, p = _moe_pair()
    x = np.random.default_rng(seed).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    y = M.moe_ffn(cfg, p, torch.tensor(x)).numpy()
    assert y.shape == x.shape and np.isfinite(y).all()
    np.testing.assert_allclose(y, np.asarray(jM.moe_ffn(jcfg, jp, jnp.asarray(x))), atol=1e-5)


def test_capacity_drops_are_bounded():
    """With capacity_factor >= E / top_k every entry fits: factor 8 gives
    the output of factor 64."""
    jcfg, jp, cfg, p = _moe_pair(capacity_factor=8.0)
    x = torch.tensor(np.random.default_rng(1).standard_normal((1, 32, cfg.d_model)),
                     dtype=torch.float32)
    y1 = M.moe_ffn(cfg, p, x)
    y2 = M.moe_ffn(cfg.replace(capacity_factor=64.0), p, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jM.moe_ffn(jcfg, jp, jnp.asarray(x.numpy()))),
                               atol=1e-5)
