"""The port's vlm backbone (qwen2-vl-7b: M-RoPE position streams, patch
embeddings prepended to the text) against the reference's, on the CPU.

The SMOKE configuration on params drawn by ``repro.models.init_params``
and carried across with ``_interop``.  M-RoPE runs on three distinct
position streams: a (t, h, w) grid for a block of patches, then text that
continues from the grid's max + 1 on all three (with identical streams
M-RoPE is plain RoPE, and a test of it would prove nothing).  Checked
against the reference: ``apply_rope`` (1e-5), ``train_nll`` with the
patch prefix sliced off the labels, prefill with patch
embeddings and the explicit streams then three decode steps (logits and
every cache leaf), and the dense ``ServeEngine`` on text prompts (the
reference suite's 2e-5 with ``torch_parity.SCALE_RTOL``, whose comment
gives the reference's own distance from an f64 run on this config;
tokens identical).  The paged engine is refused with the reference's
message, and the M-RoPE prefill keeps the reference's gate: it never
reaches the flash kernel.

``train_nll``'s gradient is not compared here: with the patch prefix this
SMOKE config's gradient is ill-conditioned, and against an f64 run of the
port on the same weights the reference is off by up to 3.8e-3 and the
port by up to 6.3e-3 over four batches (the reference the further on two
of them), beyond what the per-tensor SCALE_RTOL rule covers.  ``test_torch_arch_smoke.py``
holds it finite on both sides.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.models import layers as jL
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.specs import VLM_PATCHES, vlm_patches
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.serve.engine import ServeEngine

ARCH = "qwen2-vl-7b"
B, N_PATCH, N_TEXT = 2, 8, 12


@pytest.fixture(scope="module")
def shared():
    return tp.setup(ARCH, seed=1)


def grid_positions(batch, n_patch, n_text, cols=4):
    """(3, batch, n_patch + n_text) int32: patches at (t=0, h=i // cols,
    w=i % cols), then text at max + 1, max + 2, ... on every stream."""
    i = np.arange(n_patch)
    grid = np.stack([np.zeros(n_patch, np.int64), i // cols, i % cols])
    text = np.broadcast_to(grid.max() + 1 + np.arange(n_text), (3, n_text))
    pos = np.concatenate([grid, text], axis=1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, pos.shape[1]))).astype(
        np.int32)


def _patches(seed, shape):
    return (0.02 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _vlm_batch(cfg, seed=1, labels=True):
    b = {"tokens": tp.tokens(seed, (B, N_TEXT)),
         "patch_embeds": _patches(seed + 50, (B, N_PATCH, cfg.d_model)),
         "positions": grid_positions(B, N_PATCH, N_TEXT)}
    if labels:
        b["labels"] = tp.tokens(seed + 100, (B, N_TEXT))
    return b


def _both(b):
    return ({k: torch.tensor(v) for k, v in b.items()}, {k: jnp.asarray(v) for k, v in b.items()})


def test_config_and_specs_match_reference():
    tp.check_config_and_specs(ARCH)
    full = configs.get_config(ARCH)
    assert full.mrope_sections == (16, 24, 24) and sum(full.mrope_sections) == full.head_dim // 2
    assert (VLM_PATCHES, vlm_patches(4096), vlm_patches(32)) == (64, 64, 16)


def test_grid_positions_are_three_distinct_streams():
    pos = grid_positions(1, N_PATCH, N_TEXT)[:, 0]
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    assert (pos[:, N_PATCH] == pos[:, :N_PATCH].max() + 1).all()


def test_mrope_matches_reference():
    cfg = configs.get_config(ARCH, smoke=True)
    pos = grid_positions(B, N_PATCH, N_TEXT)
    x = np.random.default_rng(0).standard_normal(
        (B, N_PATCH + N_TEXT, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), cfg.rope_theta, cfg.mrope_sections)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta, cfg.mrope_sections)
    tp.assert_close(got, want, atol=1e-5, scale_rtol=0.0, what="M-RoPE")
    # the h and w streams matter: rotating by the t stream alone differs by
    # 100x the tolerance (they drive the lowest frequencies)
    single = L.apply_rope(torch.tensor(x), torch.tensor(pos[0]), cfg.rope_theta)
    assert float((got - single)[:, :N_PATCH].abs().max()) > 1e-3
    with pytest.raises(ValueError, match="M-RoPE"):
        L.apply_rope(torch.tensor(x), torch.tensor(pos[0]), cfg.rope_theta, cfg.mrope_sections)


def test_default_positions_broadcast_the_arange_to_three_streams(shared):
    """Without ``positions`` the prefill uses the arange on all three
    streams, as the reference's ``_positions`` does."""
    jcfg, jmodel, jparams, cfg, params = shared
    b = {"tokens": tp.tokens(3, (B, N_TEXT)),
         "patch_embeds": _patches(4, (B, N_PATCH, cfg.d_model))}
    tb, jb = _both(b)
    tl, _ = get_model(cfg).prefill(cfg, params, tb, 32)
    jl, _ = jmodel.prefill(jcfg, jparams, jb, 32)
    tp.assert_close(tl, jl, what="prefill logits, default positions")


def test_train_nll_with_patch_prefix_matches_reference(shared):
    """The patch prefix is embedded and attended to, then sliced off before
    the loss: the count is the text's."""
    jcfg, jmodel, jparams, cfg, params = shared
    b = _vlm_batch(cfg, seed=5)
    b["mask"] = (np.arange(N_TEXT)[None] < np.asarray([[N_TEXT], [N_TEXT - 5]])).astype(np.float32)
    tb, jb = _both(b)
    jn, jc = jmodel.train_nll(jcfg, jparams, jb)
    n, c = get_model(cfg).train_nll(cfg, params, tb)
    assert float(c) == float(jc) == 2 * N_TEXT - 5
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6, atol=tp.ATOL)


def test_prefill_with_patches_then_decode_matches_reference(shared):
    jcfg, jmodel, jparams, cfg, params = shared
    model = get_model(cfg)
    tb, jb = _both(_vlm_batch(cfg, seed=7, labels=False))
    max_seq = N_PATCH + N_TEXT + 4
    jl, jcache = jmodel.prefill(jcfg, jparams, jb, max_seq)
    tl, cache = model.prefill(cfg, params, tb, max_seq)
    assert int(cache["t"]) == int(jcache["t"]) == N_PATCH + N_TEXT
    tp.assert_close(tl, jl, what="prefill logits")
    tp.assert_trees_close(cache, jcache)
    for i in range(3):
        nt = tp.tokens(10 + i, (B, 1))
        jl, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(nt))
        tl, cache = model.decode_step(cfg, params, cache, torch.tensor(nt))
        tp.assert_close(tl, jl, what=f"decode {i} logits")
    tp.assert_trees_close(cache, jcache)


def test_mrope_prefill_never_reaches_flash(shared, monkeypatch):
    """``use_flash_kernel`` leaves an M-RoPE prefill on the plain chunked
    path (the reference's gate); the same config without M-RoPE does reach
    the flash wrapper, so the spy sees calls when they happen."""
    *_, cfg, params = shared
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    tb, _ = _both(_vlm_batch(cfg, seed=9, labels=False))
    flash_cfg = cfg.replace(use_flash_kernel=True)
    got, _ = get_model(cfg).prefill(flash_cfg, params, tb, 32)
    assert calls == []
    plain, _ = get_model(cfg).prefill(cfg, params, tb, 32)
    assert torch.equal(got, plain)
    rope_cfg = flash_cfg.replace(mrope_sections=None)
    get_model(cfg).prefill(rope_cfg, params, {"tokens": tb["tokens"]}, 32)
    assert len(calls) == cfg.num_layers


@pytest.fixture(scope="module")
def members():
    return tp.member_setup(ARCH, K=2)


def test_dense_engine_matches_reference_engine(members):
    rep = tp.check_engine(members, paged=False, bma="probs", fused=False)
    assert rep.total_tokens == 16


def test_paged_engine_is_refused_like_the_reference(members):
    jcfg, jmodel, jmembers, cfg, model, stack = members
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jcfg, jmodel, jmembers, num_slots=2, max_seq=24, paged=True)
    with pytest.raises(ValueError) as err:
        ServeEngine(cfg, model, stack, num_slots=2, max_seq=24, paged=True, device="cpu")
    assert str(err.value) == str(jerr.value) == \
        "paged decode does not support M-RoPE position streams"
