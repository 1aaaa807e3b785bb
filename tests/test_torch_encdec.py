"""The port's audio family (whisper-base: ``models/encdec.py``) against the
reference's, on the CPU.

The SMOKE configuration on params drawn by ``repro.models.init_params``
and carried across with ``_interop``, with frame embeddings for the
stubbed frontend: the spec tree at SMOKE and full size, the encoder, the
non-causal plain attention on a length that is not a multiple of its query
chunk, cross-attention, prefill (logits, the four cache leaves and ``t``)
then three decode steps, with the flash kernel off and on (its plain
version here), ``train_nll`` and its gradient, and
``launch.serve.ensemble_decode`` at K = 2.  Layers match at 1e-5 and the
model at the reference suite's 2e-5, each plus ``torch_parity.SCALE_RTOL``
of the compared tensor's largest magnitude: the SMOKE attention outputs
reach |33|, where the reference itself is 8.1e-5 from an f64 run of the
port on the same weights (the port 8.2e-5), and the cache leaves |16|,
where it is 1.8e-5 off (the port 2.6e-5).  The ensemble's tokens are
identical.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.launch import serve as jserve
from repro.models import encdec as jE
from repro.models import layers as jL
from repro_torch import configs
from repro_torch.launch import serve as serve_launch
from repro_torch.models import encdec as E
from repro_torch.models import get_model, tree_map
from repro_torch.models import layers as L

ARCH = "whisper-base"
B, S = 2, 12
LAYER_ATOL = 1e-5


@pytest.fixture(scope="module")
def shared():
    return tp.setup(ARCH, seed=1)


def _frames(cfg, seed=3, batch=B):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model))).astype(np.float32)


def _layer_close(got, want, what=""):
    tp.assert_close(got, want, atol=LAYER_ATOL, what=what)


def test_config_and_specs_match_reference():
    tp.check_config_and_specs(ARCH)
    full = configs.get_config(ARCH)
    assert (full.enc_layers, full.num_layers, full.enc_seq, full.head_dim) == (6, 6, 1500, 64)
    assert get_model(full).paged is None
    assert E.param_specs(full)["dec_pos"].shape == (36864, 512)


def test_encode_matches_reference(shared):
    jcfg, _, jparams, cfg, params = shared
    x = _frames(cfg)
    tp.assert_close(E.encode(cfg, params, torch.tensor(x)), jE.encode(jcfg, jparams, jnp.asarray(x)),
                    what="encode")


@pytest.mark.parametrize("Sx,q_chunk", [(30, 8), (60, 16)])
def test_noncausal_attention_with_a_ragged_query_chunk(shared, Sx, q_chunk):
    """q_chunk does not divide S: the plain path takes the largest divisor
    below it, as the reference does (whisper's 1500 frames under 1024)."""
    jcfg, _, jparams, cfg, params = shared
    p = tree_map(lambda a: a[0], params["enc_layers"]["attn"])
    jp = jax.tree.map(lambda a: a[0], jparams["enc_layers"]["attn"])
    x = np.random.default_rng(Sx).standard_normal((B, Sx, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sx, dtype=np.int32)[None], (B, Sx))
    got = L.attention(cfg, p, torch.tensor(x), torch.tensor(pos), None, q_chunk=q_chunk,
                      causal=False)
    want = jL.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), None, q_chunk=q_chunk,
                        causal=False)
    _layer_close(got, want, "non-causal attention")
    whole = L.attention(cfg, p, torch.tensor(x), torch.tensor(pos), None, q_chunk=Sx,
                        causal=False)
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)


def test_cross_attention_matches_reference(shared):
    jcfg, _, jparams, cfg, params = shared
    p = tree_map(lambda a: a[1], params["dec_layers"]["xattn"])
    jp = jax.tree.map(lambda a: a[1], jparams["dec_layers"]["xattn"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    kv = E._enc_kv(cfg, p, torch.tensor(enc))
    jkv = jE._enc_kv(jcfg, jp, jnp.asarray(enc))
    for a, b in zip(kv, jkv):
        _layer_close(a, b, "enc k/v")
    got = E._cross_attention(cfg, p, torch.tensor(x), kv)
    _layer_close(got, jE._cross_attention(jcfg, jp, jnp.asarray(x), jkv), "cross attention")


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_and_decode_match_reference(shared, flash):
    jcfg, jmodel, jparams, cfg, params = shared
    jcfg, cfg = jcfg.replace(use_flash_kernel=flash), cfg.replace(use_flash_kernel=flash)
    model = get_model(cfg)
    frames, prompt, max_seq = _frames(cfg, 5), tp.tokens(0, (B, S)), S + 6
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt),
                                                "frame_embeds": jnp.asarray(frames)}, max_seq)
    tl, cache = model.prefill(cfg, params, {"tokens": torch.tensor(prompt),
                                            "frame_embeds": torch.tensor(frames)}, max_seq)
    tp.assert_close(tl, jl, what="prefill logits")
    assert sorted(cache) == sorted(jcache) == ["cross_k", "cross_v", "self_k", "self_v", "t"]
    assert int(cache["t"]) == int(jcache["t"]) == S
    assert tuple(cache["cross_k"].shape) == (cfg.num_layers, B, cfg.enc_seq, 4, 16)
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        tp.assert_close(cache[key], jcache[key], what=f"prefill {key}")
    for i in range(3):
        nt = tp.tokens(10 + i, (B, 1))
        jl, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(nt))
        tl, cache = model.decode_step(cfg, params, cache, torch.tensor(nt))
        tp.assert_close(tl, jl, what=f"decode {i} logits")
    assert int(cache["t"]) == S + 3
    for key in ("self_k", "self_v"):
        tp.assert_close(cache[key], jcache[key], what=f"decode {key}")


def test_decode_continues_prefill(shared):
    """decode after a prefill of 8 tokens == the last position of a prefill
    of 9..12 tokens, over the same frames."""
    *_, cfg, params = shared
    model = get_model(cfg)
    toks = torch.tensor(tp.tokens(9, (1, 12)))
    frames = torch.tensor(_frames(cfg, 6, batch=1))

    def last_logits(n):
        return model.prefill(cfg, params, {"tokens": toks[:, :n], "frame_embeds": frames},
                             16)[0][0, 0].numpy()

    lg, cache = model.prefill(cfg, params, {"tokens": toks[:, :8], "frame_embeds": frames}, 16)
    for t in range(8, 12):
        lg, cache = model.decode_step(cfg, params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(lg[0, 0].numpy(), last_logits(t + 1), rtol=2e-4, atol=2e-4)


def test_train_nll_and_grad_match_reference(shared):
    jcfg, jmodel, jparams, cfg, params = shared
    b = tp.nll_batch(16, seed=8)
    b["frame_embeds"] = _frames(cfg, 7)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    jn, jc = jmodel.train_nll(jcfg, jparams, jb)
    n, c = get_model(cfg).train_nll(cfg, params, tb)
    assert float(c) == float(jc) == 2 * 16 - 7
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6, atol=tp.ATOL)
    tp.check_grads(shared, b)


def test_ensemble_decode_matches_reference():
    """K = 2 members, the mean predictive probs, greedy: the reference's
    ``ensemble_decode`` gives the same tokens."""
    jcfg, jmodel, jmembers, cfg, model, members = tp.member_setup(ARCH, K=2)
    batch = {"tokens": tp.tokens(2, (B, 6)), "frame_embeds": _frames(cfg, 8)}
    want = jserve.ensemble_decode(jcfg, jmodel, jmembers,
                                  {k: jnp.asarray(v) for k, v in batch.items()}, 16, 6)
    got = serve_launch.ensemble_decode(cfg, model, members,
                                       {k: torch.tensor(v) for k, v in batch.items()}, 16, 6)
    assert tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
