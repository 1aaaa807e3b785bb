"""Rematerialisation (``cfg.remat``) and the one-hot embedding lookup
(``cfg.embed_onehot``) of the port, on the CPU at SMOKE sizes.

* ``remat="full"`` (the default) checkpoints each period of the backbone
  (``transformer.backbone``) and whisper checkpoints every encoder and
  decoder layer whatever ``remat`` says: ``train_nll`` and every gradient
  leaf are bitwise those of the run without checkpoints, for the six
  families (dense, hybrid, MoE, xlstm, vlm, audio).
* The recompute happens: the period's blocks (and the RG-LRU scan, an
  autograd Function) run again in the backward pass, the remainder layers
  do not.
* With nothing requiring grad (serving), no checkpoint is entered and each
  block runs once.
* ``backbone(remat=True/False)``'s gradients match the reference's under
  ``jax.grad`` within ``torch_parity``'s rule.
* ``core.chainwise`` (``torch.func``) takes a SMOKE language model with
  ``remat="none"`` and refuses ``remat="full"`` naming the way out.
* ``embed_onehot=True`` gives the reference's values and the gather's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.core.potential import chainwise, make_potential, value_and_grad
from repro_torch.kernels import ops
from repro_torch.launch.train import build_batch_fn
from repro_torch.models import encdec, get_model, init_params, layers, tree_leaves, tree_map
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_unflatten

FAMILIES = ("qwen3-0.6b", "recurrentgemma-2b", "olmoe-1b-7b", "xlstm-350m", "qwen2-vl-7b",
            "whisper-base")


def _setup(arch, seed=0):
    cfg = configs.get_config(arch, smoke=True)
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(model.param_specs(cfg), gen, "cpu")
    batch = build_batch_fn(cfg, 1, 2, 32, seed=seed, device="cpu")(0)
    return cfg, model, params, {k: v[0] for k, v in batch.items()}


def _no_checkpoint(monkeypatch):
    """Whisper's layers run without their checkpoints."""
    monkeypatch.setattr(encdec, "checkpointed", lambda fn, x, tree: fn(x, tree))


def _value_and_grads(cfg, model, params, batch):
    (value, grads) = value_and_grad(lambda p, b: model.train_nll(cfg, p, b)[0])(params, batch)
    return value, tree_leaves(grads)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_values_and_gradients_are_bitwise(arch, monkeypatch):
    cfg, model, params, batch = _setup(arch)
    v_full, g_full = _value_and_grads(cfg.replace(remat="full"), model, params, batch)
    if arch == "whisper-base":
        _no_checkpoint(monkeypatch)
    v_none, g_none = _value_and_grads(cfg.replace(remat="none"), model, params, batch)
    assert torch.isfinite(v_full) and torch.equal(v_full, v_none)
    assert len(g_full) == len(g_none)
    for i, (a, b) in enumerate(zip(g_full, g_none)):
        assert torch.equal(a, b), f"{arch} gradient leaf {i}"


def _counting(monkeypatch, module, name, calls):
    inner = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return inner(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("arch", FAMILIES)
def test_backward_recomputes_each_period(arch, monkeypatch):
    """Blocks entered in the forward pass, then in the backward: a
    period's P blocks again under remat, the remainder layers never; the
    hybrid's scan kernel wrapper too.  Whisper: every layer's attention
    (encoder self, decoder self) again."""
    cfg, model, params, batch = _setup(arch)
    calls, scans = [], []
    if arch == "whisper-base":
        _counting(monkeypatch, layers, "attention", calls)
        per_pass = recomputed = cfg.enc_layers + cfg.num_layers
    else:
        _counting(monkeypatch, T, "apply_block", calls)
        P, n_periods, rem = T._layout(cfg)
        per_pass, recomputed = cfg.num_layers, n_periods * P
    _counting(monkeypatch, ops, "rglru_scan", scans)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    nll, _ = model.train_nll(cfg, tree_unflatten(params, leaves), batch)
    fwd, fwd_scans = len(calls), len(scans)
    assert fwd == per_pass
    torch.autograd.grad(nll, leaves)
    assert len(calls) - fwd == recomputed
    if arch == "recurrentgemma-2b":
        n_rglru = sum(k.kind == "rglru" for k in cfg.layer_kinds)
        in_periods = sum(k.kind == "rglru" for k in cfg.pattern) * T._layout(cfg)[1]
        assert fwd_scans == n_rglru and len(scans) - fwd_scans == in_periods > 0
        assert in_periods < n_rglru  # SMOKE's remainder layers are not recomputed


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_checkpoint_without_autograd(arch, monkeypatch):
    """Plain params (as the serving engines hold them) in grad mode, and
    any params under no_grad: each block once, no checkpoint entered."""
    import torch.utils.checkpoint as ckpt

    def refuse(*a, **k):
        raise AssertionError("torch.utils.checkpoint entered")

    monkeypatch.setattr(ckpt, "checkpoint", refuse)
    cfg, model, params, batch = _setup(arch)
    calls = []
    if arch == "whisper-base":
        _counting(monkeypatch, layers, "attention", calls)
        per_pass = cfg.enc_layers + cfg.num_layers
    else:
        _counting(monkeypatch, T, "apply_block", calls)
        per_pass = cfg.num_layers
    model.train_nll(cfg, params, batch)
    assert len(calls) == per_pass
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.no_grad():
        model.train_nll(cfg, tree_unflatten(params, leaves), batch)
    assert len(calls) == 2 * per_pass
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    _, cache = model.prefill(cfg, params, prompt, 40)
    model.decode_step(cfg, params, cache, batch["tokens"][:, :1])


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "recurrentgemma-2b"))
@pytest.mark.parametrize("remat", (True, False))
def test_backbone_gradients_match_the_reference(arch, remat):
    """The gradient of a weighted sum of ``backbone``'s output, over the
    params and the input, against the reference's ``backbone`` with the
    same ``remat`` under ``jax.grad``; the port's with and without remat
    bitwise."""
    jcfg, _, jparams, cfg, params = tp.setup(arch, seed=2)
    jparams = {k: v for k, v in jparams.items() if k != "embed"}  # what backbone reads
    params = {k: v for k, v in params.items() if k != "embed"}
    rng = np.random.default_rng(3)
    B, S, D = 2, 16, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))

    def jloss(p, x_):
        return jnp.sum(jT.backbone(jcfg, p, x_, jnp.asarray(pos), remat) * w)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(x))

    def grads(flag):
        leaves = [a.clone().requires_grad_(True) for a in tree_leaves(params)]
        xt = torch.tensor(x, requires_grad=True)
        out = T.backbone(cfg, tree_unflatten(params, leaves), xt, torch.tensor(pos), flag)
        return torch.autograd.grad(torch.sum(out * torch.tensor(w)), leaves + [xt])

    got = grads(remat)
    tp.assert_close(got[-1], jg_x, what="input gradient")
    jleaves = jax.tree.leaves(jg_p)
    assert len(got) - 1 == len(jleaves)
    for i, (g, jg) in enumerate(zip(got[:-1], jleaves)):
        tp.assert_close(g, jg, what=f"grad leaf {i}")
    for a, b in zip(got, grads(not remat)):
        assert torch.equal(a, b)


def test_chainwise_takes_remat_none_and_refuses_remat_full():
    """``core.chainwise`` lifts the potential with ``torch.func``, which
    runs no checkpoint: remat="none" gives the per-chain autograd values,
    remat="full" raises naming remat='none'."""
    cfg0 = configs.get_config("qwen3-0.6b", smoke=True)
    model = get_model(cfg0)
    gen = torch.Generator().manual_seed(4)
    K = 2
    params = tree_map(lambda *ls: torch.stack(ls),
                      *[init_params(model.param_specs(cfg0), gen, "cpu") for _ in range(K)])
    batch = build_batch_fn(cfg0, K, 2, 16, seed=4, device="cpu")(0)

    def pot(cfg):
        return make_potential(lambda p, b: (model.train_nll(cfg, p, b)[0], 2), 1000)

    values, grads = chainwise(pot(cfg0.replace(remat="none"))).value_and_grad(params, batch)
    for k in range(K):
        v, g = pot(cfg0).value_and_grad(tree_map(lambda x: x[k], params),
                                        {n: b[k] for n, b in batch.items()})
        np.testing.assert_allclose(float(values[k]), float(v), rtol=1e-5)
        for a, b in zip(tree_leaves(grads), tree_leaves(g)):
            tp.assert_close(a[k], b.numpy(), what=f"chain {k}")
    with pytest.raises(RuntimeError, match="remat='none'"):
        chainwise(pot(cfg0)).value_and_grad(params, batch)


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "h2o-danube-1.8b", "recurrentgemma-2b"))
def test_embed_onehot_matches_the_reference_and_the_gather(arch):
    """``embed_onehot=True``: the embedding and ``train_nll`` with its
    gradient equal the reference's with the same flag (h2o-danube: untied
    logits; recurrentgemma: the sqrt(d) scale), and the lookup equals the
    gather's."""
    s = tp.setup(arch, seed=5, embed_onehot=True)
    jcfg, jmodel, jparams, cfg, params = s
    assert cfg.embed_onehot
    toks = tp.tokens(6, (2, 24))
    from repro.models import layers as jL

    x = layers.embed(cfg, params["embed"], torch.tensor(toks))
    tp.assert_close(x, jL.embed(jcfg, jparams["embed"], jnp.asarray(toks)), what="embed")
    gather = layers.embed(cfg.replace(embed_onehot=False), params["embed"], torch.tensor(toks))
    tp.assert_close(x, gather.numpy(), what="one-hot vs gather")
    tp.check_train_nll(s)
    tp.check_grads(s, tp.nll_batch(), jit=True)
