"""The port's MoE family (olmoe-1b-7b: 64 experts top-8, MHA; grok-1-314b:
8 experts top-2, softcaps at 30) against the reference's, on the CPU.

``models.moe.moe_ffn`` against ``repro.models.moe.moe_ffn`` at atol 1e-5:
at the default capacity factor, at one that drops entries, over more than
one dispatch group, and with a zero router, where every expert ties and
the reference takes experts 0..k-1 and drops past the capacity (this pins
the tie order, and that an entry whose slot is past the capacity neither
raises, as ``torch.nn.functional.one_hot`` would, nor takes a slot).  Then,
on the SMOKE configs with ``use_flash_kernel`` off and on: the configs and
spec trees, prefill, dense and paged decode, ``train_nll`` and its
gradient (plain autograd against ``jax.grad``), and the dense and paged
``ServeEngine`` against the reference's engine.
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
from repro.models import moe as jM
from repro_torch import _interop
from repro_torch.models import get_model, tree_leaves
from repro_torch.models.common import tree_unflatten
from repro_torch.models import moe as M

ARCHS = ("olmoe-1b-7b", "grok-1-314b")
MOE_ATOL = 1e-5


def _moe_pair(arch, seed=0, **replace):
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**replace)
    jp = jinit_params(jM.moe_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, jp, _interop.config_from(jcfg), _interop.tree_from_numpy(
        jax.tree.map(np.asarray, jp))


def _moe_both(jcfg, jp, cfg, p, x):
    want = np.asarray(jM.moe_ffn(jcfg, jp, jnp.asarray(x)))
    got = M.moe_ffn(cfg, p, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=MOE_ATOL)
    return got


# (B, S, capacity factor): the default; one that drops entries; S = 1024,
# two groups of GROUP = 512
MOE_CASES = {"default": (2, 16, 1.25), "drops": (2, 16, 0.5), "two-groups": (1, 1024, 1.25)}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, case):
    B, S, cf = MOE_CASES[case]
    jcfg, jp, cfg, p = _moe_pair(arch, capacity_factor=cf)
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    got = _moe_both(jcfg, jp, cfg, p, x)
    assert got.shape == x.shape and np.isfinite(got).all()
    # a capacity no group can fill drops nothing; at factor 0.5 entries drop
    full = _moe_both(jcfg.replace(capacity_factor=64.0), jp, cfg.replace(capacity_factor=64.0),
                     p, x)
    if case == "drops":
        assert not np.allclose(got, full, atol=MOE_ATOL)
    if case == "two-groups":
        assert M.GROUP == 512 and S == 2 * M.GROUP


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_takes_the_lowest_experts_and_drops_past_capacity(arch):
    """Every router logit 0: all probs tie, the reference picks experts
    0..k-1 for every token, and each takes only the first C tokens."""
    jcfg, jp, cfg, p = _moe_pair(arch)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    B, S = 2, 16
    x = np.random.default_rng(4).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    got = _moe_both(jcfg, jp, cfg, p, x)
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    C = M._capacity(cfg, S)
    assert C < S  # the capacity drops tokens past the first C of each group
    # by hand: token t < C goes to experts 0..K-1, each with gate 1/K
    xt = torch.tensor(x)
    want = torch.zeros_like(xt)
    act = torch.nn.functional.silu if cfg.act == "silu" else \
        (lambda v: torch.nn.functional.gelu(v, approximate="tanh"))
    for e in range(K):
        h = act(xt[:, :C] @ p["w_gate"][e]) * (xt[:, :C] @ p["w_up"][e])
        want[:, :C] += (h @ p["w_down"][e]) / K
    np.testing.assert_allclose(got, want.numpy(), atol=MOE_ATOL)
    assert E > K and np.all(got[:, C:] == 0)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.5, 0.25, 0.0, 0.25]])
    vals, idx = M._top_k(probs, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_specs_match_reference(arch):
    tp.check_config_and_specs(arch)


@pytest.fixture(scope="module")
def arch_setup():
    cache = {}

    def get(arch, flash=False):
        if arch not in cache:
            cache[arch] = tp.setup(arch)
        jcfg, jmodel, jparams, cfg, params = cache[arch]
        return (jcfg.replace(use_flash_kernel=flash), jmodel, jparams,
                cfg.replace(use_flash_kernel=flash), params)

    return get


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_dense_decode_match_reference(arch_setup, arch, flash):
    tp.check_prefill_and_decode(arch_setup(arch, flash), tp.tokens(0, (2, 16)), 24)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_reference(arch_setup, arch, flash):
    tp.check_paged_decode(arch_setup(arch, flash))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_nll_and_its_gradient_match_reference(arch_setup, arch):
    jcfg, jmodel, jparams, cfg, params = arch_setup(arch)
    tp.check_train_nll((jcfg, jmodel, jparams, cfg, params))
    b = tp.nll_batch()

    def jloss(p):
        s, c = jmodel.train_nll(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()})
        return s / c

    jgrads = jax.tree.leaves(jax.grad(jloss)(jparams))
    leaves = [a.clone().requires_grad_(True) for a in tree_leaves(params)]
    s, c = get_model(cfg).train_nll(cfg, tree_unflatten(params, leaves),
                                    {k: torch.tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(s / c, leaves)
    assert len(grads) == len(jgrads)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert torch.isfinite(g).all(), i
        tp.assert_close(g, jg, what=f"grad leaf {i}")
    # the router gets a gradient (through the gate values), as in the reference
    router = tree_unflatten(params, grads)["layers"]["0"]["mlp"]["router"]
    assert float(router.abs().max()) > 0


@pytest.fixture(scope="module")
def engines():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = tp.member_setup(arch, 2, use_flash_kernel=True)
        return cache[arch]

    return get


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(engines, arch, paged):
    tp.check_engine(engines(arch), paged=paged, max_seq=16, prompt_lens=(5, 8))
