"""The port's qwen3-0.6b model against the reference's, on the CPU.

The SMOKE configuration, with ``use_flash_kernel`` off and on, on params
drawn by ``repro.models.init_params`` and carried across with
``_interop``: prefill logits and the dense cache, dense ``decode_step``
logits and ``paged_decode_step`` logits must match the reference (atol
2e-5, the reference suite's model-level tolerance).  Within the port, the
paged path must match the dense path, and a batched decode with one
position per row must match separate batch-1 decodes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.models.common import num_params as jnum_params
from repro_torch import _interop, configs
from repro_torch.models import get_model, init_params, num_params, tree_leaves, tree_map

ATOL = 2e-5
MAX_SEQ = 24


@pytest.fixture(scope="module")
def shared():
    jcfg = jconfigs.get_config("qwen3-0.6b", smoke=True)
    jmodel = jget_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(jcfg), jax.random.PRNGKey(1))
    params = _interop.tree_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, _interop.config_from(jcfg), params


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_and_dense_decode_match_reference(shared, flash):
    jcfg, jmodel, jparams, cfg, params = shared
    jcfg, cfg = jcfg.replace(use_flash_kernel=flash), cfg.replace(use_flash_kernel=flash)
    model = get_model(cfg)
    prompt = _tokens(0, (2, 16))
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)}, MAX_SEQ)
    tl, cache = model.prefill(cfg, params, {"tokens": torch.tensor(prompt)}, MAX_SEQ)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
    for i in range(3):
        nt = _tokens(10 + i, (2, 1))
        jl, jcache = jmodel.decode_step(jcfg, jparams, jcache, jnp.asarray(nt))
        tl, cache = model.decode_step(cfg, params, cache, torch.tensor(nt))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_paged_decode_matches_reference(shared, flash):
    jcfg, jmodel, jparams, cfg, params = shared
    jcfg, cfg = jcfg.replace(use_flash_kernel=flash), cfg.replace(use_flash_kernel=flash)
    model = get_model(cfg)
    bs, prompt = 8, _tokens(1, (1, 11))
    tab = np.asarray([[2, 4, 1]], np.int32)
    _, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)}, MAX_SEQ)
    _, cache = model.prefill(cfg, params, {"tokens": torch.tensor(prompt)}, MAX_SEQ)
    jpools = jmodel.paged.make_pools(jcfg, 6, bs, jcfg.compute_dtype)
    jpools = jmodel.paged.prefill_write(jcfg, jpools, jcache, jnp.asarray(tab[0]), bs)
    pools = model.paged.make_pools(cfg, 6, bs, cfg.compute_dtype, "cpu")
    pools = model.paged.prefill_write(cfg, pools, cache, torch.tensor(tab[0]), bs)
    for a, b in zip(tree_leaves(pools), jax.tree.leaves(jpools)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
    for step in range(3):
        ctx = np.asarray([11 + step], np.int32)
        wb = tab[:, (11 + step) // bs]
        nt = _tokens(20 + step, (1, 1))
        jl, jpools = jmodel.paged.decode_step(jcfg, jparams, jpools, jnp.asarray(nt),
                                              jnp.asarray(tab), jnp.asarray(ctx), jnp.asarray(wb))
        tl, pools = model.paged.decode_step(cfg, params, pools, torch.tensor(nt),
                                            torch.tensor(tab), torch.tensor(ctx), torch.tensor(wb))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_paged_matches_dense_within_port(shared, flash):
    *_, cfg, params = shared
    cfg = cfg.replace(use_flash_kernel=flash)
    model = get_model(cfg)
    bs, prompts = 4, [_tokens(2, (1, 7)), _tokens(3, (1, 13))]
    tables = np.asarray([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 9, 0]], np.int32)
    pools = model.paged.make_pools(cfg, 10, bs, cfg.compute_dtype, "cpu")
    dense = []
    for s, prompt in enumerate(prompts):
        _, cache = model.prefill(cfg, params, {"tokens": torch.tensor(prompt)}, MAX_SEQ)
        model.paged.prefill_write(cfg, pools, cache, torch.tensor(tables[s]), bs)
        dense.append(cache)
    ctx = np.asarray([7, 13], np.int32)
    for step in range(4):
        toks = _tokens(30 + step, (2, 1))
        wb = tables[np.arange(2), ctx // bs]
        pl, pools = model.paged.decode_step(cfg, params, pools, torch.tensor(toks),
                                            torch.tensor(tables), torch.tensor(ctx),
                                            torch.tensor(wb))
        for s in range(2):
            dl, dense[s] = model.decode_step(cfg, params, dense[s], torch.tensor(toks[s:s + 1]))
            np.testing.assert_allclose(_np(pl[s]), _np(dl[0]), atol=1e-5)
        ctx = ctx + 1


def test_per_row_positions_match_batch1_decodes(shared):
    """The engine decodes slots at different positions in one call: a
    (B,) ``t`` must equal B separate batch-1 decodes."""
    *_, cfg, params = shared
    model = get_model(cfg)
    caches = [model.prefill(cfg, params, {"tokens": torch.tensor(_tokens(40 + i, (1, n)))},
                            MAX_SEQ)[1] for i, n in enumerate((5, 9, 3))]
    kv = [{k: v for k, v in c.items() if k != "t"} for c in caches]
    batched = tree_map(lambda *xs: torch.cat(xs, dim=1), *kv)  # the batch axis follows n_periods
    batched["t"] = torch.stack([c["t"] for c in caches])
    toks = _tokens(50, (3, 1))
    bl, batched = model.decode_step(cfg, params, batched, torch.tensor(toks))
    for i, c in enumerate(caches):
        l1, _ = model.decode_step(cfg, params, c, torch.tensor(toks[i:i + 1]))
        np.testing.assert_allclose(_np(bl[i]), _np(l1[0]), atol=1e-5)
    np.testing.assert_array_equal(batched["t"].numpy(), [6, 10, 4])


def test_param_specs_and_counts_match_reference():
    for smoke in (True, False):
        jcfg = jconfigs.get_config("qwen3-0.6b", smoke=smoke)
        cfg = configs.get_config("qwen3-0.6b", smoke=smoke)
        assert cfg == _interop.config_from(jcfg)
        assert num_params(cfg) == jnum_params(jcfg)
        jspecs = jax.tree.leaves(jget_model(jcfg).param_specs(jcfg),
                                 is_leaf=lambda x: hasattr(x, "axes"))
        specs = tree_leaves(get_model(cfg).param_specs(cfg))
        assert [(s.shape, s.axes, s.init) for s in specs] == \
               [(s.shape, s.axes, s.init) for s in jspecs]


def test_init_params_seeded_on_requested_device(shared):
    *_, cfg, _ = shared
    specs = get_model(cfg).param_specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.device.type == "cpu" and x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert float(a["layers"]["0"]["ln1"].min()) == 1.0  # "ones" init


def test_unported_families_and_arches_raise():
    """Every arch of the reference is ported: each config loads;
    an unknown arch raises KeyError, and the audio family gets the
    encoder-decoder, with no paged surface, as in the reference."""
    assert configs.PORTED == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        assert configs.get_config(arch).name == arch
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    jaudio = jconfigs.get_config("whisper-base", smoke=True)
    audio = _interop.config_from(jaudio)
    assert audio.family == "audio"
    assert get_model(audio).paged is None and jget_model(jaudio).paged is None
    assert get_model(audio).prefill.__module__ == "repro_torch.models.encdec"
