"""The port's three windowed dense configurations (h2o-danube-1.8b,
gemma2-27b, gemma3-27b) against the reference's, on the CPU.

At the SMOKE size, on params carried across from the reference's init:
the configs and spec trees (full and SMOKE: bf16 dtypes, gemma3's two
remainder layers), prefill logits and every dense cache leaf, then three
``decode_step``s, with ``use_flash_kernel`` off and on (head_dim 8 and 16
pad to 64 in the flash wrapper), for a prompt shorter than the SMOKE window
of 8 and one longer (the ring buffer wraps); ``train_nll``; the dense
``ServeEngine`` against the reference's engine; and the paged engine
refused with the reference's message (every one of them has windowed
layers).  Tolerance 2e-5, tokens identical.
"""
from __future__ import annotations

import pytest
import torch

import torch_parity as tp
from repro.models import get_model as jget_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.serve.engine import ServeEngine

ARCHS = ("h2o-danube-1.8b", "gemma2-27b", "gemma3-27b")
MAX_SEQ = 24


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


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_specs_match_reference(arch):
    tp.check_config_and_specs(arch)


def test_full_configs_carry_the_published_layout():
    h2o, g2, g3 = (configs.get_config(a) for a in ARCHS)
    assert (h2o.head_dim, h2o.pattern[0].window, h2o.param_dtype) == (80, 4096, torch.float32)
    assert g2.param_dtype == g3.param_dtype == torch.bfloat16
    assert [k.window for k in g2.pattern] == [4096, None]
    assert (g2.attn_logit_softcap, g2.final_logit_softcap, g2.sandwich_norm) == (50.0, 30.0, True)
    assert [k.window for k in g3.pattern] == [1024] * 5 + [None]
    spec = get_model(g3).param_specs(g3)
    assert sorted(spec["rem"]) == ["0", "1"]  # 62 = 10 periods of 6 + 2 local layers
    assert all(spec["layers"][str(i)]["ln1"].shape == (10, 5376) for i in range(6))


@pytest.mark.parametrize("plen", [6, 12])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_dense_decode_match_reference(arch_setup, arch, flash, plen):
    s = arch_setup(arch, flash)
    tp.check_prefill_and_decode(s, tp.tokens(0, (2, plen)), MAX_SEQ)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_nll_matches_reference(arch_setup, arch):
    tp.check_train_nll(arch_setup(arch))


@pytest.fixture(scope="module")
def engines():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = tp.member_setup(arch, 2, use_flash_kernel=True)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_matches_reference_engine(engines, arch):
    tp.check_engine(engines(arch), paged=False, max_seq=MAX_SEQ)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_is_refused_like_the_reference(engines, arch):
    jcfg, jmodel, jmembers, cfg, model, members = engines(arch)
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jcfg, jget_model(jcfg), jmembers, num_slots=2, max_seq=MAX_SEQ, paged=True)
    with pytest.raises(ValueError) as err:
        ServeEngine(cfg, model, members, num_slots=2, max_seq=MAX_SEQ, paged=True, device="cpu")
    assert str(err.value) == str(jerr.value) == \
        "paged decode does not support sliding-window layers"
