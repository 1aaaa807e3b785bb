"""The port's analytic roofline (``repro_torch.roofline``) against the
reference's (``repro.roofline.analytic``), and the shape grid and parameter
counts it reads (``repro_torch.configs``, ``models.active_params``).

The counts are the reference's, exactly, for every (arch, cell, pod) layout
of ``all_cells()``: the FLOPs, the HBM bytes (with and without the flash
kernel and the fused sampler) and the collective bytes, key by key; the
decode cache's bytes come from the port's own ``make_cache`` on the meta
device.  Only ``HW`` differs: the H100's peaks, so ``analyze_cell``'s seconds
are the same counts over the card's rates.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.models import active_params as jactive_params
from repro.roofline import analytic as janalytic
from repro_torch import configs, roofline
from repro_torch.models import active_params, num_params
from repro_torch.roofline import analytic

LAYOUTS = [(arch, cell.name, pod) for arch, cell in jconfigs.all_cells() for pod in (False, True)]


def test_shape_grid_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.LONG_OK == jconfigs.LONG_OK
    assert [(a, c.name) for a, c in configs.all_cells()] == \
        [(a, c.name) for a, c in jconfigs.all_cells()]
    assert len(LAYOUTS) == 70
    for arch in configs.ARCH_IDS:
        assert [c.name for c in configs.cells(arch)] == [c.name for c in jconfigs.cells(arch)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_active_params_match_reference(arch):
    for smoke in (False, True):
        cfg = configs.get_config(arch, smoke=smoke)
        n = active_params(cfg)
        assert n == jactive_params(jconfigs.get_config(arch, smoke=smoke))
        assert (n < num_params(cfg)) == (cfg.family == "moe")


def test_hw_is_the_h100():
    assert roofline.HW is analytic.HW
    assert analytic.HW == {"card": "H100 80GB HBM3, 700 W", "peak_flops_bf16": 989e12,
                           "hbm_bw": 3.35e12, "nvlink_bw": 450e9, "peak_flops_f32": 67e12}


@pytest.mark.parametrize("arch,shape,pod", LAYOUTS,
                         ids=[f"{a}-{s}-{'2pod' if p else '1pod'}" for a, s, p in LAYOUTS])
def test_counts_match_reference(arch, shape, pod):
    assert analytic.flops_model(arch, shape) == janalytic.flops_model(arch, shape)
    for flash in (False, True):
        for fused in (False, True):
            got = analytic.hbm_model(arch, shape, pod, flash_attn=flash, fused_sampler=fused)
            assert got == janalytic.hbm_model(arch, shape, pod, flash_attn=flash,
                                              fused_sampler=fused), (flash, fused)
    assert analytic.collective_model(arch, shape, pod) == \
        janalytic.collective_model(arch, shape, pod)
    assert dataclasses.asdict(analytic._layout(arch, shape, pod)) == \
        dataclasses.asdict(janalytic._layout(arch, shape, pod))


@pytest.mark.parametrize("arch,shape,pod", [("recurrentgemma-2b", "train_4k", False),
                                            ("olmoe-1b-7b", "decode_32k", True),
                                            ("gemma3-27b", "long_500k", False)])
def test_analyze_cell_is_the_counts_over_the_card(arch, shape, pod):
    got = analytic.analyze_cell(arch, shape, pod, flash_attn=True, fused_sampler=True)
    want = janalytic.analyze_cell(arch, shape, pod, flash_attn=True, fused_sampler=True)
    hw = analytic.HW
    assert got["flops_per_dev"] == want["flops_per_dev"]
    assert got["hbm_breakdown"] == want["hbm_breakdown"]
    assert got["coll_breakdown"] == want["coll_breakdown"]
    assert got["model_flops_global"] == want["model_flops_global"]
    assert got["useful_ratio"] == want["useful_ratio"]
    assert got["compute_s"] == got["flops_per_dev"] / hw["peak_flops_bf16"]
    assert got["memory_s"] == got["hbm_breakdown"]["total"] / hw["hbm_bw"]
    assert got["collective_s"] == got["coll_breakdown"]["total"] / hw["nvlink_bw"]
    times = [got["compute_s"], got["memory_s"], got["collective_s"]]
    assert got["dominant"] == ["compute", "memory", "collective"][times.index(max(times))]
    assert got["roofline_frac"] == got["compute_s"] / max(times)


def test_overrides_take_the_ports_dtypes():
    """An override carries torch dtypes: bf16 params halve the weight and
    sampler bytes against the f32 config."""
    import torch

    f32 = analytic.hbm_model("qwen3-0.6b", "train_4k")
    bf16 = analytic.hbm_model("qwen3-0.6b", "train_4k",
                              overrides={"param_dtype": torch.bfloat16})
    assert configs.get_config("qwen3-0.6b").param_dtype == torch.float32
    assert bf16["weights"] == f32["weights"] / 2 and bf16["sampler"] == f32["sampler"] / 2
