"""Mixture-of-Experts layer (grok-1: 8 experts top-2, olmoe: 64 top-8).

The reference's dense-dispatch formulation (einsum + capacity) in plain
torch: tokens are grouped (group size g), each token's top-k experts take
capacity slots in token-major order, and a token that finds an expert full
is dropped by that expert (the residual passes it through).  The router
softmax, the top-k and the gate normalisation run in f32; the einsums in
``cfg.compute_dtype``.  No hand kernel: the reference computes the layer
outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from . import spmd
from .common import ModelConfig, ParamSpec
from .layers import _ACTS

GROUP = 512  # tokens per dispatch group


def moe_specs(cfg: ModelConfig) -> dict:
    D, F, E, pd = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts, cfg.param_dtype
    return {
        "router": ParamSpec((D, E), ("embed", None), dtype=pd),
        "w_gate": ParamSpec((E, D, F), ("expert", "embed", "mlp"), dtype=pd),
        "w_up": ParamSpec((E, D, F), ("expert", "embed", "mlp"), dtype=pd),
        "w_down": ParamSpec((E, F, D), ("expert", "mlp", "embed"), dtype=pd),
    }


def _capacity(cfg: ModelConfig, g: int) -> int:
    cap = int(g * cfg.moe_top_k * cfg.capacity_factor / cfg.moe_num_experts)
    return max(cap, cfg.moe_top_k)


def _top_k(probs, k: int):
    """The k largest along the last axis, ties to the lower index (as
    ``jax.lax.top_k``; ``torch.topk`` orders equal values arbitrarily)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (B, S, D).  B*S must be a multiple of the group.
    On DTensors each rank routes its rows through every expert."""
    if spmd.is_dtensor(x):
        return spmd.rows_local(lambda p_, x_: moe_ffn(cfg, p_, x_), x, p, x)
    cd = cfg.compute_dtype
    B, S, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    g = min(GROUP, S)
    n_groups = (B * S) // g
    xg = x.reshape(n_groups, g, D)
    C = _capacity(cfg, g)

    logits = xg.to(cd) @ p["router"].to(cd)  # (n, g, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, idx = _top_k(probs, K)  # (n, g, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # the slot bookkeeping in integers: the reference's f32 counts, exactly
    onehot = torch.nn.functional.one_hot(idx, E)  # (n, g, K, E)
    flat = onehot.reshape(n_groups, g * K, E)  # token-major priority
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n_groups, g, K, E)  # slot per entry
    keep = ((pos < C) * onehot).float()
    # a dropped entry's slot is >= C: its one-hot row is zeros, as jax.nn.one_hot gives
    slot = torch.sum(pos * onehot, dim=-1)  # (n, g, K)
    slot_oh = (slot[..., None] == torch.arange(C, device=x.device)).float()  # (n, g, K, C)
    dispatch = torch.einsum("ngke,ngkc->ngec", keep, slot_oh)
    combine = torch.einsum("ngke,ngkc,ngk->ngec", keep, slot_oh, gate_vals)

    xe = torch.einsum("ngec,ngd->necd", dispatch.to(cd), xg.to(cd))  # (n, E, C, D)
    act = _ACTS[cfg.act]
    h = act(torch.einsum("necd,edf->necf", xe, p["w_gate"].to(cd)))
    h = h * torch.einsum("necd,edf->necf", xe, p["w_up"].to(cd))
    ye = torch.einsum("necf,efd->necd", h, p["w_down"].to(cd))  # (n, E, C, D)
    y = torch.einsum("ngec,necd->ngd", combine.to(cd), ye)
    return y.reshape(B, S, D)
