"""Recurrent temporal-mixing blocks: the RG-LRU (RecurrentGemma/Griffin)
block.

Prefill runs the recurrence through the hand-written scan kernel
(``kernels.ops.rglru_scan``) once, and the block returns its final state
with its output, where the reference runs an associative scan twice (once
for the output, once more for the state).  Decode is the one-step
recurrence h = a·h + x in plain torch, O(1) per token.  The state lives in
the caller's cache and decode writes it IN PLACE.

The xLSTM blocks (mLSTM, sLSTM) of the reference's ``recurrent.py`` are not
ported; their layer kinds raise in ``transformer``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamSpec

_RGLRU_C = 8.0


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def rglru_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    R = cfg.rnn_width or cfg.d_model
    W = cfg.rglru_conv_width
    pd = cfg.param_dtype
    return {
        "w_x": ParamSpec((D, R), ("embed", "rnn"), dtype=pd),  # recurrent branch in
        "w_gate_branch": ParamSpec((D, R), ("embed", "rnn"), dtype=pd),
        "conv_w": ParamSpec((W, R), (None, "rnn"), scale=0.1, dtype=pd),
        "conv_b": ParamSpec((R,), ("rnn",), init="zeros", dtype=pd),
        "w_a": ParamSpec((R, R), ("rnn", None), dtype=pd),  # recurrence gate
        "b_a": ParamSpec((R,), ("rnn",), init="zeros", dtype=pd),
        "w_i": ParamSpec((R, R), ("rnn", None), dtype=pd),  # input gate
        "b_i": ParamSpec((R,), ("rnn",), init="zeros", dtype=pd),
        "lam": ParamSpec((R,), ("rnn",), init="lru_lambda", dtype=torch.float32),
        "w_out": ParamSpec((R, D), ("rnn", "embed"), dtype=pd),
    }


def _rglru_gates(p, u):
    """u: (..., R) conv output.  Returns (a, gated input) in f32."""
    r_gate = torch.sigmoid(u @ p["w_a"].to(u.dtype) + p["b_a"].to(u.dtype))
    i_gate = torch.sigmoid(u @ p["w_i"].to(u.dtype) + p["b_i"].to(u.dtype))
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r_gate.float()
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    x_in = scale * (i_gate.float() * u.float())
    return a, x_in


def rglru_block(cfg: ModelConfig, p, x):
    """Training/prefill: x (B, S, D) -> (out (B, S, D), final state).  The
    state is {"h": (B, R) f32, "conv": (B, W-1, R)}: the last step of the
    recurrence and the last W-1 raw conv inputs, in x's dtype."""
    from repro_torch.kernels.ops import rglru_scan

    cd = cfg.compute_dtype
    S = x.shape[1]
    gate = _gelu(x.to(cd) @ p["w_gate_branch"].to(cd))
    u = x.to(cd) @ p["w_x"].to(cd)  # (B, S, R)
    W = p["conv_w"].shape[0]  # causal depthwise conv, width W
    pad = F.pad(u, (0, 0, W - 1, 0))
    uc = sum(pad[:, i:i + S] * p["conv_w"][i].to(cd) for i in range(W)) + p["conv_b"].to(cd)
    a, x_in = _rglru_gates(p, uc)  # f32 (B, S, R)
    h = rglru_scan(a, x_in)
    out = (gate * h.to(cd)) @ p["w_out"].to(cd)
    return out, {"h": h[:, -1], "conv": pad[:, S:S + W - 1].to(x.dtype)}


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device, lead: tuple = ()):
    """Zero state for one RG-LRU layer, with leading dims ``lead`` (the
    stacked-layer axis)."""
    R = cfg.rnn_width or cfg.d_model
    W = cfg.rglru_conv_width
    return {
        "h": torch.zeros(lead + (batch, R), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, W - 1, R), dtype=dtype, device=device),
    }


def rglru_decode(cfg: ModelConfig, p, x, state):
    """x: (B, 1, D); one recurrent step.  Writes the new h and conv history
    into ``state`` IN PLACE.  Returns (out (B, 1, D), state)."""
    cd = cfg.compute_dtype
    xt = x[:, 0].to(cd)
    gate = _gelu(xt @ p["w_gate_branch"].to(cd))
    u = xt @ p["w_x"].to(cd)  # (B, R)
    hist = torch.cat([state["conv"].to(cd), u[:, None]], dim=1)  # (B, W, R)
    u = torch.einsum("bwr,wr->br", hist, p["conv_w"].to(cd)) + p["conv_b"].to(cd)
    a, x_in = _rglru_gates(p, u)
    h = a * state["h"] + x_in  # f32
    out = (gate * h.to(cd)) @ p["w_out"].to(cd)
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return out[:, None], state
