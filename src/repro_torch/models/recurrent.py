"""Recurrent temporal-mixing blocks: RG-LRU (RecurrentGemma/Griffin) and
mLSTM / sLSTM (xLSTM).

RG-LRU prefill runs the recurrence through the hand-written scan kernel
(``kernels.ops.rglru_scan``) once, and the block returns its final state
with its output, where the reference runs an associative scan twice (once
for the output, once more for the state).  The mLSTM block uses the
stabilised quadratic parallel form on the full sequence; the sLSTM block
is a loop over time (its memory mixing is serial) and returns its final
state with its output.  Decode is O(1) per token in plain torch.  The
state lives in the caller's cache and decode writes it IN PLACE.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import spmd
from .common import ModelConfig, ParamSpec
from .layers import rms_norm

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


def _rglru_gates(p, u, u_own=None):
    """u: (..., R) conv output.  Returns (a, gated input) in f32.  With
    ``u_own`` (a rank's channels of u, whose weights' columns ``p``
    holds), the gates read every channel of u and gate ``u_own``."""
    r_gate = torch.sigmoid(u @ p["w_a"].to(u.dtype) + p["b_a"].to(u.dtype))
    i_gate = torch.sigmoid(u @ p["w_i"].to(u.dtype) + p["b_i"].to(u.dtype))
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r_gate.float()
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    x_in = scale * (i_gate.float() * (u if u_own is None else u_own).float())
    return a, x_in


def rglru_block(cfg: ModelConfig, p, x):
    """Training/prefill: x (B, S, D) -> (out (B, S, D), final state).  The
    state is {"h": (B, R) f32, "conv": (B, W-1, R)}: the last step of the
    recurrence and the last W-1 raw conv inputs, in x's dtype."""
    from repro_torch.kernels.ops import rglru_scan

    if spmd.is_dtensor(x):
        return _rglru_block_dt(cfg, p, x)
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


def _rglru_block_dt(cfg: ModelConfig, p, x):
    """``rglru_block`` on DTensors: each rank runs its rows and, where the
    weights split the channels R over ``model``, its channels; the gates
    read every channel of the conv output (one all-gather over ``model``),
    the scan runs on the rank's channels and the output projection leaves
    a partial sum over ``model``.  The state comes back split as the
    channels are."""
    from repro_torch.kernels.ops import rglru_scan

    mesh = x.device_mesh
    mi, m, r = spmd.model_axis(x)
    split = spmd.split_on(p["w_x"], 1)
    R = p["w_x"].shape[1]
    n = R // m if split else R
    lo = r * n if split else 0
    dims = spmd.sum_dims(x, split)
    own = {k: spmd.part(p[k], d, lo, n, dims) for k, d in (
        ("w_gate_branch", 1), ("w_x", 1), ("conv_w", 1), ("conv_b", 0), ("b_a", 0), ("b_i", 0),
        ("lam", 0), ("w_out", 0), ("w_a", 1), ("w_i", 1))}
    cd = cfg.compute_dtype
    x_l = spmd.local_rows(x, x, partial=dims)
    S = x_l.shape[1]
    gate = _gelu(x_l.to(cd) @ own["w_gate_branch"].to(cd))
    u = x_l.to(cd) @ own["w_x"].to(cd)
    W = own["conv_w"].shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    uc = sum(pad[:, i:i + S] * own["conv_w"][i].to(cd) for i in range(W)) + own["conv_b"].to(cd)
    rows = spmd.row_dims(x)
    chan = {**rows, mi: 2} if split else rows
    uc_all = spmd.to_layout(spmd.wrap(uc, mesh, chan), mesh, rows, dims) if split else uc
    a, x_in = _rglru_gates(own, uc_all, uc)
    h = rglru_scan(a, x_in)
    out = (gate * h.to(cd)) @ own["w_out"].to(cd)
    state = {"h": spmd.wrap(h[:, -1], mesh, {**rows, mi: 1} if split else rows),
             "conv": spmd.wrap(pad[:, S:S + W - 1].to(x.dtype), mesh, chan)}
    return spmd.out_rows(out, x, split), state


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
    into ``state`` IN PLACE.  Returns (out (B, 1, D), state).  On DTensors
    each rank steps its rows with the weights whole."""
    if spmd.is_dtensor(x):
        return spmd.rows_local(lambda p_, x_, s_: rglru_decode(cfg, p_, x_, s_)[0], x, p, x,
                               states=(state,)), state
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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block, parallel stabilised form)
#
# The block operates in the up-projected space: up = 2*d_model split into
# cfg.num_heads heads of dh = up // num_heads each.
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ModelConfig):
    up = 2 * cfg.d_model
    NH = cfg.num_heads
    return up, NH, up // NH


def mlstm_specs(cfg: ModelConfig) -> dict:
    D, pd = cfg.d_model, cfg.param_dtype
    up, NH, dh = _mlstm_dims(cfg)
    return {
        "w_up1": ParamSpec((D, up), ("embed", "mlp"), dtype=pd),  # mixer path
        "w_up2": ParamSpec((D, up), ("embed", "mlp"), dtype=pd),  # gate path
        "conv_w": ParamSpec((4, up), (None, "mlp"), scale=0.1, dtype=pd),
        "conv_b": ParamSpec((up,), ("mlp",), init="zeros", dtype=pd),
        "wq": ParamSpec((up, NH, dh), ("mlp", "heads", None), dtype=pd),
        "wk": ParamSpec((up, NH, dh), ("mlp", "heads", None), dtype=pd),
        "wv": ParamSpec((up, NH, dh), ("mlp", "heads", None), dtype=pd),
        "w_igate": ParamSpec((up, NH), ("mlp", "heads"), scale=0.01, dtype=pd),
        "b_igate": ParamSpec((NH,), ("heads",), init="zeros", dtype=pd),
        "w_fgate": ParamSpec((up, NH), ("mlp", "heads"), scale=0.01, dtype=pd),
        "b_fgate": ParamSpec((NH,), ("heads",), init="ones", dtype=pd),
        "w_down": ParamSpec((up, D), ("mlp", "embed"), dtype=pd),
    }


def _mlstm_inputs(cfg: ModelConfig, p, x):
    """The parallel form's per-token tensors of x (B, S, D): the raw conv
    input u1 (B, S, up), the gate path u2, q, k, v (B, S, NH, dh) in the
    compute dtype and the gate pre-activations ig, fg (B, S, NH) in f32."""
    cd = cfg.compute_dtype
    S = x.shape[1]
    u1 = x.to(cd) @ p["w_up1"].to(cd)  # (B, S, up) mixer path
    u2 = F.silu(x.to(cd) @ p["w_up2"].to(cd))  # gate path
    W = p["conv_w"].shape[0]
    pad = F.pad(u1, (0, 0, W - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i].to(cd) for i in range(W))
    conv = F.silu(conv + p["conv_b"].to(cd))
    q = torch.einsum("bsu,uhk->bshk", conv, p["wq"].to(cd))
    k = torch.einsum("bsu,uhk->bshk", conv, p["wk"].to(cd))
    v = torch.einsum("bsu,uhk->bshk", u1, p["wv"].to(cd))
    ig = torch.einsum("bsu,uh->bsh", conv.float(), p["w_igate"].float()) + p["b_igate"]
    fg = torch.einsum("bsu,uh->bsh", conv.float(), p["w_fgate"].float()) + p["b_fgate"]
    return u1, u2, q, k, v, ig, fg


def _mlstm_step(state, k_s, v, ig, logf):
    """One token of the matrix-memory recurrence: the new {C, n, m} (new
    tensors) from ``state``; k_s (B, NH, dh) is k / sqrt(dh), v (B, NH,
    dh), ig and logf (B, NH), all f32."""
    m_new = torch.maximum(logf + state["m"], ig)  # (B, NH)
    f_p = torch.exp(logf + state["m"] - m_new)
    i_p = torch.exp(ig - m_new)
    C = f_p[..., None, None] * state["C"] + i_p[..., None, None] * (
        v[..., :, None] * k_s[..., None, :]
    )
    n = f_p[..., None] * state["n"] + i_p[..., None] * k_s
    return {"C": C, "n": n, "m": m_new}


def mlstm_block(cfg: ModelConfig, p, x, state=None):
    """Parallel stabilised mLSTM on x (B, S, D) -> (B, S, D): the O(S^2)
    form (decode is O(1)).  With ``state`` (an empty mLSTM state, as
    ``mlstm_init_state`` makes it), the prompt's final state is also
    written into it in place: the recurrence of ``mlstm_decode`` run token
    by token over the prompt (as the reference extracts it, not a closed
    form), fed from this block's per-token projections, computed once.  On
    DTensors each rank runs its rows with the weights whole."""
    if spmd.is_dtensor(x):
        if state is None:
            return spmd.rows_local(lambda p_, x_: mlstm_block(cfg, p_, x_), x, p, x)
        return spmd.rows_local(lambda p_, x_, s_: mlstm_block(cfg, p_, x_, s_), x, p, x,
                               states=(state,))
    cd = cfg.compute_dtype
    B, S, D = x.shape
    up, NH, dh = _mlstm_dims(cfg)
    u1, u2, q, k, v, igate, fgate = _mlstm_inputs(cfg, p, x)

    logf = F.logsigmoid(fgate)  # (B, S, NH)
    Fc = torch.cumsum(logf, dim=1)
    # D_ts = F_t - F_s + i_s for s <= t
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + igate[:, None, :, :]  # (B, t, s, NH)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    dmat = torch.where(causal[None, :, :, None], dmat, -math.inf)
    m = torch.amax(dmat, dim=2, keepdim=True)  # (B, t, 1, NH) stabiliser
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bthk,bshk->btsh", q.float(), k.float())
    scores = scores / math.sqrt(dh) * dexp
    norm = torch.maximum(torch.abs(torch.sum(scores, dim=2)), torch.exp(-m[:, :, 0]))  # (B, t, NH)
    h = torch.einsum("btsh,bshk->bthk", scores, v.float()) / norm[..., None]
    h = h.reshape(B, S, up).to(cd)
    if state is not None:
        k_s, vf = k.float() / math.sqrt(dh), v.float()
        st = {key: state[key] for key in ("C", "n", "m")}
        for t in range(S):
            st = _mlstm_step(st, k_s[:, t], vf[:, t], igate[:, t], logf[:, t])
        for key, val in st.items():
            state[key].copy_(val)
        W = state["conv"].shape[1] + 1
        state["conv"].copy_(F.pad(u1, (0, 0, W - 1, 0))[:, S:S + W - 1])  # last W-1 raw inputs
    return (h * u2) @ p["w_down"].to(cd)


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype, device, lead: tuple = ()):
    """Empty state for one mLSTM layer, with leading dims ``lead``: C (B,
    NH, dh, dh), n (B, NH, dh) and m (B, NH) in f32 (m at -1e30), and the
    last 3 raw conv inputs (B, 3, up) in ``dtype``."""
    up, NH, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros(lead + (batch, NH, dh, dh), dtype=f32, device=device),
        "n": torch.zeros(lead + (batch, NH, dh), dtype=f32, device=device),
        "m": torch.full(lead + (batch, NH), -1e30, dtype=f32, device=device),
        "conv": torch.zeros(lead + (batch, 3, up), dtype=dtype, device=device),
    }


def mlstm_decode(cfg: ModelConfig, p, x, state):
    """x: (B, 1, D); one recurrent step.  Writes the new C, n, m and conv
    history into ``state`` IN PLACE.  Returns (out (B, 1, D), state)."""
    if spmd.is_dtensor(x):
        return spmd.rows_local(lambda p_, x_, s_: mlstm_decode(cfg, p_, x_, s_)[0], x, p, x,
                               states=(state,)), state
    cd = cfg.compute_dtype
    B = x.shape[0]
    up, NH, dh = _mlstm_dims(cfg)
    xt = x[:, 0].to(cd)
    u1 = xt @ p["w_up1"].to(cd)
    u2 = F.silu(xt @ p["w_up2"].to(cd))
    hist = torch.cat([state["conv"].to(cd), u1[:, None]], dim=1)  # (B, 4, up)
    conv = F.silu(torch.einsum("bwu,wu->bu", hist, p["conv_w"].to(cd)) + p["conv_b"].to(cd))
    q = torch.einsum("bu,uhk->bhk", conv, p["wq"].to(cd)).float()
    k = torch.einsum("bu,uhk->bhk", conv, p["wk"].to(cd)).float()
    v = torch.einsum("bu,uhk->bhk", u1, p["wv"].to(cd)).float()
    ig = torch.einsum("bu,uh->bh", conv.float(), p["w_igate"].float()) + p["b_igate"]
    fg = torch.einsum("bu,uh->bh", conv.float(), p["w_fgate"].float()) + p["b_fgate"]
    new = _mlstm_step(state, k / math.sqrt(dh), v, ig, F.logsigmoid(fg))
    num = torch.einsum("bhij,bhj->bhi", new["C"], q)
    den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", new["n"], q)),
                        torch.exp(-new["m"]))
    h = (num / den[..., None]).reshape(B, up).to(cd)
    out = (h * u2) @ p["w_down"].to(cd)
    for key, val in new.items():
        state[key].copy_(val)
    state["conv"].copy_(hist[:, 1:])
    return out[:, None], state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, head-wise memory mixing)
#
# Heads operate on d_model (NH * head_dim == d_model); the block appends a
# gated FFN (pf = 4/3) as in the official xLSTM block.
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ModelConfig) -> dict:
    D, NH, dh, pd = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.param_dtype
    if NH * dh != D:
        raise ValueError("sLSTM requires num_heads * head_dim == d_model")
    ff = int(D * 4 / 3)
    return {
        "w_in": ParamSpec((4, D, NH, dh), (None, "embed", "heads", None), dtype=pd),
        "r": ParamSpec((4, NH, dh, dh), (None, "heads", None, None), scale=0.01, dtype=pd),
        "b": ParamSpec((4, NH, dh), (None, "heads", None), init="zeros", dtype=pd),
        "w_group_norm": ParamSpec((D,), ("embed",), init="ones", dtype=pd),
        "ff_gate": ParamSpec((D, ff), ("embed", "mlp"), dtype=pd),
        "ff_up": ParamSpec((D, ff), ("embed", "mlp"), dtype=pd),
        "ff_down": ParamSpec((ff, D), ("mlp", "embed"), dtype=pd),
    }


def _slstm_cell(p, xt, state):
    """xt: (B, D) f32; state: dict(h, c, n, m) each (B, NH, dh).  Returns
    the new state (new tensors)."""
    h_prev, c_prev, n_prev, m_prev = state["h"], state["c"], state["n"], state["m"]
    wx = torch.einsum("bd,gdhk->gbhk", xt, p["w_in"].float())
    rh = torch.einsum("bhk,ghkl->gbhl", h_prev, p["r"].float())
    z, i, f, o = [wx[g] + rh[g] + p["b"][g].float() for g in range(4)]
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = F.logsigmoid(f)
    m = torch.maximum(logf + m_prev, i)
    i_p = torch.exp(i - m)
    f_p = torch.exp(logf + m_prev - m)
    c = f_p * c_prev + i_p * z
    n = f_p * n_prev + i_p
    h = o * c / torch.clamp_min(n, 1e-6)
    return {"h": h, "c": c, "n": n, "m": m}


def _slstm_out(cfg: ModelConfig, p, hs):
    """Group norm (an RMS norm over D) + gated FFN on the mixed output."""
    cd = cfg.compute_dtype
    hs = rms_norm(hs.to(cd), p["w_group_norm"], cfg.norm_eps)
    f = _gelu(hs @ p["ff_gate"].to(cd)) * (hs @ p["ff_up"].to(cd))
    return f @ p["ff_down"].to(cd)


def slstm_block(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (out (B, S, D), final state): a loop over time (the
    memory mixing is serial) from the empty state."""
    if spmd.is_dtensor(x):
        return spmd.rows_local(lambda p_, x_: slstm_block(cfg, p_, x_), x, p, x)
    B, S, D = x.shape
    state = slstm_init_state(cfg, B, x.dtype, x.device)
    xs = x.float()
    hs = []
    for t in range(S):
        state = _slstm_cell(p, xs[:, t], state)
        hs.append(state["h"])
    hs = torch.stack(hs, dim=1).reshape(B, S, D)
    return _slstm_out(cfg, p, hs), state


def slstm_init_state(cfg: ModelConfig, batch: int, dtype, device, lead: tuple = ()):
    """Empty state for one sLSTM layer: h, c, n (B, NH, dh) zeros and m at
    -1e30, all f32 (``dtype`` is unused: the state is f32)."""
    del dtype
    shape = lead + (batch, cfg.num_heads, cfg.head_dim)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full(shape, -1e30, dtype=torch.float32, device=device)}


def slstm_decode(cfg: ModelConfig, p, x, state):
    """x: (B, 1, D); one recurrent step, written into ``state`` IN PLACE.
    Returns (out (B, 1, D), state)."""
    if spmd.is_dtensor(x):
        return spmd.rows_local(lambda p_, x_, s_: slstm_decode(cfg, p_, x_, s_)[0], x, p, x,
                               states=(state,)), state
    B = x.shape[0]
    new = _slstm_cell(p, x[:, 0].float(), state)
    for key, val in new.items():
        state[key].copy_(val)
    return _slstm_out(cfg, p, new["h"].reshape(B, 1, cfg.d_model)), state
