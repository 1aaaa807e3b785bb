"""Analytic roofline model (per-cell FLOPs, HBM bytes and collective bytes)
with the H100's figures.

The counts come from the architecture's configuration and the sharding
layout (the standard MFU accounting), not from a compiled program.  They
are the reference's counts (``repro/roofline/analytic.py``), function for
function, on its hand-coded layouts of the 256-device slice (512 across
two pods), as the reference keeps them beside its dry run: the port's
meshes (``launch.mesh.make_production_mesh`` / ``make_train_mesh``) and
its dry run (``launch.dryrun``, per-device figures traced on a fake world
of those ranks) do not feed them, so the counts stay comparable.  What
differs is ``HW``: the card's peaks in place of the TPU's, so
``analyze_cell``'s seconds are the H100's.

All *_model functions return GLOBAL per-step quantities; analyze_cell
divides by the mesh to per-device terms in seconds.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch import configs
from repro_torch.models import active_params, get_model, num_params, tree_leaves
from repro_torch.models.common import ModelConfig

# One NVIDIA H100 SXM (the card's name and power limit as nvidia-smi gives
# them): dense bf16 tensor-core peak, HBM3 rate, NVLink per direction, and
# the f32 rate outside the tensor cores (NVIDIA's data sheet; the rates
# assume the full 700 W).
HW = {"card": "H100 80GB HBM3, 700 W", "peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
      "nvlink_bw": 450e9, "peak_flops_f32": 67e12}

_REMAT_FWD = 1.0  # extra forward recompute under nothing_saveable remat


def _attn_ctx(seq: int, window) -> float:
    """Average attended context per query under causal (+ window) masking."""
    if window and window < seq:
        # first `window` tokens: ramp; rest attend `window`
        ramp = window * (window + 1) / 2
        return (ramp + (seq - window) * window) / seq
    return (seq + 1) / 2


def _layer_fwd_flops(cfg: ModelConfig, kind, B: int, S: int, ctx_seq: int) -> float:
    """Forward FLOPs for ONE layer over B*S tokens (ctx_seq: kv context for
    attention — equals S for train/prefill, cache length for decode)."""
    D, dh = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    T = B * S
    f = 0.0
    if kind.kind == "attn":
        f += 2 * T * D * dh * (Hq + 2 * Hkv)  # q, k, v projections
        f += 2 * T * Hq * dh * D  # output projection
        ctx = _attn_ctx(ctx_seq, kind.window) if S > 1 else min(ctx_seq, kind.window or ctx_seq)
        f += 4 * T * ctx * Hq * dh  # QK^T + AV
        if kind.moe:
            E, K, Fe = cfg.moe_num_experts, cfg.moe_top_k, cfg.moe_d_ff
            cf = cfg.capacity_factor
            f += 2 * T * D * E  # router
            f += 6 * T * K * cf * D * Fe  # expert FFN (gated, capacity-padded)
            g = min(512, S)  # dispatch/combine einsums (group size)
            C = max(int(g * K * cf / E), K)
            f += 2 * 2 * T * E * C * D / 1  # dispatch + combine per group token
        else:
            f += 2 * T * D * cfg.d_ff * (3 if cfg.mlp_gated else 2)
    elif kind.kind == "rglru":
        R = cfg.rnn_width or D
        f += 2 * T * D * R * 2  # two input branches
        f += 2 * T * cfg.rglru_conv_width * R  # depthwise conv
        f += 2 * T * R * R * 2  # a/i gates
        f += 9 * T * R  # scan combine
        f += 2 * T * R * D  # out proj
        f += 2 * T * D * cfg.d_ff * 3  # MLP sublayer
    elif kind.kind == "mlstm":
        up = 2 * D
        f += 2 * T * D * up * 2  # up projections
        f += 2 * T * 4 * up  # conv
        f += 2 * T * up * up * 3  # q, k, v
        if S > 1:  # parallel (quadratic) train form
            f += 2 * T * S * cfg.num_heads * (up // cfg.num_heads) * 2 + 2 * T * S * cfg.num_heads
        else:  # recurrent decode: C update + read
            dh_in = up // cfg.num_heads
            f += 6 * B * cfg.num_heads * dh_in * dh_in
        f += 2 * T * up * D  # down
    elif kind.kind == "slstm":
        NH = cfg.num_heads
        f += 2 * T * D * D * 4  # input gates
        f += 2 * T * NH * dh * dh * 4  # recurrent mixing
        ff = int(D * 4 / 3)
        f += 2 * T * D * ff * 3  # gated FFN
    return f


def _vocab_flops(cfg: ModelConfig, tokens: float) -> float:
    return 2 * tokens * cfg.d_model * cfg.vocab_size


def flops_model(arch: str, shape_name: str, overrides: dict | None = None,
                remat: str = "full") -> dict:
    """GLOBAL FLOPs per step, decomposed."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = configs.SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    kinds = cfg.layer_kinds
    if cell.kind == "decode":
        fwd = sum(_layer_fwd_flops(cfg, k, B, 1, S) for k in kinds)
        fwd += _vocab_flops(cfg, B)
        if cfg.family == "audio":  # cross-attention reads
            fwd += 4 * B * cfg.enc_seq * cfg.num_heads * cfg.head_dim * cfg.num_layers
        return {"total": fwd, "fwd": fwd, "factor": 1.0}
    fwd = sum(_layer_fwd_flops(cfg, k, B, S, S) for k in kinds)
    fwd += _vocab_flops(cfg, B * S)
    if cfg.family == "audio":
        enc_kind = configs.get_config(arch).pattern[0]
        fwd += cfg.enc_layers * _layer_fwd_flops(cfg, enc_kind, B, cfg.enc_seq, cfg.enc_seq)
        fwd += 4 * B * S * cfg.enc_seq * cfg.num_heads * cfg.head_dim * cfg.num_layers / S  # cross per dec token ~ enc_seq
    if cell.kind == "prefill":
        return {"total": fwd, "fwd": fwd, "factor": 1.0}
    factor = 3.0 + (_REMAT_FWD if remat == "full" else 0.0)  # bwd = 2x fwd
    return {"total": fwd * factor, "fwd": fwd, "factor": factor}


@dataclass
class Layout:
    """Sharding layout factors for the cell (from launch/specs rules)."""
    devices: int
    tp: int  # model-axis size weights are divided by (TP contractions)
    fsdp: int  # axis size params are additionally sharded+gathered over
    chains: int
    b_local: int  # per-device batch rows
    sync_every: int = 4
    style: str = "tp_fsdp"


def _layout(arch: str, shape_name: str, multi_pod: bool, num_chains=None,
            sync_every: int = 4, style: str = "tp_fsdp", tp_size=None) -> Layout:
    cell = configs.SHAPES[shape_name]
    pods = 2 if multi_pod else 1
    pure_dp = arch in {"whisper-base", "xlstm-350m"}
    if pure_dp:
        style = "dp"
    if cell.kind == "train":
        k_single = num_chains or configs.EC_CHAINS[arch]
        k = k_single * pods
        chips = 256 // k_single  # per-chain chips (per pod)
        if style == "dp":
            tp, fsdp, rows_div = 1, 1, chips
        elif style == "fsdp2d":
            tp, fsdp, rows_div = 1, chips, chips
        else:  # tp_fsdp (tp_size re-balances the ratio)
            tp = tp_size or 16
            fsdp, rows_div = chips // tp, chips // tp
        per_dev = max(cell.global_batch // (k * rows_div), 1)
        return Layout(256 * pods, tp, fsdp, k, per_dev, sync_every, style)
    fsdp_serve = arch in {"grok-1-314b", "gemma3-27b", "gemma2-27b", "qwen2-vl-7b"}
    if style == "dp":
        tp, fsdp = 1, 1
        data = 16 * pods
    elif style == "fsdp2d":
        tp, fsdp = 1, 256 * pods
        data = 16 * pods
    else:
        tp = tp_size or 16
        data = (256 // tp) * pods
        fsdp = data if fsdp_serve else 1
    return Layout(256 * pods, tp, fsdp, 1,
                  max(cell.global_batch // data, 1), sync_every, style)


def hbm_model(arch: str, shape_name: str, multi_pod: bool = False,
              overrides: dict | None = None, *, flash_attn: bool = False,
              num_chains=None, shard_style: str = "tp_fsdp",
              remat: str = "full", fused_sampler: bool = False,
              tp_size=None) -> dict:
    """PER-DEVICE HBM bytes per step (first-order traffic model)."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = configs.SHAPES[shape_name]
    lay = _layout(arch, shape_name, multi_pod, num_chains, style=shard_style, tp_size=tp_size)
    pbytes = cfg.param_dtype.itemsize
    abytes = cfg.compute_dtype.itemsize
    P_total = num_params(cfg) * pbytes  # one chain's params
    P_read = P_total / lay.tp  # bytes each device reads per full pass
    B, S = cell.global_batch, cell.seq_len
    D, L = cfg.d_model, cfg.num_layers

    out = {}
    if cell.kind == "decode":
        model = get_model(cfg)
        cache = model.make_cache(cfg, B, S, cfg.compute_dtype, device="meta")
        cache_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
        out["weights"] = P_read
        out["kv_cache"] = cache_bytes / lay.devices  # read once per token
        out["activations"] = lay.b_local * D * L * abytes * 4
        out["total"] = sum(out.values())
        return out

    tok_local = lay.b_local * S
    act = tok_local * D * L * abytes
    # weight reads per pass: fwd + bwd (+ remat re-forward)
    w_passes = (3.0 if remat == "full" else 2.0) if cell.kind == "train" else 1.0
    out["weights"] = P_read * w_passes
    # activations: block IO ~6 streams/layer fwd; remat re-writes fwd acts
    if cell.kind == "train":
        act_factor = 10.0 if remat == "full" else 8.0
    else:
        act_factor = 5.0
    out["activations"] = act * act_factor
    # attention scores materialized (the plain path); the flash kernel removes them
    if not flash_attn:
        score_bytes = 0.0
        for k in cfg.layer_kinds:
            if k.kind == "attn":
                ctx = _attn_ctx(S, k.window)
                score_bytes += lay.b_local * cfg.num_heads * S * ctx * 4 * 2  # f32 write+read
            if k.kind == "mlstm":
                score_bytes += lay.b_local * cfg.num_heads * S * S * 4 * 2
        out["attn_scores"] = score_bytes * (1.5 if cell.kind == "train" else 1.0)
    if cell.kind == "train":
        # sampler sweep: read theta, p, g, c̃; write theta, p
        # (grads are param-dtype: value_and_grad matches the param dtype)
        state_local = P_total * lay.chains / lay.devices
        grads_local = P_total * lay.chains / lay.devices
        # fused kernel: in-kernel noise + single pass = 4 reads 2 writes
        streams = 6.0 if fused_sampler else (5.0 + 1.0)
        out["sampler"] = (streams - 1.0) * state_local + grads_local
        if not fused_sampler:  # the unfused update materializes the Gaussian noise
            out["sampler_noise"] = 2 * state_local
        out["grads_write"] = grads_local
    out["total"] = sum(out.values())
    return out


def collective_model(arch: str, shape_name: str, multi_pod: bool = False,
                     overrides: dict | None = None, *, num_chains=None,
                     sync_every: int = 4, sync_compression: float = 1.0,
                     shard_style: str = "tp_fsdp", remat: str = "full",
                     tp_size=None) -> dict:
    """PER-DEVICE collective bytes per step (ring-algorithm first order:
    all-gather/reduce-scatter of N bytes over an axis costs ~N bytes on the
    wire per device; all-reduce costs ~2N)."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = configs.SHAPES[shape_name]
    lay = _layout(arch, shape_name, multi_pod, num_chains, sync_every, style=shard_style, tp_size=tp_size)
    pbytes = cfg.param_dtype.itemsize
    abytes = cfg.compute_dtype.itemsize
    P_total = num_params(cfg) * pbytes
    B, S = cell.global_batch, cell.seq_len
    D, L = cfg.d_model, cfg.num_layers
    out = {}
    w_passes = (3.0 if remat == "full" else 2.0) if cell.kind == "train" else 1.0
    if lay.fsdp > 1:
        out["fsdp_allgather"] = P_total / lay.tp * w_passes
    if lay.tp > 1:
        # megatron-style: ~2 activation all-reduces per layer per pass,
        # all-reduce wire ~ 2x payload
        act_ar = 2 * lay.b_local * (S if cell.kind != "decode" else 1) * D * abytes * L * 2
        out["tp_allreduce"] = act_ar * (2.0 if cell.kind == "train" else 1.0)
    if cell.kind == "train":
        grads_bytes = num_params(cfg) * pbytes
        if lay.style == "dp":
            out["grad_allreduce"] = 2 * grads_bytes  # ring AR over the DP group
        elif lay.fsdp > 1:
            out["grad_reduce_scatter"] = grads_bytes / lay.tp
        # EC elastic-coupling exchange: pmean(theta) over the chain axis,
        # every s steps (amortized) — the paper's ONLY cross-chain traffic
        if lay.chains > 1:
            shard = P_total / (lay.tp * lay.fsdp) * sync_compression
            out["ec_sync_amortized"] = 2 * shard / lay.sync_every
    out["total"] = sum(out.values())
    return out


def analyze_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 overrides: dict | None = None, *, flash_attn: bool = False,
                 num_chains=None, sync_every: int = 4,
                 sync_compression: float = 1.0, shard_style: str = "tp_fsdp",
                 remat: str = "full", fused_sampler: bool = False,
                 tp_size=None) -> dict:
    cell = configs.SHAPES[shape_name]
    lay = _layout(arch, shape_name, multi_pod, num_chains, sync_every,
                  style=shard_style, tp_size=tp_size)
    fl = flops_model(arch, shape_name, overrides, remat=remat)
    # flops_model uses the GLOBAL batch = all chains' tokens together, so
    # dividing by the device count is chain-correct.
    flops_dev = fl["total"] / lay.devices
    hbm = hbm_model(arch, shape_name, multi_pod, overrides,
                    flash_attn=flash_attn, num_chains=num_chains,
                    shard_style=shard_style, remat=remat, fused_sampler=fused_sampler,
                    tp_size=tp_size)
    coll = collective_model(arch, shape_name, multi_pod, overrides,
                            num_chains=num_chains, sync_every=sync_every,
                            sync_compression=sync_compression,
                            shard_style=shard_style, remat=remat, tp_size=tp_size)
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    n_act = active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n_act * tokens
    t_c = flops_dev / HW["peak_flops_bf16"]
    t_m = hbm["total"] / HW["hbm_bw"]
    t_x = coll["total"] / HW["nvlink_bw"]
    dom = max(t_c, t_m, t_x)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chains": lay.chains,
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": ["compute", "memory", "collective"][[t_c, t_m, t_x].index(dom)],
        "roofline_frac": t_c / dom if dom else 0.0,
        "flops_per_dev": flops_dev,
        "hbm_breakdown": hbm,
        "coll_breakdown": coll,
        "model_flops_global": model_flops,
        "useful_ratio": model_flops / (flops_dev * lay.devices) if flops_dev else 0.0,
    }
