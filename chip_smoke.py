#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports torch, numpy and repro_torch only, and:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the four CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` (one nvcc per source, in parallel);
3. holds each kernel against its plain PyTorch version on the card at its
   main path's shapes, and times kernel, plain version and (flash) the
   PyTorch library call, beside the least time the card could take;
4. the sampler: checks the fused EC-SGHMC kernel's in-kernel Philox noise
   against N(0, 1) over the 2.38e9 elements of a qwen3-0.6b K=4 step, runs
   fused EC-SGHMC on a Gaussian target against the exact stationary
   oracle, and holds SMOKE training (``train.loop.run``) on the card
   against the CPU;
5. serves the K=4-member Bayesian ensemble of qwen3-0.6b at full width
   (random weights from seeded generators) through ``ServeEngine.run`` on
   the paged path with the three serving kernels, greedily and at
   T=0.7/top-k 50, checks every request, the launch counters and agreement
   with the dense engine, holds the whole engine on the card against the
   CPU at the SMOKE size, and profiles a short paged run with
   torch.profiler (device time by kernel class, the device's busy share of
   the unprofiled wall clock);
6. trains K=4 chains of qwen3-0.6b at full width for 8 EC-SGHMC steps
   through ``train.loop.run`` with the fused kernel, checks the metrics,
   the launch count and the chains' spread, and profiles two more steps;
7. the adaptive tier: holds the preconditioned Eq. 6 kernel against its
   plain version and against the scalar-mass kernel at M^-1 == 1, runs
   fused scale-adapted EC-SGHMC with a known frozen M^-1 on a Gaussian
   target against the exact oracle, and trains the same K=4 qwen3-0.6b
   chains for 8 scale-adapted EC-SGHMC steps across the burn-in freeze,
   then profiles two more;
8. prints one JSON line of the five kernels, the card line, and the result
   line.

TF32 is off for matmuls and cuDNN (``allow_tf32 = False``), so f32
products are full f32.  Any failure raises and exits non-zero; without
CUDA it exits 2 and prints no result.  Long output (nvcc's build log, the
profile table, the full JSON result) goes to ``build/chip_smoke/``.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor rate
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores

FLASH_ATOL = 2e-2  # bf16 output: a few bf16 ulps at |o| ~ 1
PAGED_ATOL = 2e-2
BMA_LOGP_ATOL = 1e-4  # f32 logsumexp over 151936 terms in another order
SLICE_FIRST_LOGP_ATOL = 1e-3  # paged vs dense engine, first token's mixture row
SMOKE_LOGP_ATOL = 1e-4  # whole engine, card vs CPU, f32 SMOKE config
SERVING_KERNELS = ("flash_attention", "paged_attention", "bma_select")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float, flops_rate: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def phase_flash(torch, ops, ref, F):
    import repro_torch.kernels.flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for S in (64, 128):
        B, Hq, Hkv, d = 1, 16, 8, 128
        q = torch.randn((B, Hq, S, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, Hkv, S, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, Hkv, S, d), generator=g, device="cuda").to(torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        got = ops.flash_attention(q, k, v, causal=True, scale=scale)
        want = ref.attention(q, k, v, causal=True, scale=scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not (err <= FLASH_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"flash S={S}: max|kernel - plain| = {err} > {FLASH_ATOL}")
        out = torch.empty_like(q)
        ms = time_ms(torch, lambda: fa.launch(q, k, v, out, causal=True, window=None,
                                              softcap=None, scale=scale))
        plain = time_ms(torch, lambda: ref.attention(q, k, v, causal=True, scale=scale))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True))
        nbytes = 2 * (2 * B * Hq * S * d + 2 * B * Hkv * S * d)
        flops = 4 * B * Hq * d * S * (S + 1) / 2  # causal: QK^T and PV over the lower triangle
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[flash] B={B} Hq={Hq} Hkv={Hkv} S={S} d={d} bf16: max_abs_err={err:.3e} "
            f"(atol {FLASH_ATOL}) kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
        rows.append(dict(S=S, err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def phase_paged(torch, ops, ref):
    import repro_torch.kernels.paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(12)
    B, Hkv, G, d, bs, M = 8, 8, 2, 128, 16, 10
    P = B * M + 1
    q = torch.randn((B, Hkv, G, d), generator=g, device="cuda").to(torch.bfloat16)
    kp = torch.randn((P, bs, Hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn((P, bs, Hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    perm = np.random.default_rng(12).permutation(np.arange(1, P)).astype(np.int32)
    tables = torch.tensor(perm.reshape(B, M), device="cuda")
    ctx_np = np.linspace(1, M * bs - 1, B).astype(np.int32)
    ctx = torch.tensor(ctx_np, device="cuda")
    scale = 1.0 / math.sqrt(d)
    got = ops.paged_attention(q, kp, vp, tables, ctx, scale=scale)
    want = ref.paged_attention(q, kp, vp, tables, ctx, scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not (err <= PAGED_ATOL and torch.isfinite(got).all()):
        raise AssertionError(f"paged: max|kernel - plain| = {err} > {PAGED_ATOL}")
    out = torch.empty_like(q)
    ms = time_ms(torch, lambda: pa.launch(q, kp, vp, tables, ctx, out, scale=scale,
                                          window=None, softcap=None))
    plain = time_ms(torch, lambda: ref.paged_attention(q, kp, vp, tables, ctx, scale=scale))
    keys = int((ctx_np.astype(np.int64) + 1).sum())
    nbytes = 2 * keys * Hkv * d * 2 + 2 * 2 * B * Hkv * G * d + 4 * B * M + 4 * B
    flops = 4 * keys * Hkv * G * d
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    log(f"[paged] slots={B} Hkv={Hkv} G={G} d={d} bs={bs} ctx={ctx_np.tolist()} bf16: "
        f"max_abs_err={err:.3e} (atol {PAGED_ATOL}) kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase_bma(torch, ops, ref):
    import repro_torch.kernels.bma_select as bs_mod
    from repro_torch.serve.sampling import _top_k_mask, gumbel_noise

    g = torch.Generator(device="cuda").manual_seed(13)
    K, S, V = 4, 8, 151936
    logits = 3.0 * torch.randn((K, S, V), generator=g, device="cuda")
    gumbel = gumbel_noise((S, V), g, "cuda")
    rows = []
    for mode in ("probs", "logprobs"):
        for T, top_k in ((0.0, 0), (0.7, 50)):
            gum = gumbel if T > 0 else None
            tok, logp = bs_mod.launch(logits, gum, mode=mode, temperature=T, top_k=top_k,
                                      chunk=ops.BMA_CHUNK)
            rtok, rlogp = ref.bma_select(logits, gum, mode=mode, temperature=T, top_k=top_k)
            torch.cuda.synchronize()
            err = (logp - rlogp).abs().max().item()
            if not (err <= BMA_LOGP_ATOL and torch.isfinite(logp).all()):
                raise AssertionError(f"bma {mode} T={T}: max|logp - plain| = {err} > {BMA_LOGP_ATOL}")
            # a token may differ only where the plain version's top two
            # selection values lie within the logp tolerance
            sel = rlogp
            if T > 0:
                sel = rlogp / T
                sel = (_top_k_mask(sel, top_k) if top_k else sel) + gumbel
            tol = BMA_LOGP_ATOL / (T if T > 0 else 1.0)
            ties = 0
            for s in np.nonzero((tok != rtok).cpu().numpy())[0]:
                a, b = sel[s, int(tok[s])].item(), sel[s, int(rtok[s])].item()
                if not abs(a - b) <= tol:
                    raise AssertionError(f"bma {mode} T={T} slot {s}: token {int(tok[s])} vs "
                                         f"plain {int(rtok[s])}, selection gap {abs(a - b)} > {tol}")
                ties += 1
            ms = time_ms(torch, lambda: bs_mod.launch(logits, gum, mode=mode, temperature=T,
                                                      top_k=top_k, chunk=ops.BMA_CHUNK))
            plain = time_ms(torch, lambda: ref.bma_select(logits, gum, mode=mode, temperature=T,
                                                          top_k=top_k))
            nbytes = 4 * (K * S * V + S * V + (S * V if T > 0 else 0) + S)
            flops = 6 * K * S * V
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
            log(f"[bma] K={K} S={S} V={V} mode={mode} T={T} top_k={top_k}: "
                f"max_abs_err={err:.3e} (atol {BMA_LOGP_ATOL}) token mismatches within tol={ties} "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            rows.append(dict(mode=mode, T=T, top_k=top_k, err=err, ms=ms, plain_ms=plain,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by, ties=ties))
    return rows


# ---------------------------------------------------------------------------
# the slice: qwen3-0.6b K=4 ensemble served end to end
# ---------------------------------------------------------------------------


def stacked_members(torch, cfg, model, K, device, seed0=0):
    from repro_torch.models import init_params, tree_map

    members = None
    for k in range(K):
        gen = torch.Generator(device=device).manual_seed(seed0 + k)
        p = init_params(model.param_specs(cfg), gen, device)
        p = tree_map(lambda a: a[None], p)
        members = p if members is None else tree_map(lambda a, b: torch.cat([a, b]), members, p)
        del p
    return members


def check_report(rep, trace, V, label):
    if len(rep.results) != len(trace):
        raise AssertionError(f"{label}: {len(rep.results)} results for {len(trace)} requests")
    for r, req in zip(rep.results, trace):
        t = r.tokens
        if r.truncated or t.size != req.max_new or t.min() < 0 or t.max() >= V:
            raise AssertionError(f"{label}: request {r.rid} bad: {t.size} tokens, "
                                 f"truncated={r.truncated}, range [{t.min()}, {t.max()}]")
        if r.logprobs is not None and not np.isfinite(r.logprobs).all():
            raise AssertionError(f"{label}: request {r.rid} has non-finite log-probs")


def phase_slice(torch, card):
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import get_model
    from repro_torch.serve.engine import ServeEngine, synthetic_trace
    from repro_torch.serve.sampling import SamplingParams

    cfg = configs.get_config("qwen3-0.6b").replace(use_flash_kernel=True)
    model = get_model(cfg)
    K = configs.EC_CHAINS["qwen3-0.6b"]
    t0 = time.perf_counter()
    members = stacked_members(torch, cfg, model, K, "cuda")
    torch.cuda.synchronize()
    log(f"[slice] qwen3-0.6b full width, K={K} members, init {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    trace = synthetic_trace(16, vocab_size=cfg.vocab_size, prompt_lens=(64, 128), max_new=32, seed=0)
    max_seq = 128 + 32
    kw = dict(num_slots=8, max_seq=max_seq, record_logprobs=True, device="cuda")

    def serve(paged, sampling, label):
        eng = ServeEngine(cfg, model, members, paged=paged, sampling=sampling, **kw)
        torch.cuda.synchronize()
        rep = eng.run(trace)
        check_report(rep, trace, cfg.vocab_size, label)
        pct = rep.latency_percentiles()
        log(f"[slice] {label}: {rep.total_tokens} tokens, {rep.decode_steps} decode ticks, "
            f"{rep.tokens_per_s:.1f} tok/s, latency p50 {pct['latency_p50_s']:.3f} s "
            f"p99 {pct['latency_p99_s']:.3f} s, first token p50 {pct['first_token_p50_s']:.3f} s "
            f"p99 {pct['first_token_p99_s']:.3f} s, wall {rep.wall_s:.2f} s [{card}]")
        return rep

    # warm-up on a short trace: cuBLAS handles, allocator pools
    ServeEngine(cfg, model, members, paged=True, **kw).run(trace[:2])
    torch.cuda.synchronize()

    reset_launches()
    rep = serve(True, SamplingParams(), "paged greedy")
    torch.cuda.synchronize()
    counts = {n: launches[n] for n in SERVING_KERNELS}
    log(f"[slice] launches on the paged greedy run: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {counts}")

    reset_launches()
    serve(True, SamplingParams(temperature=0.7, top_k=50), "paged T=0.7 top_k=50")
    log(f"[slice] launches on the sampled run: {dict(launches)}")
    if min(launches[n] for n in SERVING_KERNELS) <= 0:
        raise AssertionError(f"a kernel was not launched on the sampled run: {dict(launches)}")

    dense = serve(False, SamplingParams(), "dense greedy")
    first = max(float(np.abs(a.logprobs[0] - b.logprobs[0]).max())
                for a, b in zip(rep.results, dense.results))
    second = max(float(np.abs(a.logprobs[1] - b.logprobs[1]).max())
                 for a, b in zip(rep.results, dense.results) if a.tokens[0] == b.tokens[0])
    same = sum(int((a.tokens == b.tokens).all()) for a, b in zip(rep.results, dense.results))
    log(f"[slice] paged vs dense: first-token mixture logp max diff {first:.3e} "
        f"(atol {SLICE_FIRST_LOGP_ATOL}); first decode tick max diff {second:.3e} (bf16, not "
        f"gated); {same}/{len(trace)} requests with identical tokens")
    if not first <= SLICE_FIRST_LOGP_ATOL:
        raise AssertionError(f"paged vs dense first-token logp differ by {first}")
    per_tick = {n: c / max(rep.decode_steps, 1) for n, c in counts.items()}
    profile_serving(torch, cfg, model, members, kw, card)
    del members
    torch.cuda.empty_cache()
    return counts, per_tick


KERNEL_CLASSES = (  # (label, substrings of a device kernel's name), first match wins
    ("hand kernels", ("flash_fwd", "paged_fwd", "member_stats", "mixture", "normalize",
                      "topk_threshold", "select_partial", "select_final")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("copies and casts", ("copy",)),
)


def kernel_class(name: str) -> str:
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other elementwise and reductions"


def profile_serving(torch, cfg, model, members, kw, card):
    """Where a serving run's time goes: the device kernels of a short paged
    greedy run (torch.profiler, CUDA activity only) against the wall clock
    of the same run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine, synthetic_trace

    trace = synthetic_trace(8, vocab_size=cfg.vocab_size, prompt_lens=(64, 128), max_new=4, seed=1)

    def run():
        eng = ServeEngine(cfg, model, members, paged=True, **dict(kw, record_logprobs=False))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.run(trace)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    rep, wall = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    (OUT / "profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    if device_us <= 0:
        log("[profile] torch.profiler recorded no device time: busy share not measured")
        return
    n = sum(e.count for e in kernels)
    log(f"[profile] paged greedy, {len(trace)} requests x 4 tokens ({len(trace)} admits, "
        f"{rep.decode_steps} ticks): wall {wall:.3f} s without the profiler, device kernels "
        f"{device_us / 1e6:.3f} s = {100 * device_us / 1e6 / wall:.1f}% busy, {n} kernels [{card}]")
    classes: dict = {}
    for e in kernels:
        c = kernel_class(e.key)
        classes[c] = classes.get(c, 0.0) + e.self_device_time_total
    for c, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {100 * us / device_us:5.1f}%  {us / 1e3:9.3f} ms  {c}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {100 * e.self_device_time_total / device_us:5.1f}%  "
            f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:80]}")


def phase_smoke_engine(torch):
    """The whole engine on the card against the CPU, at the SMOKE size in
    f32: the same params, trace and greedy sampling give the same tokens."""
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import get_model, tree_map
    from repro_torch.serve.engine import ServeEngine, synthetic_trace

    cfg = configs.get_config("qwen3-0.6b", smoke=True).replace(use_flash_kernel=True)
    model = get_model(cfg)
    members = stacked_members(torch, cfg, model, 4, "cpu", seed0=100)
    trace = synthetic_trace(6, vocab_size=cfg.vocab_size, prompt_lens=(16, 8), max_new=6, seed=3)
    reps = {}
    for dev in ("cpu", "cuda"):
        mem = tree_map(lambda a: a.to(dev), members)
        reset_launches()
        reps[dev] = ServeEngine(cfg, model, mem, num_slots=4, max_seq=24, paged=True,
                                record_logprobs=True, device=dev).run(trace)
        if dev == "cuda" and min(launches[n] for n in SERVING_KERNELS) <= 0:
            raise AssertionError(f"smoke engine on the card missed a kernel: {dict(launches)}")
    diff = max(float(np.abs(a.logprobs - b.logprobs).max())
               for a, b in zip(reps["cpu"].results, reps["cuda"].results))
    same = all((a.tokens == b.tokens).all() for a, b in zip(reps["cpu"].results, reps["cuda"].results))
    log(f"[smoke-engine] SMOKE f32, paged, flash on: card vs CPU tokens equal={same}, "
        f"logp max diff {diff:.3e} (atol {SMOKE_LOGP_ATOL})")
    if not (same and diff <= SMOKE_LOGP_ATOL):
        raise AssertionError("engine on the card disagrees with the CPU at the SMOKE size")


# ---------------------------------------------------------------------------
# the sampler: fused Eq. 6 kernel, Philox noise, stationary oracle, training
# ---------------------------------------------------------------------------

EC_ULP_MAX = 2  # p' against the plain version, f32 (ROADMAP Queue C if > 0)
EC_KEY = 0x5EED5EED  # Philox key of the kernel phases
EC_HYPER = dict(eps=1e-2, friction=1.0, mass=1.0, alpha=1.0, sigma_p=0.05)

# The on-card stationary case: fused EC-SGHMC on U = (lam/2)||theta - mu||^2
# (tests/test_stationary.py's EC_KW).  Its oracle numbers are those of
# repro.diagnostics.ec_sghmc_stationary for this case, which imports jax;
# tests/test_torch_stationary.py pins them to it.
STATIONARY_CASE = dict(eps=0.1, alpha=1.0, s=1, K=4, lam=1.0, mu=1.5,
                       ec_kw=dict(friction=1.0, center_friction=1.0, noise_convention="eq6",
                                  center_noise_in_p=False))
ORACLE_MEAN = 1.5
ORACLE_VAR = 0.11326292549241243
ORACLE_CROSS_COV = 0.050435694568097905
STATIONARY_D = 8192
STATIONARY_STEPS, STATIONARY_BURN = 4000, 1000

# The on-card preconditioned case: fused scale-adapted EC-SGHMC on
# N(mu, diag(lam)^-1) with three groups of dimensions, and V̂ set per group
# with burnin 0, so that V̂ never moves and M^-1 = 1/(sqrt(V̂) + eps) is
# known before the run.  The oracle numbers are those of
# repro.diagnostics.preconditioned_ec_sghmc_stationary for this case (per
# group), which imports jax; tests/test_torch_adaptive_stationary.py pins
# them, and the M^-1 the sampler forms, to it.
PRECOND_CASE = dict(eps=0.1, alpha=1.0, s=4, K=4, mu=1.5, lam=[4.0, 1.0, 0.25],
                    v_hat=[4.0, 1.0, 0.25], minv=[0.5, 1.0, 2.0], decay=0.99, precond_eps=1e-8,
                    ec_kw=dict(friction=1.0, center_friction=1.0, noise_convention="eq4",
                               center_noise_in_p=False))
PRECOND_ORACLE_MEAN = [1.5, 1.5, 1.5]
PRECOND_ORACLE_VAR = [0.49064196194826687, 1.092295488887424, 2.9153315094854095]
PRECOND_ORACLE_CROSS_COV = [0.08809420088768465, 0.4640232526241377, 1.994740398526435]
PRECOND_GROUP_D = 2048  # dimensions per group: D = 6144

SMOKE_TRAIN_ATOL = 1e-5  # card vs CPU after 3 steps: GEMMs sum in another order
TRAIN_STEPS = 8
TRAIN_N_DATA = 100_000  # launch/train.py's default
ADAPTIVE_BURNIN = 4  # both the adapting and the frozen regime within the 8 steps


def qwen_leaf_shapes(cfg, K):
    from repro_torch.models import get_model, tree_leaves

    return [(K,) + tuple(s.shape) for s in tree_leaves(get_model(cfg).param_specs(cfg))]


def ec_bytes(K, N, itemsize=4, bits=False, precond=False):
    """Least traffic of one fused update: theta, p, g read and theta', p'
    written per chain element (g is f32), c~ read once per element of one
    chain, the two bit streams in parity mode, and the f32 M^-1 stream of
    the preconditioned update."""
    return K * N * (4 * itemsize + 4 + (8 if bits else 0) + (4 if precond else 0)) + N * itemsize


def ulp_gap(torch, got, want) -> float:
    """Largest |got - want| in f32 ULPs of want."""
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 24)
    return ((got.float() - want).abs() / ulp).max().item()


# The fused kernels' checks: (name, shape, dtype) of the main path's leaves
# (the embedding, the largest layer leaf) and two ragged leaves, one on
# each of the kernel's two paths.
FUSED_CASES = [("embed/table", (4, 151936, 1024), "float32"),
               ("layers/mlp/w_gate", (4, 28, 1024, 3072), "float32"),
               ("ragged, 4-wide path", (4, 1000004), "float32"),
               ("ragged, 1-wide path", (4, 1000003), "float32"),
               ("embed/table", (4, 151936, 1024), "bfloat16"),
               ("ragged, 1-wide path", (4, 1000003), "bfloat16")]


def fused_operands(torch, g, shape, dtype):
    """One leaf's operands from the generator g: theta, p, g, M^-1 =
    exp(0.5 N(0, 1)), c~ and the two bit streams of parity mode."""
    theta = torch.randn(shape, generator=g, device="cuda").to(dtype)
    return dict(theta=theta, p=(0.1 * torch.randn(shape, generator=g, device="cuda")).to(dtype),
                g=torch.randn(shape, generator=g, device="cuda"),
                minv=torch.exp(0.5 * torch.randn(shape, generator=g, device="cuda")),
                c=torch.randn(shape[1:], generator=g, device="cuda").to(dtype),
                bits=tuple(torch.randint(-2**31, 2**31 - 1, shape, generator=g, device="cuda",
                                         dtype=torch.int32) for _ in range(2)))


def check_fused(torch, label, kernel, plain, g, p_ulp_max):
    """Every FUSED_CASES leaf through kernel(o) and plain(o), each ->
    (theta', p'): theta' bitwise equal in f32 and p' within p_ulp_max ULP;
    in bf16 (stochastic rounding) all but 1e-6 of the elements within one
    bf16 ULP.  Returns (max abs err, rows)."""
    max_err, rows = 0.0, []
    for name, shape, dtype in FUSED_CASES:
        o = fused_operands(torch, g, shape, getattr(torch, dtype))
        (t_k, p_k), (t_r, p_r) = kernel(o), plain(o)
        torch.cuda.synchronize()
        err = max((t_k.float() - t_r.float()).abs().max().item(),
                  (p_k.float() - p_r.float()).abs().max().item())
        if dtype == "float32":
            gap, same = ulp_gap(torch, p_k, p_r), torch.equal(p_k, p_r)
            log(f"[{label}] {name} {shape} f32: theta' bitwise equal {torch.equal(t_k, t_r)}, p' "
                f"bitwise equal {same} (max gap {gap:.0f} ULP, max abs err {err:.3e})")
            if not torch.equal(t_k, t_r) or gap > p_ulp_max:
                raise AssertionError(f"{label} {name}: theta' not bitwise equal to the plain "
                                     f"version, or p' more than {p_ulp_max} ULP from it")
            max_err = max(max_err, err)
            rows.append(dict(name=name, shape=shape, dtype="f32", err=err, ulp=gap))
        else:
            shares = []
            for a, b in ((t_k, t_r), (p_k, p_r)):
                ai, bi = a.view(torch.int16).int(), b.view(torch.int16).int()
                shares.append(((ai == bi).float().mean().item(),
                               ((ai - bi).abs() <= 1).float().mean().item()))
            log(f"[{label}] {name} {shape} bf16, stochastic rounding: share equal theta' "
                f"{shares[0][0]:.9f} p' {shares[1][0]:.9f}; within 1 bf16 ULP "
                f"{shares[0][1]:.9f} / {shares[1][1]:.9f}")
            if min(s[1] for s in shares) < 1.0 - 1e-6:
                raise AssertionError(f"{label} {name} bf16: more than 1e-6 of the elements "
                                     "differ by more than 1 bf16 ULP")
            rows.append(dict(name=name, shape=shape, dtype="bf16", shares=shares))
        del o, t_k, p_k, t_r, p_r
        torch.cuda.empty_cache()
    return max_err, rows


def step_times(torch, label, launch, plain, g, cfg_full, precond):
    """Per-step times over qwen3-0.6b's 13 leaves at K = 4, f32: the kernel
    in Philox and in parity mode (launch(o, K, N, theta_out, bits), p'
    over p), the plain version (median of 5) and the bounds."""
    K = 4
    ms = parity_ms = plain_ms = 0.0
    nbytes = parity_bytes = 0
    shapes = qwen_leaf_shapes(cfg_full, K)
    for shape in shapes:
        o = fused_operands(torch, g, shape, torch.float32)
        N = o["theta"].numel() // K
        t_out = torch.empty_like(o["theta"])
        ms += time_ms(torch, lambda: launch(o, K, N, t_out, (None, None)))
        parity_ms += time_ms(torch, lambda: launch(o, K, N, t_out, o["bits"]))
        plain_ms += time_ms(torch, lambda: plain(o), reps=5, warmup=1)
        nbytes += ec_bytes(K, N, precond=precond)
        parity_bytes += ec_bytes(K, N, bits=True, precond=precond)
        del o, t_out
        torch.cuda.empty_cache()
    b_ms, b_by = bound(nbytes, 0.0, F32_FLOPS_PER_S)
    pb_ms, _ = bound(parity_bytes, 0.0, F32_FLOPS_PER_S)
    log(f"[{label}] one step of qwen3-0.6b K={K}, {len(shapes)} leaves, f32: kernel {ms:.4f} ms "
        f"(Philox mode), bound {b_ms:.4f} ms ({nbytes / 1e9:.2f} GB, {b_by}); parity mode "
        f"{parity_ms:.4f} ms, bound {pb_ms:.4f} ms ({parity_bytes / 1e9:.2f} GB); plain version "
        f"{plain_ms:.4f} ms (bits given, median of 5); library: none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                parity_ms=parity_ms, parity_bound_ms=pb_ms, bytes=nbytes)


def phase_fused_ec(torch, ops, ref, cfg_full):
    """The kernel against its plain version in parity mode (bits from a
    seeded generator) at the main path's shapes, f32 and bf16 with
    stochastic rounding; then the per-step times over qwen3-0.6b's 13
    leaves at K = 4."""
    import repro_torch.kernels.fused_ecsghmc as fe

    g = torch.Generator(device="cuda").manual_seed(14)
    scalars = ref.ec_scalars(EC_HYPER["eps"], EC_HYPER["friction"], 1.0 / EC_HYPER["mass"],
                             EC_HYPER["alpha"], EC_HYPER["sigma_p"])
    plain = lambda o: ref.fused_ec_update(o["theta"], o["p"], o["g"], o["c"], *o["bits"],
                                          scalars=scalars, stochastic_round=True)
    err, rows = check_fused(
        torch, "fused_ec",
        lambda o: ops.fused_ec_update(o["theta"], o["p"], o["g"], o["c"], bits=o["bits"],
                                      **EC_HYPER),
        plain, g, EC_ULP_MAX)
    launch = lambda o, K, N, t_out, bits: fe.launch(
        o["theta"], o["p"], o["g"], o["c"], *bits, t_out, o["p"], K=K, N=N, seed=EC_KEY, leaf=0,
        step=0, scalars=scalars, stochastic_round=True)
    out = step_times(torch, "fused_ec", launch, plain, g, cfg_full, precond=False)
    return dict(out, err=err, ulp=max(r.get("ulp", 0.0) for r in rows), rows=rows)


def phase_fused_precond(torch, ops, ref, cfg_full):
    """The preconditioned kernel as ``phase_fused_ec`` checks the scalar-mass
    one, with M^-1 = exp(0.5 N(0, 1)) and p' bitwise; and at M^-1 == 1
    against the scalar-mass kernel on both paths, in both noise modes."""
    import repro_torch.kernels.fused_ecsghmc as fe

    g = torch.Generator(device="cuda").manual_seed(15)
    hyper = {k: v for k, v in EC_HYPER.items() if k != "mass"}
    scalars = ref.precond_scalars(**hyper)
    plain = lambda o: ref.fused_precond_ec_update(o["theta"], o["p"], o["g"], o["c"], o["minv"],
                                                  *o["bits"], scalars=scalars,
                                                  stochastic_round=True)
    err, rows = check_fused(
        torch, "fused_precond",
        lambda o: ops.fused_precond_ec_update(o["theta"], o["p"], o["g"], o["c"], o["minv"],
                                              bits=o["bits"], **hyper),
        plain, g, 0)

    # at M^-1 == 1 the two kernels agree bit for bit (the reference's
    # promise for its two dispatch paths)
    for N in (1000004, 1000003):
        o = fused_operands(torch, g, (4, N), torch.float32)
        args = (o["theta"], o["p"], o["g"], o["c"])
        for mode, noise in (("Philox", dict(seed=EC_KEY, leaf=5, step=11)),
                            ("parity", dict(bits=o["bits"]))):
            a = ops.fused_precond_ec_update(*args, torch.ones_like(o["theta"]), **noise, **hyper)
            b = ops.fused_ec_update(*args, mass=1.0, **noise, **hyper)
            torch.cuda.synchronize()
            same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            log(f"[fused_precond] M^-1 == 1 vs fused_ec_update(mass=1), N={N}, {mode} mode: "
                f"bitwise equal {same}")
            if not same:
                raise AssertionError(f"precond kernel at M^-1 == 1 differs from fused_ec_update "
                                     f"({mode})")
        del o, args, a, b
        torch.cuda.empty_cache()

    launch = lambda o, K, N, t_out, bits: fe.launch_precond(
        o["theta"], o["p"], o["g"], o["minv"], o["c"], *bits, t_out, o["p"], K=K, N=N,
        seed=EC_KEY, leaf=0, step=0, scalars=scalars, stochastic_round=True)
    out = step_times(torch, "fused_precond", launch, plain, g, cfg_full, precond=True)
    return dict(out, err=err, rows=rows)


def phase_philox(torch, ops, ref, cfg_full):
    """Production mode with theta = p = g = c~ = 0, decay = 1 and sigma_p = 1
    makes p' the noise itself: its mean, variance and fourth moment over all
    2.38e9 elements of qwen3-0.6b at K = 4 against N(0, 1), within 6 sigma of
    their Monte-Carlo error.  The stream repeats for the same (key, leaf,
    step), changes with the step, and equals the plain version's bits."""
    hyper = dict(eps=0.0, friction=0.0, mass=1.0, alpha=0.0, sigma_p=1.0)
    K = 4
    s1 = s2 = s4 = 0.0
    n = 0
    for i, shape in enumerate(qwen_leaf_shapes(cfg_full, K)):
        z = torch.zeros(shape, device="cuda")
        c = torch.zeros(shape[1:], device="cuda")
        _, x = ops.fused_ec_update(z, z, z, c, seed=EC_KEY, leaf=i, step=7, **hyper)
        s1 += torch.sum(x, dtype=torch.float64).item()
        x2 = x * x
        s2 += torch.sum(x2, dtype=torch.float64).item()
        s4 += torch.sum(x2 * x2, dtype=torch.float64).item()
        n += x.numel()
        del z, c, x, x2
    torch.cuda.empty_cache()
    m1, m2, m4 = s1 / n, s2 / n, s4 / n
    tol = [6.0 * math.sqrt(v / n) for v in (1.0, 2.0, 96.0)]  # Var of x, x^2, x^4 under N(0,1)
    log(f"[philox] {n} draws: mean {m1:.3e} (tol {tol[0]:.2e}), E[x^2] {m2:.7f} (1, tol "
        f"{tol[1]:.2e}), E[x^4] {m4:.6f} (3, tol {tol[2]:.2e})")
    if not (abs(m1) < tol[0] and abs(m2 - 1) < tol[1] and abs(m4 - 3) < tol[2]):
        raise AssertionError("Philox noise moments are off N(0, 1)")
    shape = (K, 250001)  # odd N: the 1-wide path, odd element indices
    z = torch.zeros(shape, device="cuda")
    c = torch.zeros(shape[1:], device="cuda")
    draw = lambda step: ops.fused_ec_update(z, z, z, c, seed=EC_KEY, leaf=3, step=step, **hyper)[1]
    a, b, a2 = draw(5), draw(6), draw(5)
    h1, h2 = ref.philox_bits(EC_KEY, 3, 5, z.numel())
    bits = tuple(torch.from_numpy(h.view(np.int32)).cuda().view(shape) for h in (h1, h2))
    plain = ops.fused_ec_update(z, z, z, c, bits=bits, **hyper)[1]
    z4 = torch.zeros((K, 250000), device="cuda")
    wide = ops.fused_ec_update(z4, z4, z4, z4[0], seed=EC_KEY, leaf=3, step=5, **hyper)[1]
    torch.cuda.synchronize()
    same_frac = (a == b).float().mean().item()
    log(f"[philox] same (key, leaf, step) repeats: {torch.equal(a, a2)}; next step shares "
        f"{same_frac:.2e} of values; kernel == plain Philox bits: {torch.equal(a, plain)}; "
        f"4-wide == 1-wide path on the shared elements: "
        f"{torch.equal(wide[0], a[0, :250000])}")
    if not (torch.equal(a, a2) and same_frac < 1e-3 and torch.equal(a, plain)
            and torch.equal(wide[0], a[0, :250000])):
        raise AssertionError("Philox stream check failed")
    return dict(n=n, m1=m1, m2=m2, m4=m4)


def phase_stationary(torch):
    """Fused EC-SGHMC with in-kernel Philox noise on the Gaussian target,
    through the port's rollout, against the exact oracle at 3 sigma.

    The mean is the pooled mean, with the band sized by the conservative
    (chain-mean) ESS of theta, as in tests/test_stationary.py.  The
    variance and cross-covariance are taken about the oracle's mean: about
    the empirical mean they are biased low by the variance of that mean,
    ~1/ESS per dimension (~1.3% here), which at D = 8192 is several times
    the band.  Their bands come from the conservative ESS of their own
    series (squared deviations, products of two chains' deviations): the
    chains are underdamped, so theta's ESS overstates them."""
    from repro_torch import core
    from repro_torch import diagnostics as diag
    from repro_torch.core import rng
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.run import rollout

    c = STATIONARY_CASE
    K, D, mu, lam = c["K"], STATIONARY_D, c["mu"], c["lam"]
    sampler = core.ec_sghmc(step_size=c["eps"], alpha=c["alpha"], sync_every=c["s"], fused=True,
                            **c["ec_kw"])
    p0 = torch.full((K, D), mu + 1.0, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    res = rollout(sampler, lambda th: lam * (th - mu), p0, num_steps=STATIONARY_STEPS,
                  keys=rng.split(rng.key(31), STATIONARY_STEPS), moments=True, chunk_steps=1000)
    wall = time.perf_counter() - t0
    if launches["fused_ec_update"] != STATIONARY_STEPS:
        raise AssertionError(f"stationary run launched the kernel {launches['fused_ec_update']} times")
    traj = res.trace.cpu().numpy()
    if not np.allclose(diag.welford_mean(res.moments).cpu().numpy(), traj.mean(0), rtol=2e-4, atol=2e-4):
        raise AssertionError("in-carry Welford mean disagrees with the trajectory")
    traj = np.moveaxis(traj[STATIONARY_BURN:], 1, 0).astype(np.float64)  # (K, T, D)
    checks = stationary_checks(traj, ORACLE_MEAN, ORACLE_VAR, ORACLE_CROSS_COV)
    log(f"[stationary] fused EC-SGHMC K={K} D={D} eps={c['eps']} alpha={c['alpha']} s={c['s']}, "
        f"{STATIONARY_STEPS} steps (burn-in {STATIONARY_BURN}) in {wall:.2f} s: "
        + "; ".join(f"{n} {got:.6f} vs oracle {want:.6f} (3 sigma {tol:.2e}, ESS {e:.0f})"
                    for n, got, want, tol, e in checks))
    bad = [n for n, got, want, tol, _ in checks if not abs(got - want) < tol]
    if bad:
        raise AssertionError(f"on-card stationary {bad} miss the oracle")


def stationary_checks(traj, mean, var, cross):
    """(name, got, want, 3 sigma, ESS) per moment of a (K, T, D) trajectory
    against the oracle's mean, variance and cross-covariance, as
    ``phase_stationary`` forms them."""
    from repro_torch import diagnostics as diag

    K = traj.shape[0]
    ess = float(np.sum(diag.coupled_ess_nd(traj)))
    checks = [("mean", traj.mean(), mean, 3.0 * math.sqrt(var / ess) + 1e-4, ess)]
    dev = traj - mean
    for name, series, want in (
            ("var", np.mean(dev * dev, axis=0), var),
            ("cross-cov", np.mean([dev[i] * dev[j] for i in range(K) for j in range(i + 1, K)],
                                  axis=0), cross)):
        ess_s = float(np.sum(diag.coupled_ess_nd(series[None])))
        checks.append((name, series.mean(), want, 3.0 * math.sqrt(series.var() / ess_s), ess_s))
    return checks


def phase_stationary_precond(torch):
    """Fused scale-adapted EC-SGHMC with in-kernel Philox noise and a known
    frozen M^-1 per group of dimensions, through the port's rollout, against
    the exact oracle at 3 sigma, per group (as ``phase_stationary``)."""
    from repro_torch import core
    from repro_torch.core import rng
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.run import rollout

    c = PRECOND_CASE
    K, G, n_g = c["K"], len(c["lam"]), PRECOND_GROUP_D
    per_dim = lambda xs: torch.tensor(xs, device="cuda").repeat_interleave(n_g)  # (D,)
    lam = per_dim(c["lam"])
    sampler = core.scale_adapted_ec_sghmc(
        step_size=c["eps"], alpha=c["alpha"], sync_every=c["s"], burnin=0, decay=c["decay"],
        precond_eps=c["precond_eps"], fused=True, **c["ec_kw"])
    p0 = torch.full((K, G * n_g), c["mu"] + 1.0, device="cuda")
    state = sampler.init(p0)
    state.precond.v.copy_(per_dim(c["v_hat"]).expand(K, -1))
    reset_launches()
    t0 = time.perf_counter()
    res = rollout(sampler, lambda th: lam * (th - c["mu"]), p0, num_steps=STATIONARY_STEPS,
                  keys=rng.split(rng.key(37), STATIONARY_STEPS), state=state, moments=False,
                  chunk_steps=1000)
    wall = time.perf_counter() - t0
    if launches["fused_precond_ec_update"] != STATIONARY_STEPS:
        raise AssertionError(f"stationary-precond launched the kernel "
                             f"{launches['fused_precond_ec_update']} times")
    traj = np.moveaxis(res.trace.cpu().numpy()[STATIONARY_BURN:], 1, 0).astype(np.float64)
    bad = []
    for i in range(G):
        checks = stationary_checks(traj[..., i * n_g:(i + 1) * n_g], PRECOND_ORACLE_MEAN[i],
                                   PRECOND_ORACLE_VAR[i], PRECOND_ORACLE_CROSS_COV[i])
        log(f"[stationary-precond] group {i} (lam {c['lam'][i]}, M^-1 {c['minv'][i]}): "
            + "; ".join(f"{n} {got:.6f} vs oracle {want:.6f} (3 sigma {tol:.2e}, ESS {e:.0f})"
                        for n, got, want, tol, e in checks))
        bad += [f"group {i} {n}" for n, got, want, tol, _ in checks if not abs(got - want) < tol]
    log(f"[stationary-precond] fused scale-adapted EC-SGHMC K={K} D={G * n_g} eps={c['eps']} "
        f"alpha={c['alpha']} s={c['s']}, frozen M^-1 {c['minv']}, {STATIONARY_STEPS} steps "
        f"(burn-in {STATIONARY_BURN}) in {wall:.2f} s")
    if bad:
        raise AssertionError(f"on-card preconditioned stationary {bad} miss the oracle")


def phase_smoke_train(torch):
    """SMOKE training, card against CPU: the same params, batches, bits and
    center noise through train.loop.run with the fused sampler, 3 steps."""
    from repro_torch import configs
    from repro_torch.data import chain_batches, synthetic_token_stream
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import default_sampler
    from repro_torch.models import get_model, tree_leaves, tree_map
    from repro_torch.train import LoopConfig, loop, make_train_step

    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    model = get_model(cfg)
    K, steps = 4, 3
    members = stacked_members(torch, cfg, model, K, "cpu", seed0=200)
    stream = synthetic_token_stream(cfg.vocab_size, seed=5, device="cpu")
    batches = [chain_batches(stream, t, K, 2, 16) for t in range(steps)]
    gen = torch.Generator().manual_seed(77)
    n_leaves = len(tree_leaves(members))
    noise = []
    for _ in range(steps):
        bits = tree_map(lambda x: tuple(torch.randint(-2**31, 2**31 - 1, x.shape, generator=gen,
                                                      dtype=torch.int32) for _ in range(2)), members)
        r = tree_map(lambda x: torch.randn(x.shape[1:], generator=gen), members)
        noise.append((bits, r))
    out = {}
    for dev in ("cpu", "cuda"):
        to = lambda t: tree_map(lambda x: x.to(dev, copy=True), t)  # the run updates in place
        samp = default_sampler(cfg, "qwen3-0.6b", K, sync_every=2, fused=True, step_size=1e-3)
        params = to(members)
        noise_fn = lambda step: {"p": tree_map(lambda b: tuple(x.to(dev) for x in b), noise[step][0]),
                                 "r": to(noise[step][1])}
        step = make_train_step(cfg, model, samp, 1000, noise_fn=noise_fn)
        reset_launches()
        p, s, h = loop.run(step, params, samp.init(params), lambda t: to(batches[t]),
                           LoopConfig(num_steps=steps, log_every=1), num_chains=K, sampler=samp)
        if dev == "cuda" and launches["fused_ec_update"] != steps * n_leaves:
            raise AssertionError(f"SMOKE training launched fused_ec_update "
                                 f"{launches['fused_ec_update']} times, not {steps * n_leaves}")
        out[dev] = (p, s, h)
    diffs = {}
    for name, get in (("params", lambda o: o[0]), ("momentum", lambda o: o[1].momentum),
                      ("center", lambda o: o[1].center)):
        diffs[name] = max((a.cpu() - b).abs().max().item()
                          for a, b in zip(tree_leaves(get(out["cuda"])), tree_leaves(get(out["cpu"]))))
    nll = [(a["nll_per_token"], b["nll_per_token"]) for a, b in zip(out["cuda"][2], out["cpu"][2])]
    log(f"[smoke-train] SMOKE f32 K={K}, {steps} steps, fused, parity noise: card vs CPU max diff "
        f"params {diffs['params']:.3e}, momentum {diffs['momentum']:.3e}, center "
        f"{diffs['center']:.3e} (atol {SMOKE_TRAIN_ATOL}); nll per step card/CPU {nll}")
    if max(diffs.values()) > SMOKE_TRAIN_ATOL:
        raise AssertionError("SMOKE training on the card disagrees with the CPU")


TRAIN_CLASSES = (  # (label, substrings of a device kernel's name), first match wins
    ("fused EC kernel", ("ec_update",)),
    ("GEMM", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas", "splitKreduce")),
    ("copies and casts", ("copy",)),
)


def phase_train(torch, card, adaptive=False):
    """qwen3-0.6b at full width, K = 4 chains, 8 steps through
    train.loop.run in production mode: fused EC-SGHMC (``[train]``), or
    with ``adaptive`` fused scale-adapted EC-SGHMC across its burn-in
    freeze (``[train-adaptive]``); then 2 profiled steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, core
    from repro_torch.data import chain_batches, synthetic_token_stream
    from repro_torch.diagnostics import chain_center_rms
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import default_sampler
    from repro_torch.models import get_model, tree_leaves
    from repro_torch.train import LoopConfig, loop, make_train_step

    label = "train-adaptive" if adaptive else "train"
    kernel = "fused_precond_ec_update" if adaptive else "fused_ec_update"
    cfg = configs.get_config("qwen3-0.6b")
    model = get_model(cfg)
    K = configs.EC_CHAINS["qwen3-0.6b"]
    log(f"[{label}] device memory before the phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    params = stacked_members(torch, cfg, model, K, "cuda", seed0=300)
    if adaptive:
        samp = core.scale_adapted_ec_sghmc(step_size=1e-6, alpha=1.0, friction=1.0,
                                           center_friction=1.0, sync_every=4,
                                           burnin=ADAPTIVE_BURNIN, decay=0.99, fused=True,
                                           state_dtype=cfg.param_dtype)
    else:
        samp = default_sampler(cfg, "qwen3-0.6b", K, sync_every=4, fused=True, step_size=1e-6)
    state = samp.init(params)
    stream = synthetic_token_stream(cfg.vocab_size, seed=0, device="cuda")
    batch_fn = lambda t: chain_batches(stream, t, K, 4, 64)
    step = make_train_step(cfg, model, samp, TRAIN_N_DATA)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params, state, hist = loop.run(step, params, state, batch_fn,
                                   LoopConfig(num_steps=TRAIN_STEPS, log_every=1, seed=0),
                                   num_chains=K, sampler=samp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(tree_leaves(params))
    for m in hist:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite metric or stat at step {m['step']}: {m}")
    nll0 = hist[0]["nll_per_token"]
    walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"] for a, b in zip(hist, hist[1:])]
    steady = (hist[-1]["wall_s"] - hist[0]["wall_s"]) / max(len(hist) - 1, 1)
    rms = chain_center_rms(params, state.center).item()
    mom = sum(torch.sum(x.float() ** 2).item() for x in tree_leaves(state.momentum)) ** 0.5
    name = "scale-adapted EC-SGHMC" if adaptive else "EC-SGHMC"
    log(f"[{label}] qwen3-0.6b full width, K={K}, {name}, batch 4 x 64 per chain, sync every 4, "
        f"eps 1e-6{f', burnin {ADAPTIVE_BURNIN}, decay 0.99' if adaptive else ''}, "
        f"{TRAIN_STEPS} steps in {wall:.2f} s; per step {['%.3f' % w for w in walls]} s; steady "
        f"{steady:.3f} s/step = {1 / max(steady, 1e-9):.3f} steps/s; peak device memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    log(f"[{label}] nll per token by step {[round(m['nll_per_token'], 4) for m in hist]} "
        f"(ln V = {math.log(cfg.vocab_size):.3f}); chain_center_rms by step "
        f"{[float('%.4g' % m['chain_center_rms']) for m in hist]}; momentum norm {mom:.4g}; "
        f"launches {counts}")
    if abs(nll0 - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"first step's nll {nll0} is not within 1.5 of ln V")
    if counts[kernel] != TRAIN_STEPS * n_leaves:
        raise AssertionError(f"{kernel} launched {counts[kernel]} times, not {TRAIN_STEPS * n_leaves}")
    if not (mom > 0 and math.isfinite(rms) and rms > 0
            and all(m["chain_center_rms"] > 0 for m in hist[3:])):
        raise AssertionError("momentum or chain spread is zero after the first sync")
    v_means = None
    if adaptive:
        # V̂ adapts on steps 1..burnin and is frozen after
        v_means = [m["precond_v_mean"] for m in hist]
        log(f"[{label}] precond_v_mean by step {['%.9g' % v for v in v_means]}")
        moving, frozen = v_means[:ADAPTIVE_BURNIN], v_means[ADAPTIVE_BURNIN - 1:]
        if len(set(moving)) != len(moving) or len(set(frozen)) != 1:
            raise AssertionError(f"V̂ did not adapt for {ADAPTIVE_BURNIN} steps and then freeze")

    # where a step's time goes: 2 more steps under the profiler, against
    # the wall clock of 2 unprofiled steps
    def two_steps(start):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop.run(step, params, state, lambda s: batch_fn(start + s),
                 LoopConfig(num_steps=2, log_every=0, seed=1), num_chains=K)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    wall2 = two_steps(100)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        two_steps(200)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    (OUT / f"{label.replace('-', '_')}_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    split = {}
    if device_us > 0:
        for e in kernels:
            lab = next((lab for lab, keys in TRAIN_CLASSES if any(k in e.key for k in keys)),
                       "other elementwise and reductions")
            split[lab] = split.get(lab, 0.0) + e.self_device_time_total
        log(f"[{label}-profile] 2 steps: wall {wall2:.3f} s without the profiler, device kernels "
            f"{device_us / 1e6:.3f} s = {100 * device_us / 1e6 / wall2:.1f}% busy, "
            f"{sum(e.count for e in kernels)} kernels [{card}]")
        for lab, us in sorted(split.items(), key=lambda kv: -kv[1]):
            log(f"[{label}-profile]   {100 * us / device_us:5.1f}%  {us / 1e3:9.3f} ms  {lab}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[{label}-profile]   {100 * e.self_device_time_total / device_us:5.1f}%  "
                f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:80]}")
    else:
        log(f"[{label}-profile] torch.profiler recorded no device time: busy share not measured")
    del params, state, samp, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(wall=wall, steady=steady, peak=peak, nll0=nll0, device_us=device_us,
                        wall2=wall2, split=split, v_means=v_means,
                        nll=[m["nll_per_token"] for m in hist])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)

    card = card_line()
    log(f"[device] nvidia-smi: {card}; torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 off")

    secs = _build.build_all()
    (OUT / "build_log.txt").write_text(
        "\n".join(f"=== {n} ===\n{t}" for n, t in _build.build_log.items()))
    log(f"[build] {len(_build.SOURCES)} kernels built in {secs:.2f} s into {_build.BUILD_DIR}")

    from repro_torch import configs

    qwen = configs.get_config("qwen3-0.6b")
    flash = phase_flash(torch, ops, ref, F)
    paged = phase_paged(torch, ops, ref)
    bma = phase_bma(torch, ops, ref)
    fused = phase_fused_ec(torch, ops, ref, qwen)
    precond = phase_fused_precond(torch, ops, ref, qwen)
    phase_philox(torch, ops, ref, qwen)
    phase_stationary(torch)
    phase_stationary_precond(torch)
    phase_smoke_engine(torch)
    phase_smoke_train(torch)
    counts, per_tick = phase_slice(torch, card)
    log(f"[slice] launches per decode tick: {per_tick} (flash: once per layer per member per admit)")
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train = phase_train(torch, card)
    counts["fused_ec_update"] = train_counts["fused_ec_update"]
    adaptive_counts, train_adaptive = phase_train(torch, card, adaptive=True)
    counts["fused_precond_ec_update"] = adaptive_counts["fused_precond_ec_update"]

    f128 = next(r for r in flash if r["S"] == 128)
    bg = next(r for r in bma if r["mode"] == "probs" and r["T"] == 0.0)
    entries = [
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:30", f128),
        ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:37", paged),
        ("bma_select", "src/repro_torch/kernels/csrc/bma_select.cu",
         "src/repro/kernels/bma_select.py:42", bg),
        ("fused_ec_update", "src/repro_torch/kernels/csrc/fused_ecsghmc.cu",
         "src/repro/kernels/fused_ecsghmc.py:54", fused),
        ("fused_precond_ec_update", "src/repro_torch/kernels/csrc/fused_ecsghmc.cu",
         "src/repro/kernels/fused_ecsghmc.py:156", precond),
    ]
    kernels = [
        {"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": counts[n],
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for n, src, rep, r in entries
    ]
    (OUT / "result.json").write_text(json.dumps({"card": card, "kernels": kernels,
                                                  "flash": flash, "paged": paged, "bma": bma,
                                                  "fused_ec": fused, "fused_precond": precond,
                                                  "train": train,
                                                  "train_adaptive": train_adaptive},
                                                 indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
