#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports torch, numpy and repro_torch only, and:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the three CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` (one nvcc per source, in parallel);
3. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes, and times kernel, plain version and (flash) the
   PyTorch library call, beside the least time the card could take;
4. serves the K=4-member Bayesian ensemble of qwen3-0.6b at full width
   (random weights from seeded generators) through ``ServeEngine.run`` on
   the paged path with all three kernels, greedily and at T=0.7/top-k 50,
   checks every request, the launch counters and agreement with the dense
   engine, and holds the whole engine on the card against the CPU at the
   SMOKE size;
5. profiles a short paged run with torch.profiler (device time by kernel
   class, the device's busy share of the unprofiled wall clock);
6. prints one JSON line per kernel, the card line, and the result line.

TF32 is off for matmuls and cuDNN (``allow_tf32 = False``), so f32
products are full f32.  Any failure raises and exits non-zero; without
CUDA it exits 2 and prints no result.  Long output (nvcc's build log, the
profile table, the full JSON result) goes to ``build/chip_smoke/``.
"""
from __future__ import annotations

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
    counts = dict(launches)
    log(f"[slice] launches on the paged greedy run: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {counts}")

    reset_launches()
    serve(True, SamplingParams(temperature=0.7, top_k=50), "paged T=0.7 top_k=50")
    log(f"[slice] launches on the sampled run: {dict(launches)}")
    if min(launches.values()) <= 0:
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
        if dev == "cuda" and min(launches.values()) <= 0:
            raise AssertionError(f"smoke engine on the card missed a kernel: {dict(launches)}")
    diff = max(float(np.abs(a.logprobs - b.logprobs).max())
               for a, b in zip(reps["cpu"].results, reps["cuda"].results))
    same = all((a.tokens == b.tokens).all() for a, b in zip(reps["cpu"].results, reps["cuda"].results))
    log(f"[smoke-engine] SMOKE f32, paged, flash on: card vs CPU tokens equal={same}, "
        f"logp max diff {diff:.3e} (atol {SMOKE_LOGP_ATOL})")
    if not (same and diff <= SMOKE_LOGP_ATOL):
        raise AssertionError("engine on the card disagrees with the CPU at the SMOKE size")


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

    flash = phase_flash(torch, ops, ref, F)
    paged = phase_paged(torch, ops, ref)
    bma = phase_bma(torch, ops, ref)
    phase_smoke_engine(torch)
    counts, per_tick = phase_slice(torch, card)
    log(f"[slice] launches per decode tick: {per_tick} (flash: once per layer per member per admit)")

    f128 = next(r for r in flash if r["S"] == 128)
    bg = next(r for r in bma if r["mode"] == "probs" and r["T"] == 0.0)
    entries = [
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:30", f128),
        ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:37", paged),
        ("bma_select", "src/repro_torch/kernels/csrc/bma_select.cu",
         "src/repro/kernels/bma_select.py:42", bg),
    ]
    kernels = [
        {"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": counts[n],
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for n, src, rep, r in entries
    ]
    (OUT / "result.json").write_text(json.dumps({"card": card, "kernels": kernels,
                                                  "flash": flash, "paged": paged, "bma": bma},
                                                 indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
