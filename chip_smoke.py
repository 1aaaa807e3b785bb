#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports torch, numpy and repro_torch only, and:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the five CUDA sources from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` (one nvcc per source, in parallel);
3. reports each kernel's ptxas registers, shared memory and spills and
   the HMMA count of flash_attention's SASS (failing on a spill in either
   attention kernel or on no HMMA), then holds each kernel against its
   plain PyTorch version on the card at its main path's shapes, and times
   kernel, plain version and (flash) the PyTorch library call, by CUDA
   events and (attention) by device time per launch, beside the least time
   the card could take: flash at qwen3's head_dim 128 (S 64, ragged 100,
   128, and softcap 50 at 128) and at recurrentgemma's 256
   (``[flash256]``, window 2048 and 16), paged decode at the path's shape,
   with ragged lengths, a done slot and a window, and in f32, the select
   kernel at both vocabularies in both modes, greedy, at T=0.7/top-k 50,
   with forced ties at the threshold, at top-k 128 (its candidate
   capacity), 200 and V, and on a flat row (``[bma]``, ``[bma256k]``), and
   the RG-LRU scan
   bit for bit up to a 32k-token prompt, with an R that is not made of
   16-byte pieces, and with f16 and mixed-dtype inputs, and its backward
   kernel bit for bit (da, dx, dh0) at the training path's (4, 64, 2560),
   at (1, 4096, 2560) and at R 77, with and without h0, directly and
   through ``torch.autograd.grad`` (``[rglru]``); the
   select and scan rows also by device time per call; and the text
   families' shapes: flash at h2o-danube's d 80, at gemma3's 1536-token
   prompt under its window of 1024, at grok's G 6 with softcap 30, at
   whisper's decoder prefill (B 4, S 16, 8 heads of 64); paged decode at
   olmoe's G 1 and grok's G 6 with softcap 30; the select kernel greedy at
   V 32,000, 50,304, 131,072 and 262,144 (K 4) and 152,064 (qwen2-vl's
   K 2);
4. the sampler: holds the fused kernel against its plain version bit for
   bit at every leaf shape of the paper's MLP and ResNet-32 at K = 6, in
   both noise modes, with each shape's time beside its bound, checks the
   fused EC-SGHMC kernel's in-kernel Philox noise
   against N(0, 1) over the 2.38e9 elements of a qwen3-0.6b K=4 step, runs
   fused EC-SGHMC and Async SGHMC (s = 1 and 4) on a Gaussian target
   against their exact stationary oracles, and holds SMOKE training
   (``train.loop.run``) on the card against the CPU;
5. serves the K=4-member Bayesian ensemble of qwen3-0.6b at full width
   (random weights from seeded generators) through ``ServeEngine.run`` on
   the paged path with the three serving kernels, greedily, checks every
   request, the launch counters and agreement
   with the dense engine, holds the whole engine on the card against the
   CPU at the SMOKE size, and profiles a short paged run with
   torch.profiler (device time by kernel class, the device's busy share of
   the profiled run's wall clock, bma_select's device time per tick);
6. trains K=4 chains of qwen3-0.6b at full width for 8 EC-SGHMC steps
   through ``train.loop.run`` with the fused kernel, checks the metrics,
   the launch count and the chains' spread, and profiles two more steps;
7. the adaptive tier: holds the preconditioned Eq. 6 kernel against its
   plain version and against the scalar-mass kernel at M^-1 == 1, runs
   fused scale-adapted EC-SGHMC with a known frozen M^-1 on a Gaussian
   target against the exact oracle, and trains the same K=4 qwen3-0.6b
   chains for 8 scale-adapted EC-SGHMC steps across the burn-in freeze,
   then profiles two more; then trains K=2 chains of recurrentgemma-2b
   at its published widths cut to one 3-layer (rglru, rglru, attn) period
   for 8 fused EC-SGHMC steps, through the scan kernel and its backward
   (exact launches, finite nll, peak memory, the step's model-FLOPs share
   of ``repro_torch.roofline.HW``'s bf16 peak), holds SMOKE hybrid
   training on the card against the CPU and runs ``launch.train.main
   --arch recurrentgemma-2b --smoke`` (``[train-hybrid]``);
8. serves the K=4-member ensemble of recurrentgemma-2b at full width
   (``[slice-hybrid]``) through ``ServeEngine.run`` on the dense engine
   (paged is refused for RG-LRU layers), greedily, checks the launch counts of the scan, flash and bma_select kernels,
   profiles a short run, and holds the SMOKE hybrid engine on the card
   against the CPU;
9. the rest of the text families: h2o-danube-1.8b at full width and
   depth (K = 4), gemma2-27b and gemma3-27b at their published widths cut
   to 8 layers (K = 2) on the dense engine (``[slice-dense]``), greedily
   over 8 requests of 16 new tokens, with exact launch counts, paged
   refused, and gemma3's published window held with a 1536-token prompt
   in f32 (the flash engine against the plain one); olmoe-1b-7b at full
   width and depth (K = 4) and grok-1-314b at its published width cut to 2
   layers (K = 1) on the paged engine (``[slice-moe]``), greedy and (olmoe)
   at T=0.7/top-k 50, with exact launch counts; each SMOKE engine on the
   card against the CPU, and SMOKE olmoe training (the MoE backward);
10. every other architecture of the reference: xlstm-350m at full width
   cut to one period of 7 mLSTM and 1 sLSTM block (of 24 layers), K = 4
   (``[slice-xlstm]``), and
   qwen2-vl-7b (M-RoPE) at full width and depth in bf16, K = 2
   (``[slice-vlm]``), on the dense engine over ``[slice-dense]``'s trace
   with exact launch counts (bma_select only: no attention layer, and
   M-RoPE keeps the plain prefill), paged refused, and one full-width
   qwen2-vl prefill of 64 patch embeddings and 64 text tokens on 3-stream
   positions; whisper-base at full width and depth with K = 4 through
   ``launch.serve.main``'s ensemble path and ``ensemble_decode`` (flash
   once per decoder layer per member, ``[slice-audio]``); each with its
   SMOKE serving path and SMOKE training on the card against the CPU;
11. serving meets sampling: ``launch.serve.main`` at full-width qwen3-0.6b
   with K = 4 and overlapped live refresh, then its ensemble path
   (``[serve-launch]``); the ``[slice]`` engine and 8 of its trace's
   requests frozen, with the sync ``ChainRefresher`` and with the
   overlapped ``RefreshScheduler`` on a side CUDA stream, holding each
   overlapped run's final chain stack against the
   sync one's bit for bit (``[refresh]``), and fed by fused EC-SGHMC
   (``[refresh-ec]``); checkpointed training preempted and
   resumed bit for bit, a timed save/restore, a truncated checkpoint and
   an elastic restore (``[ckpt]``); ``launch.train.main`` at full width
   (``[launch-train]``);
12. the paper's own experiments: Fig. 1's seeds as swept runs
   (``ChainExecutor.run(..., sweep=True)``), each held bitwise against its
   member run (``[sweep]``); the MLP and ResNet-32 at a small width, fused
   EC-SGHMC and Async SGHMC with the noise handed in, on the card against
   the CPU (``[smoke-paper]``); and Fig. 2 at the paper's widths through
   ``ChainExecutor`` and ``ShardedLoader``: the 2x800 MLP on synthetic
   MNIST (SGHMC, and K = 6 fused EC-SGHMC and Async SGHMC at s = 1 and 8,
   500 steps, ``[paper-mlp]``) and ResNet-32 at width 16 on synthetic
   CIFAR-10 (SGHMC and fused EC-SGHMC at s = 4, 240 steps,
   ``[paper-resnet]``), with the predictive and BMA NLL on the test set at
   every evaluation and the kernel's launches per job;
13. chains across ranks: the int8 center-exchange codec at the size of the
   full-width exchange, the card's bytes equal to the CPU port's, with
   encode and decode times against the byte bound (``[codec]``, after
   ``[philox]``, which also holds the kernel's ``chain_offset`` against
   the unsplit launch); ``[train]``'s configuration through
   ``ChainExecutor.run_sharded`` on a one-rank NCCL mesh, raw and with the
   int8 exchange, against ``run`` bit for bit under
   ``torch.use_deterministic_algorithms(True)``, with the collective
   counter read around each run (``[shard]``); two gloo ranks spawned on
   the one card at the SMOKE size against a single-process run
   (``[shard-2rank]``); and compressed parking on the full-width paged
   engine (``[park]``);
14. serving across ranks (``[serve-mesh]``): the full-width K=4 qwen3-0.6b
   ensemble through ``ServeEngine(mesh=make_engine_mesh(1, 1))`` on a
   one-rank NCCL group, dense and paged, bit for bit the unsharded engine
   with the same launches and exact collectives per tick and admit; two
   gloo ranks on the one card on a (2, 1) mesh, each serving two members,
   with the unsharded tokens; and the same two ranks under overlapped
   refresh by fused EC-SGHMC chains, every rank at the same registry
   version at every tick; ``[serve-launch]`` and ``[refresh-ec]`` export
   their traces, which ``repro_torch.obs.validate`` checks (profiles
   ``serve`` and ``serve_ec``);
15. the dry run (``[dryrun]``): each kernel's ``torch.library`` form on the
   card against its plain version and under ``FakeTensorMode`` (the real
   call's output shapes, no launch); qwen3-0.6b and recurrentgemma-2b at
   full width on train_4k and decode_32k traced by
   ``launch.dryrun.run_cell`` on the 256-rank fake world (per-device
   arguments, peak, collectives, FLOPs and trace time printed as
   predictions for the card); and four cells one card holds (both archs,
   train and decode, recurrentgemma's train cut to 3 layers), each
   predicted on a one-rank fake world and run for real on a one-rank NCCL
   mesh, the predicted peak within ``DRYRUN_RTOL`` of the measured
   ``max_memory_allocated``; the fake worlds run in processes of their
   own, beside a spawned rank for the real runs;
16. prints one JSON line of the seven kernels (the six ported Pallas kernels
   and the scan's backward, with each kernel's launches on each of its
   paths), the card line, and the result line.

Every bound is the larger of bytes over the HBM rate and operations over
the peak rate of their type, both from ``repro_torch.roofline.HW``.

TF32 is off for matmuls and cuDNN (``allow_tf32 = False``), so f32
products are full f32.  The caching allocator runs with expandable
segments (``PYTORCH_CUDA_ALLOC_CONF``, unless the caller set it), and
cuBLAS with the deterministic workspace (``CUBLAS_WORKSPACE_CONFIG``).  Any failure raises and exits non-zero; without
CUDA it exits 2 and prints no result.  Long output (nvcc's build log, the
profile table, the full JSON result) goes to ``build/chip_smoke/``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"


FLASH_ATOL = 2e-2  # bf16 output: a few bf16 ulps at |o| ~ 1
PAGED_ATOL = 2e-2
BMA_LOGP_ATOL = 1e-4  # f32 logsumexp over up to 256000 terms in another order
SLICE_FIRST_LOGP_ATOL = 1e-3  # paged vs dense engine, first token's mixture row
# [slice]'s dense run: the prefill's token and one decode tick, all that
# its check reads (a whole 32-token run cost ~20-30 s of the time limit)
SLICE_DENSE_NEW = 2
SMOKE_LOGP_ATOL = 1e-4  # whole engine, card vs CPU, f32 SMOKE config
# The SMOKE qwen2-vl engine (no qk-norm, theta 1e6) is 1.5e-4 from an f64 run
# on the CPU (scripts/torch_f64_distance.py; qwen3 4.8e-7, h2o-danube 2.7e-5):
# the card and the CPU may each be that far, so it gets twice that beyond
# SMOKE_LOGP_ATOL
SMOKE_LOGP_EXTRA = {"qwen2-vl-7b": 3.0e-4}
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


def card_peaks() -> dict:
    """The card's peak rates: ``repro_torch.roofline.analytic.HW``, the one
    table of the port's bounds (H100 SXM: HBM 3.35 TB/s, dense bf16 989
    TFLOP/s, f32 outside the tensor cores 67 TFLOP/s)."""
    from repro_torch.roofline.analytic import HW

    return HW


def bound(nbytes: float, flops: float, rate: str) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of device memory traffic and
    ``flops`` operations at the ``rate`` ("bf16" or "f32") peak."""
    hw = card_peaks()
    tb, tf = nbytes / hw["hbm_bw"] * 1e3, flops / hw[f"peak_flops_{rate}"] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def device_kernels(prof) -> list:
    """The device-side events (kernels, copies, sets) of a torch.profiler
    run, aggregated by name, as objects with the fields of ``key_averages``
    that the phases read: ``key``, ``count`` and ``self_device_time_total``
    (us).  Read from the profiler's own event list: ``key_averages`` took a
    minute over the ~350k kernels of a serving profile."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            count, ns = agg.get(e.name(), (0, 0))
            agg[e.name()] = (count + 1, ns + e.duration_ns())
    return [types.SimpleNamespace(key=k, count=c, self_device_time_total=ns / 1e3)
            for k, (c, ns) in agg.items()]


def device_busy(prof) -> tuple[float, int]:
    """(us of the union of the device events' intervals, streams they ran
    on) of a torch.profiler run: the time the device was busy, which the
    summed event times overstate when events on two streams overlap."""
    from torch.autograd import DeviceType

    spans, streams = [], set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            spans.append((e.start_ns(), e.end_ns()))
            streams.add(e.device_resource_id())
    busy_ns, lo, hi = 0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            busy_ns += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy_ns += 0 if hi is None else hi - lo
    return busy_ns / 1e3, len(streams)


def kernel_table(kernels, rows: int = 60) -> str:
    """The ``rows`` kernels with the most device time, one line each."""
    total = sum(e.self_device_time_total for e in kernels) or 1.0
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]
    return "\n".join(f"{100 * e.self_device_time_total / total:6.2f}%  "
                     f"{e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<8d} {e.key}"
                     for e in top)


def device_ms(torch, fn, reps: int = 20, warmup: int = 3, split=None):
    """Device time of one ``fn()``: the summed device time of every kernel
    it launches over ``reps`` calls under torch.profiler, over ``reps``.
    Unlike ``time_ms`` it leaves out the launch from Python.  None when the
    profiler records no device time.  ``split``, a dict, receives the ms
    per call of each kernel, keyed by the name's first word matching it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a profiler window now and then records no kernel; take a second
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        us = sum(e.self_device_time_total for e in kernels)
        if us > 0:
            if split is not None:
                import re

                for e in kernels:
                    m = re.search(r"(\w+)<", e.key)
                    name = m.group(1) if m else e.key[:40]
                    split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
            return us / 1e3 / reps
    return None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def build_report(build_log: dict, libs: dict) -> tuple[str, dict]:
    """Per library, each kernel's ptxas report (registers, static shared
    memory, spill bytes) from nvcc's ``-Xptxas -v`` output, and the count of
    tensor-core (HMMA) instructions in its SASS (``cuobjdump -sass``)."""
    import re
    import shutil

    def demangle(names):
        filt = shutil.which("c++filt")
        if not filt or not names:
            return names
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        return out.stdout.splitlines() if out.returncode == 0 else names

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lines, report = [], {}
    for lib, text in build_log.items():
        fns, cur = [], None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = dict(fn=m.group(1), regs=None, smem=0, spill=0)
                fns.append(cur)
            elif cur is not None:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    cur["spill"] = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    cur["regs"] = int(m.group(1))
                    sm = re.search(r"(\d+) bytes smem", line)
                    cur["smem"] = int(sm.group(1)) if sm else 0
        for f, name in zip(fns, demangle([f["fn"] for f in fns])):
            f["fn"] = name
        hmma = None
        if lib in libs:
            sass = subprocess.run([cuobjdump, "-sass", str(libs[lib])], capture_output=True,
                                  text=True)
            if sass.returncode == 0:
                hmma = sum("HMMA" in ln for ln in sass.stdout.splitlines())
        report[lib] = dict(functions=fns, hmma=hmma)
        lines.append(f"--- {lib}: {len(fns)} kernels, HMMA instructions in SASS: "
                     f"{'not read' if hmma is None else hmma}")
        lines += [f"  regs {f['regs']:>3}  smem {f['smem']:>6} B  spill {f['spill']:>4} B  {f['fn']}"
                  for f in fns]
    return "\n".join(lines), report


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

FLASH_CASES = ((64, None, None), (100, None, None), (128, None, None),
               (128, None, 50.0))  # (S, window, softcap): ragged S = 100; gemma2's softcap 50
FLASH256_CASES = ((64, 2048, None), (128, 2048, None), (128, 16, None))
# the model families' prefill shapes, (B, Hq, Hkv, d, cases): h2o-danube's
# d 80 (padded to 128) under its window; gemma3's local window of 1024 at a
# 1536-token prompt (32 q over 16 kv heads); grok's softcap 30 at G 6;
# whisper's decoder prefill (4 prompts of 16 tokens, 8 heads of 64, G 1)
FLASH_FAMILY_CASES = ((1, 32, 8, 80, ((128, 4096, None),)),
                      (1, 32, 16, 128, ((1536, 1024, None),)),
                      (1, 48, 8, 128, ((128, None, 30.0),)),
                      (4, 8, 8, 64, ((16, None, None),)))


def phase_flash(torch, ops, ref, F, *, B=1, Hq=16, Hkv=8, d=128, cases=FLASH_CASES,
                label="flash", seed=11):
    """The flash kernel against its plain version at a model's prefill
    shapes, one row for each (S, window, softcap) of ``cases`` (qwen3-0.6b
    by default; ``[flash256]`` is recurrentgemma-2b's head_dim 256 with MQA
    and its window, and a window shorter than S), timed beside SDPA and the
    bound, by CUDA events and by device time per launch.  SDPA gets the
    causal flag where the window cuts nothing, else the same causal band as
    a boolean mask; it has no softcap, so a softcap row has no library
    time.  A head dim the kernel does not instantiate (h2o-danube's 80) is
    timed on inputs zero-padded as ``ops.flash_attention`` pads them."""
    import repro_torch.kernels.flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for S, window, softcap in cases:
        q = torch.randn((B, Hq, S, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, Hkv, S, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, Hkv, S, d), generator=g, device="cuda").to(torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        kw = dict(causal=True, window=window, softcap=softcap, scale=scale)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not (err <= FLASH_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"{label} S={S} window={window} softcap={softcap}: "
                                 f"max|kernel - plain| = {err} > {FLASH_ATOL}")
        dp = ops._padded_head_dim(d, ops.FLASH_HEAD_DIMS)
        qp, kp, vp = (ops._pad_last(t, dp) for t in (q, k, v))
        out = torch.empty_like(qp)
        kernel = lambda: fa.launch(qp, kp, vp, out, **kw)  # noqa: E731
        ms, dev = time_ms(torch, kernel), device_ms(torch, kernel)
        plain = time_ms(torch, lambda: ref.attention(q, k, v, **kw))
        pos = torch.arange(S, device="cuda")
        lag = pos[:, None] - pos[None, :]
        band = (lag >= 0) & (lag < (window if window is not None else S))
        lib = lib_dev = None
        if softcap is None:
            sdpa = dict(is_causal=True) if window is None or window >= S else dict(attn_mask=band)
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, scale=scale, enable_gqa=True, **sdpa)
            lib, lib_dev = time_ms(torch, library), device_ms(torch, library)
        pairs = int(band.sum().item())  # (query, key) pairs inside the causal band
        nbytes = 2 * (2 * B * Hq * S * d + 2 * B * Hkv * S * d)
        flops = 4 * B * Hq * d * pairs  # QK^T and PV over the band
        b_ms, b_by = bound(nbytes, flops, "bf16")
        log(f"[{label}] B={B} Hq={Hq} Hkv={Hkv} S={S} d={d} window={window} softcap={softcap} "
            f"bf16: max_abs_err={err:.3e} (atol {FLASH_ATOL}) kernel {ms:.4f} ms (device "
            f"{fmt_ms(dev)}), plain {plain:.4f} ms, sdpa {fmt_ms(lib)} (device {fmt_ms(lib_dev)}), "
            f"bound {b_ms:.5f} ms ({b_by})")
        rows.append(dict(B=B, Hq=Hq, Hkv=Hkv, d=d, S=S, window=window, softcap=softcap, err=err,
                         ms=ms, device_ms=dev,
                         plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def paged_inputs(torch, g, *, B, Hkv, G, d, bs, M, ctx, dtype, done_slots=()):
    """A paged pool of P = B*M + 1 pages (page 0 the sink), each slot's
    table row a permutation of the rest; ``done_slots`` get ctx 0 and a row
    of zeros, as the engine leaves a finished slot."""
    P = B * M + 1
    q = torch.randn((B, Hkv, G, d), generator=g, device="cuda").to(dtype)
    kp = torch.randn((P, bs, Hkv, d), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, bs, Hkv, d), generator=g, device="cuda").to(dtype)
    perm = np.random.default_rng(12).permutation(np.arange(1, P)).astype(np.int32).reshape(B, M)
    ctx = np.asarray(ctx, np.int32)
    for s in done_slots:
        perm[s], ctx[s] = 0, 0
    return (q, kp, vp, torch.tensor(perm, device="cuda"), torch.tensor(ctx, device="cuda")), ctx


# (label, dtype, context lengths, window): the serving path's shape (8 slots
# x 8 kv heads, G = 2, d = 128, 16-key pages, max_seq 160); ragged lengths
# with a done slot (ctx 0 on the sink page) under a window shorter than the
# context; the same in f32, the SMOKE configs' dtype
PAGED_CASES = (("path", "bfloat16", np.linspace(1, 159, 8).astype(np.int32), None),
               ("ragged, window 40", "bfloat16", [0, 3, 15, 16, 47, 90, 131, 159], 40),
               ("path f32", "float32", np.linspace(1, 159, 8).astype(np.int32), None))
# the MoE family's decode shapes, (Hkv, G, softcap, cases): olmoe is MHA
# (16 q over 16 kv heads, G 1); grok has 48 q over 8 kv heads (G 6) and a
# softcap of 30; both at the slice's context lengths
PAGED_MOE_CASES = (
    (16, 1, None, (("olmoe G=1", "bfloat16", np.linspace(1, 143, 8).astype(np.int32), None),)),
    (8, 6, 30.0, (("grok G=6 softcap 30", "bfloat16", np.linspace(1, 143, 8).astype(np.int32),
                   None),)))


def phase_paged(torch, ops, ref, *, Hkv=8, G=2, softcap=None, cases=PAGED_CASES, seed=12):
    """The paged-decode kernel against its plain version at every row of
    ``cases`` (the qwen3 serving path's heads by default), timed by CUDA
    events and by device time per launch; the first default row is the
    kernel's entry in the result line."""
    import repro_torch.kernels.paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, d, bs, M = 8, 128, 16, 10
    rows = []
    for label, dtype, ctx_in, window in cases:
        (q, kp, vp, tables, ctx), ctx_np = paged_inputs(
            torch, g, B=B, Hkv=Hkv, G=G, d=d, bs=bs, M=M, ctx=ctx_in,
            dtype=getattr(torch, dtype), done_slots=(0,) if window else ())
        scale = 1.0 / math.sqrt(d)
        kw = dict(scale=scale, window=window, softcap=softcap)
        got = ops.paged_attention(q, kp, vp, tables, ctx, **kw)
        want = ref.paged_attention(q, kp, vp, tables, ctx, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not (err <= PAGED_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"paged {label}: max|kernel - plain| = {err} > {PAGED_ATOL}")
        out = torch.empty_like(q)
        kernel = lambda: pa.launch(q, kp, vp, tables, ctx, out, **kw)  # noqa: E731
        ms, dev = time_ms(torch, kernel), device_ms(torch, kernel)
        plain = time_ms(torch, lambda: ref.paged_attention(q, kp, vp, tables, ctx, **kw))
        c = ctx_np.astype(np.int64)
        keys = int((np.minimum(c + 1, window) if window else c + 1).sum())
        isz = q.element_size()
        nbytes = 2 * keys * Hkv * d * isz + 2 * isz * B * Hkv * G * d + 4 * B * M + 4 * B
        flops = 4 * keys * Hkv * G * d
        b_ms, b_by = bound(nbytes, flops, "bf16" if isz == 2 else "f32")
        log(f"[paged] {label}: slots={B} Hkv={Hkv} G={G} d={d} bs={bs} ctx={ctx_np.tolist()} "
            f"window={window} softcap={softcap} {dtype}: max_abs_err={err:.3e} (atol {PAGED_ATOL}) kernel "
            f"{ms:.4f} ms (device {fmt_ms(dev)}), plain {plain:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by})")
        rows.append(dict(case=label, Hkv=Hkv, G=G, softcap=softcap, dtype=dtype, window=window,
                         err=err, ms=ms, device_ms=dev,
                         plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


# phase_bma's rows: (label, T, top_k, logits).  The first two are the
# serving paths; then many exact duplicates at the k-th value ("tied"), top_k
# at the kernel's candidate capacity (KCAP = 128), above it (the radix
# passes), top_k = V (everything kept), and a row of equal logits ("flat":
# every element ties at the threshold; the kernel lists one per warp).
BMA_ROWS = (("greedy", 0.0, 0, "random"), ("T=0.7 top_k=50", 0.7, 50, "random"),
            ("ties, top_k=50", 0.7, 50, "tied"), ("top_k=KCAP", 0.7, 128, "random"),
            ("top_k=200", 0.7, 200, "random"), ("top_k=V", 0.7, -1, "random"),
            ("flat, top_k=50", 0.7, 50, "flat"))


def bma_tied_logits(torch, g, K, S, V):
    """Member logits that are a function of an integer level per (slot,
    element), so elements of one level have bit-equal mixture values: a
    rounded normal gives a few hundred elements at the level that holds
    the 50th largest."""
    level = torch.round(2.0 * torch.randn((S, V), generator=g, device="cuda"))
    w = 1.0 + 0.1 * torch.arange(K, device="cuda", dtype=torch.float32)
    return (level[None] * w[:, None, None] + 0.5 * w[:, None, None]).contiguous()


# h2o-danube, olmoe (and xlstm), grok, gemma3, qwen2-vl
BMA_FAMILY_VOCABS = (32000, 50304, 131072, 262144, 152064)
BMA_FAMILY_K = {152064: 2}  # qwen2-vl's ensemble; the others at phase_bma's K = 4


def phase_bma(torch, ops, ref, *, V=151936, K=4, label="bma", seed=13, cases=BMA_ROWS):
    """The select kernel against its plain version at K members (4 by
    default), S=8 over a
    model's vocabulary (qwen3-0.6b's by default; ``[bma256k]`` is
    recurrentgemma-2b's), in both modes, at every BMA_ROWS row: logp within
    BMA_LOGP_ATOL, tokens equal except where the plain version's top two
    selection values lie within that tolerance; timed by CUDA events and by
    device time per call (the sum of its kernels).  ``cases`` narrows the
    rows (the text families' vocabularies run the greedy row)."""
    import repro_torch.kernels.bma_select as bs_mod
    from repro_torch.serve.sampling import _top_k_mask, gumbel_noise

    g = torch.Generator(device="cuda").manual_seed(seed)
    S = 8
    inputs = {"random": 3.0 * torch.randn((K, S, V), generator=g, device="cuda"),
              "tied": bma_tied_logits(torch, g, K, S, V),
              "flat": torch.zeros((K, S, V), device="cuda")}
    gumbel = gumbel_noise((S, V), g, "cuda")
    rows = []
    for mode in ("probs", "logprobs"):
        for case, T, top_k, kind in cases:
            top_k = V if top_k < 0 else top_k
            lg = inputs[kind]
            gum = gumbel if T > 0 else None
            kw = dict(mode=mode, temperature=T, top_k=top_k)
            tok, logp = bs_mod.launch(lg, gum, **kw)
            rtok, rlogp = ref.bma_select(lg, gum, **kw)
            torch.cuda.synchronize()
            err = (logp - rlogp).abs().max().item()
            if not (err <= BMA_LOGP_ATOL and torch.isfinite(logp).all()):
                raise AssertionError(f"{label} {mode} {case}: max|logp - plain| = {err} > {BMA_LOGP_ATOL}")
            # a token may differ only where the plain version's top two
            # selection values lie within the logp tolerance
            sel = rlogp
            kept = None
            if T > 0:
                sel = rlogp / T
                if top_k:
                    sel = _top_k_mask(sel, top_k)
                    kept = torch.isfinite(sel).sum(-1)
                sel = sel + gumbel
            tol = BMA_LOGP_ATOL / (T if T > 0 else 1.0)
            ties_ok = 0
            for s in np.nonzero((tok != rtok).cpu().numpy())[0]:
                a, b = sel[s, int(tok[s])].item(), sel[s, int(rtok[s])].item()
                if not abs(a - b) <= tol:
                    raise AssertionError(f"{label} {mode} {case} slot {s}: token {int(tok[s])} vs "
                                         f"plain {int(rtok[s])}, selection gap {abs(a - b)} > {tol}")
                ties_ok += 1
            kernel = lambda: bs_mod.launch(lg, gum, **kw)  # noqa: E731
            split: dict = {}
            ms, dev = time_ms(torch, kernel), device_ms(torch, kernel, split=split)
            plain = time_ms(torch, lambda: ref.bma_select(lg, gum, **kw))
            nbytes = 4 * (K * S * V + S * V + (S * V if T > 0 else 0) + S)
            flops = 6 * K * S * V
            b_ms, b_by = bound(nbytes, flops, "f32")
            kept_s = "" if kept is None else f" kept per slot {kept.min().item()}-{kept.max().item()}"
            log(f"[{label}] K={K} S={S} V={V} mode={mode} {case} (T={T} top_k={top_k}):{kept_s} "
                f"max_abs_err={err:.3e} (atol {BMA_LOGP_ATOL}) token mismatches within "
                f"tol={ties_ok} kernel {ms:.4f} ms (device {fmt_ms(dev)}: "
                + ", ".join(f"{n} {1e3 * t:.2f} us" for n, t in split.items())
                + f"), plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            rows.append(dict(V=V, K=K, mode=mode, case=case, T=T, top_k=top_k, err=err, ms=ms,
                             device_ms=dev, device_split_ms=split, plain_ms=plain,
                             library_ms=None, bound_ms=b_ms,
                             bound_by=b_by, ties=ties_ok))
    return rows


# The RG-LRU scan's checks: (label, (B, S, R), dtype, with h0).  The first
# two are the hybrid slice's prefill shapes (recurrentgemma-2b, R = 2560);
# (1, 32768, 2560) is a 32k-token prompt; R = 77 in bf16 is not made of
# whole 16-byte pieces, so the kernel stages its tiles with plain loads.
RGLRU_CASES = [("path S=64", (1, 64, 2560), "float32", False),
               ("path S=128", (1, 128, 2560), "float32", False),
               ("batch", (4, 4096, 2560), "float32", False),
               ("32k prompt", (1, 32768, 2560), "float32", False),
               ("ragged, h0", (3, 1000, 1000), "float32", True),
               ("bf16 inputs, h0", (2, 4096, 2560), "bfloat16", True),
               ("odd R, bf16, h0", (2, 300, 77), "bfloat16", True)]


def phase_rglru(torch, ops, ref):
    """The scan kernel against its plain version on the card, bit for bit
    (max ULP 0), at every RGLRU_CASES shape; kernel time (median of 20),
    device time per launch, and the plain version's time (median of 20, of
    3 at S >= 4096) beside the byte bound.  f16 and mixed-dtype inputs
    through ``ops.rglru_scan`` (cast to f32) are bitwise too.  Then the
    backward kernel's rows (``phase_rglru_bwd``)."""
    import repro_torch.kernels.rglru as rg

    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for label, (B, S, R), dtype, with_h0 in RGLRU_CASES:
        dt = getattr(torch, dtype)
        a = (0.9 + 0.099 * torch.rand((B, S, R), generator=g, device="cuda")).to(dt)
        x = torch.randn((B, S, R), generator=g, device="cuda").to(dt)
        h0 = torch.randn((B, R), generator=g, device="cuda") if with_h0 else None
        got = ops.rglru_scan(a, x, h0)
        want = ref.rglru_scan(a, x, h0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ulp = ulp_gap(torch, got, want)
        same = torch.equal(got, want)
        if not (same and ulp == 0 and torch.isfinite(got).all()):
            raise AssertionError(f"rglru {label} {(B, S, R)}: not bitwise equal to the plain "
                                 f"version (max abs err {err}, {ulp} ULP)")
        out = torch.empty_like(got)
        kernel = lambda: rg.launch(a, x, h0, out)  # noqa: E731
        ms, dev = time_ms(torch, kernel), device_ms(torch, kernel)
        long = S >= 4096
        plain = time_ms(torch, lambda: ref.rglru_scan(a, x, h0), reps=3 if long else 20,
                        warmup=1 if long else 3)
        nbytes = (2 * a.element_size() + 4) * B * S * R + (4 * B * R if with_h0 else 0)
        b_ms, b_by = bound(nbytes, 2 * B * S * R, "f32")
        log(f"[rglru] {label} (B, S, R)={(B, S, R)} {dtype}{' + h0' if with_h0 else ''}: bitwise "
            f"equal {same}, max_abs_err={err:.3e}, max ULP {ulp:.0f}; kernel {ms:.4f} ms (device "
            f"{fmt_ms(dev)}), plain {plain:.4f} ms{' (median of 3)' if long else ''}, bound "
            f"{b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB); library: none")
        rows.append(dict(label=label, shape=(B, S, R), dtype=dtype, err=err, ulp=ulp, ms=ms,
                         device_ms=dev, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                         bound_by=b_by))
        del a, x, h0, got, want, out
    a = 0.9 + 0.099 * torch.rand((1, 64, 2560), generator=g, device="cuda")
    x = torch.randn((1, 64, 2560), generator=g, device="cuda")
    for da, dx in (("float16", "float16"), ("float32", "bfloat16"), ("float16", "float32")):
        a_, x_ = a.to(getattr(torch, da)), x.to(getattr(torch, dx))
        if not torch.equal(ops.rglru_scan(a_, x_), ref.rglru_scan(a_, x_)):
            raise AssertionError(f"rglru a {da}, x {dx}: not bitwise equal to the plain version")
    log("[rglru] (1, 64, 2560) with a/x f16/f16, f32/bf16, f16/f32 through ops.rglru_scan: "
        "bitwise equal to the plain version")
    rows += phase_rglru_bwd(torch, ops, ref, g)
    torch.cuda.empty_cache()
    return rows


# The backward's checks: (label, (B, S, R)), each with and without h0: the
# training path's shape ([train-hybrid]: 4 sequences x 64 tokens a chain),
# a 4k-token sequence, and an R of 77 that is not made of 16-byte pieces
# (the plain-load staging path).
RGLRU_BWD_CASES = [("train path", (4, 64, 2560)), ("4k", (1, 4096, 2560)),
                   ("odd R", (2, 300, 77))]


def bits_equal(torch, got, want) -> bool:
    """Bit for bit, the sign of zero included."""
    return got.dtype == want.dtype and torch.equal(got.view(torch.int32), want.view(torch.int32))


def phase_rglru_bwd(torch, ops, ref, g):
    """The backward kernel against ref.rglru_scan_bwd on the card, bit for
    bit in (da, dx, dh0), at every RGLRU_BWD_CASES shape with and without
    h0; kernel time (median of 20), device time per launch, the plain
    version's time (median of 20, of 3 at S 4096) beside the byte bound; and
    ``torch.autograd.grad`` through ``ops.rglru_scan`` bit for bit the plain
    backward's result."""
    import repro_torch.kernels.rglru as rg

    rows = []
    for label, (B, S, R) in RGLRU_BWD_CASES:
        for with_h0 in (False, True):
            a = 0.9 + 0.099 * torch.rand((B, S, R), generator=g, device="cuda")
            x = torch.randn((B, S, R), generator=g, device="cuda")
            dh = torch.randn((B, S, R), generator=g, device="cuda")
            h0 = torch.randn((B, R), generator=g, device="cuda") if with_h0 else None
            h = ref.rglru_scan(a, x, h0)
            want = ref.rglru_scan_bwd(a, h, dh, h0)
            da, dx = torch.empty_like(a), torch.empty_like(a)
            dh0 = torch.empty_like(h0) if with_h0 else None
            kernel = lambda: rg.launch_bwd(a, h, dh, h0, da, dx, dh0)  # noqa: E731
            kernel()
            torch.cuda.synchronize()
            got = (da, dx, dh0)
            same = all(bits_equal(torch, u, w) for u, w in zip(got, want) if w is not None)
            err = max((u - w).abs().max().item() for u, w in zip(got, want) if w is not None)
            leaves = [t.clone().requires_grad_(True) for t in (a, x, h0) if t is not None]
            grads = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, dh)
            through = all(bits_equal(torch, u, w) for u, w in
                          zip(grads, [w for w in want if w is not None]))
            if not (same and through and all(torch.isfinite(w).all() for w in want
                                              if w is not None)):
                raise AssertionError(f"rglru backward {label} {(B, S, R)} h0={with_h0}: kernel "
                                     f"bitwise {same}, through autograd bitwise {through}, max "
                                     f"abs err {err}")
            ms, dev = time_ms(torch, kernel), device_ms(torch, kernel)
            long = S >= 4096
            plain = time_ms(torch, lambda: ref.rglru_scan_bwd(a, h, dh, h0),
                            reps=3 if long else 20, warmup=1 if long else 3)
            # a, dh, h_0..h_{S-2} read, da and dx written; h0 read, dh0 written
            nbytes = 4 * B * R * (4 * S + S - 1) + (8 * B * R if with_h0 else 0)
            b_ms, b_by = bound(nbytes, 3 * B * S * R, "f32")
            log(f"[rglru] backward {label} (B, S, R)={(B, S, R)} f32{' + h0' if with_h0 else ''}: "
                f"bitwise equal {same} (through autograd {through}), max_abs_err={err:.3e}; kernel "
                f"{ms:.4f} ms (device {fmt_ms(dev)}), plain {plain:.4f} ms"
                f"{' (median of 3)' if long else ''}, bound {b_ms:.5f} ms ({b_by}, "
                f"{nbytes / 1e6:.2f} MB); library: none")
            rows.append(dict(label=f"backward {label}", shape=(B, S, R), dtype="float32",
                             h0=with_h0, err=err, ms=ms, device_ms=dev, plain_ms=plain,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by))
            del a, x, dh, h0, h, want, da, dx, dh0, got, leaves, grads
    return rows


# ---------------------------------------------------------------------------
# the slice: qwen3-0.6b K=4 ensemble served end to end
# ---------------------------------------------------------------------------


def stacked_members(torch, cfg, model, K, device, seed0=0):
    """K members, member k drawn from a generator seeded seed0 + k, each
    leaf written into the preallocated (K, ...) stack as soon as it is
    drawn: the values of ``init_params`` (the same draws in the same
    order), and a peak of the stack plus one leaf and its f32 draw
    (olmoe-1b-7b: 55.4 + 12.9 GB; a whole member at a time was 55.4 + 13.8
    GB plus that draw)."""
    from repro_torch.models import init_params, tree_leaves
    from repro_torch.models.common import tree_unflatten

    specs = model.param_specs(cfg)
    leaves = tree_leaves(specs)
    stack = [torch.empty((K,) + tuple(sp.shape), dtype=sp.dtype, device=device) for sp in leaves]
    for k in range(K):
        gen = torch.Generator(device=device).manual_seed(seed0 + k)
        for sp, dst in zip(leaves, stack):
            dst[k].copy_(init_params(sp, gen, device))
    return tree_unflatten(specs, stack)


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


def warmup_trace(vocab_size):
    """Two requests, one of each prompt length, arriving together, with 2
    new tokens each: a run's shapes (cuBLAS handles, allocator pools) in
    two ticks, where the first two requests of a trace take 32."""
    from repro_torch.serve.engine import synthetic_trace

    return synthetic_trace(2, vocab_size=vocab_size, prompt_lens=(64, 128), max_new=2,
                           mean_interarrival=1e-3, seed=0)


def serve_slice(torch, card, arch, *, paged, kernels, tag, seed0=0, layers=None, requests=16,
                max_new=32, sampled=False):
    """A model's K-member ensemble at full width (depth cut to ``layers``
    where given), K members from seeded generators, served through
    ``ServeEngine.run`` with the flash kernel over a trace of ``requests``
    requests (prompts of 64 and 128 tokens, ``max_new`` new tokens each):
    a warm-up, then a greedy and (``sampled``) a T=0.7/top-k 50 run, each
    with every launch count set to 0 just before it and read just after.
    Fails if a kernel of ``kernels`` was launched no time in a run."""
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import get_model
    from repro_torch.serve.engine import ServeEngine, synthetic_trace
    from repro_torch.serve.sampling import SamplingParams

    cfg = configs.get_config(arch).replace(use_flash_kernel=True)
    depth = f"{cfg.num_layers} layers"
    if layers is not None:
        depth = f"{layers} of its {cfg.num_layers} layers"
        cfg = cfg.replace(num_layers=layers)
    model = get_model(cfg)
    K = configs.EC_CHAINS[arch]
    log(f"[{tag}] device memory before the phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    members = stacked_members(torch, cfg, model, K, "cuda", seed0=seed0)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {arch} full width ({depth}, head_dim {cfg.head_dim}, {cfg.param_dtype}), "
        f"K={K} members, init {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak while drawing "
        f"{draw_peak / 2**30:.2f} GiB [{card}]")
    trace = synthetic_trace(requests, vocab_size=cfg.vocab_size, prompt_lens=(64, 128),
                            max_new=max_new, seed=0)
    kw = dict(num_slots=8, max_seq=128 + max_new, record_logprobs=True, device="cuda")

    def serve(paged, sampling, label, trace=trace):
        eng = ServeEngine(cfg, model, members, paged=paged, sampling=sampling, **kw)
        torch.cuda.synchronize()
        rep = eng.run(trace)
        torch.cuda.synchronize()
        check_report(rep, trace, cfg.vocab_size, f"{tag} {label}")
        pct = rep.latency_percentiles()
        log(f"[{tag}] {label}: {rep.total_tokens} tokens, {rep.decode_steps} decode ticks, "
            f"{rep.tokens_per_s:.1f} tok/s, latency p50 {pct['latency_p50_s']:.3f} s "
            f"p99 {pct['latency_p99_s']:.3f} s, first token p50 {pct['first_token_p50_s']:.3f} s "
            f"p99 {pct['first_token_p99_s']:.3f} s, wall {rep.wall_s:.2f} s [{card}]")
        return rep, pct

    mode = "paged" if paged else "dense"
    ServeEngine(cfg, model, members, paged=paged, **kw).run(warmup_trace(cfg.vocab_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    greedy, pct = serve(paged, SamplingParams(), f"{mode} greedy")
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] launches on the {mode} greedy run: {counts}; peak device memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    if min(counts[n] for n in kernels) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {counts}")
    sampled_rep = sampled_counts = None
    if sampled:
        reset_launches()
        sampled_rep, _ = serve(paged, SamplingParams(temperature=0.7, top_k=50),
                               f"{mode} T=0.7 top_k=50")
        sampled_counts = dict(launches)
        log(f"[{tag}] launches on the sampled run: {sampled_counts}")
        if min(sampled_counts[n] for n in kernels) <= 0:
            raise AssertionError(f"a kernel was not launched on the sampled run: {sampled_counts}")
    return dict(cfg=cfg, model=model, K=K, members=members, kw=kw, trace=trace, serve=serve,
                greedy=greedy, sampled=sampled_rep, counts=counts, sampled_counts=sampled_counts,
                peak=peak, draw_peak=draw_peak, pct=pct)


def phase_slice(torch, card):
    """qwen3-0.6b at full width, K = 4, on the paged engine; the dense
    engine's first token against the paged one's, and a profiled run.  The
    dense run serves the trace's prompts for SLICE_DENSE_NEW tokens: the
    check reads the first token and the first decode tick."""
    import dataclasses

    from repro_torch.serve.sampling import SamplingParams

    sl = serve_slice(torch, card, "qwen3-0.6b", paged=True, kernels=SERVING_KERNELS, tag="slice")
    rep, counts = sl["greedy"], {n: sl["counts"][n] for n in SERVING_KERNELS}
    short = [dataclasses.replace(r, max_new=SLICE_DENSE_NEW) for r in sl["trace"]]
    dense, _ = sl["serve"](False, SamplingParams(), f"dense greedy, {SLICE_DENSE_NEW} tokens",
                           trace=short)
    first = max(float(np.abs(a.logprobs[0] - b.logprobs[0]).max())
                for a, b in zip(rep.results, dense.results))
    second = max(float(np.abs(a.logprobs[1] - b.logprobs[1]).max())
                 for a, b in zip(rep.results, dense.results) if a.tokens[0] == b.tokens[0])
    same = sum(int((a.tokens[:SLICE_DENSE_NEW] == b.tokens).all())
               for a, b in zip(rep.results, dense.results))
    log(f"[slice] paged vs dense: first-token mixture logp max diff {first:.3e} "
        f"(atol {SLICE_FIRST_LOGP_ATOL}); first decode tick max diff {second:.3e} (bf16, not "
        f"gated); {same}/{len(sl['trace'])} requests with identical first {SLICE_DENSE_NEW} "
        f"tokens")
    if not first <= SLICE_FIRST_LOGP_ATOL:
        raise AssertionError(f"paged vs dense first-token logp differ by {first}")
    per_tick = {n: c / max(rep.decode_steps, 1) for n, c in counts.items()}
    profile_serving(torch, sl["cfg"], sl["model"], sl["members"], sl["kw"], card)
    del sl
    gc.collect()
    torch.cuda.empty_cache()
    return counts, per_tick


HYBRID_KERNELS = ("rglru_scan", "flash_attention", "bma_select")


def phase_slice_hybrid(torch, card):
    """recurrentgemma-2b at full width, K = 4, on the dense engine: exact
    launch counts on the greedy run, paged refused for RG-LRU layers, a
    profiled short run, and the SMOKE engine on the card against the CPU."""
    arch = "recurrentgemma-2b"
    sl = serve_slice(torch, card, arch, paged=False, kernels=HYBRID_KERNELS, tag="slice-hybrid",
                     seed0=400)
    cfg, rep = sl["cfg"], sl["greedy"]
    n_rglru = sum(k.kind == "rglru" for k in cfg.layer_kinds)
    n_attn = cfg.num_layers - n_rglru
    counts = {n: sl["counts"][n] for n in HYBRID_KERNELS}
    n_req = len(sl["trace"]) * sl["K"]
    want = {"rglru_scan": n_req * n_rglru, "flash_attention": n_req * n_attn,
            "bma_select": rep.decode_steps}
    log(f"[slice-hybrid] {n_rglru} rglru + {n_attn} attn layers (window "
        f"{cfg.pattern[-1].window}); greedy launches {counts}, expected {want}, paged_attention "
        f"{sl['counts']['paged_attention']}")
    if counts != want or sl["counts"]["paged_attention"] != 0:
        raise AssertionError(f"hybrid greedy run launched {sl['counts']}, expected {want}")
    check_paged_refused(sl, "slice-hybrid")
    prof = profile_serving(torch, cfg, sl["model"], sl["members"], sl["kw"], card, paged=False,
                           label="slice-hybrid-profile")
    hybrid = dict(tokens_per_s=rep.tokens_per_s, decode_steps=rep.decode_steps, wall=rep.wall_s, peak=sl["peak"], profile=prof,
                  **sl["pct"])
    del sl
    gc.collect()
    torch.cuda.empty_cache()
    phase_smoke_engine(torch, arch, paged=False, kernels=HYBRID_KERNELS, label="slice-hybrid")
    return counts, hybrid


# ---------------------------------------------------------------------------
# the rest of the text families: the dense configs and the MoE family
# ---------------------------------------------------------------------------

# (arch, depth or None for the published depth, seed0): h2o-danube at full
# width and depth; gemma2 and gemma3 at their published widths, cut to 8
# layers (gemma2: 4 local/global periods; gemma3: one 6-layer period plus the
# 2 local remainder layers its 62 leave), since a 27b member is 54 GB of bf16
DENSE_SLICES = (("h2o-danube-1.8b", None, 500), ("gemma2-27b", 8, 520), ("gemma3-27b", 8, 540))
# (arch, depth, seed0, sampled): olmoe at full width and depth; grok at its
# published width cut to 2 layers (8 experts of 6144 x 32768: ~21 GB)
MOE_SLICES = (("olmoe-1b-7b", None, 600, True), ("grok-1-314b", 2, 620, False))
FAMILY_TRACE = dict(requests=8, max_new=16)  # prompts of 64 and 128 tokens
WINDOW_PROMPT = 1536  # past gemma3's local window of 1024: the prefill keeps 1024 and rolls
WINDOW_NEW = 9  # the first token, then 8 more


def family_launches(sl, rep, counts, tag, paged, flash_layers=None):
    """Exact launch counts of a greedy run: flash once per request per
    member per layer whose prefill reaches it (``flash_layers``; every
    layer by default), bma_select once per decode tick, paged decode once
    per tick per layer per member on the paged engine (none on the dense
    one)."""
    cfg, K = sl["cfg"], sl["K"]
    n_flash = cfg.num_layers if flash_layers is None else flash_layers
    want = {"flash_attention": len(sl["trace"]) * K * n_flash,
            "bma_select": rep.decode_steps,
            "paged_attention": rep.decode_steps * cfg.num_layers * K if paged else 0}
    got = {n: counts[n] for n in want}
    log(f"[{tag}] {cfg.name}: launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"[{tag}] {cfg.name} launched {counts}, expected {want}")
    return got


def check_paged_refused(sl, tag):
    """The paged engine refuses the slice's model (recurrent, windowed or
    M-RoPE layers), as the reference's does."""
    from repro_torch.serve.engine import ServeEngine

    try:
        ServeEngine(sl["cfg"], sl["model"], sl["members"], paged=True, **sl["kw"])
    except ValueError as e:
        log(f"[{tag}] {sl['cfg'].name}: paged=True refused: ValueError: {e}")
    else:
        raise AssertionError(f"the paged engine accepted {sl['cfg'].name}")


def family_record(sl):
    """The result.json entry of a text-family slice (serve_slice logged it)."""
    g = sl["greedy"]
    rec = dict(arch=sl["cfg"].name, layers=sl["cfg"].num_layers, K=sl["K"],
               tokens_per_s=g.tokens_per_s, decode_steps=g.decode_steps, wall=g.wall_s,
               peak=sl["peak"], draw_peak=sl["draw_peak"], launches=sl["counts"], **sl["pct"])
    if sl["sampled"] is not None:
        rec["sampled_tokens_per_s"] = sl["sampled"].tokens_per_s
    return rec


def window_check(torch, card, sl):
    """gemma3's local window at its published 1024: one request with a
    WINDOW_PROMPT-token prompt, in f32, through the flash kernel engine and
    through one without the kernel; the first token's mixture logp within
    SLICE_FIRST_LOGP_ATOL and all WINDOW_NEW tokens identical."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = sl["cfg"].replace(compute_dtype=torch.float32)
    window = min(k.window for k in cfg.layer_kinds if k.window)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, WINDOW_PROMPT).astype(np.int32)
    reps, counts = {}, {}
    for flash in (True, False):
        eng = ServeEngine(cfg.replace(use_flash_kernel=flash), sl["model"], sl["members"],
                          num_slots=1, max_seq=WINDOW_PROMPT + WINDOW_NEW, record_logprobs=True,
                          device="cuda")
        reset_launches()
        reps[flash] = eng.run([Request(rid=0, prompt=prompt, max_new=WINDOW_NEW)])
        counts[flash] = dict(launches)
        del eng
    a, b = reps[True].results[0], reps[False].results[0]
    first = float(np.abs(a.logprobs[0] - b.logprobs[0]).max())
    same = bool(a.tokens.size == b.tokens.size == WINDOW_NEW and (a.tokens == b.tokens).all())
    n_flash = sl["K"] * cfg.num_layers
    log(f"[slice-dense] window check: gemma3 f32, a {WINDOW_PROMPT}-token prompt over the local "
        f"window {window}: kernel vs plain first-token logp max diff {first:.3e} (atol "
        f"{SLICE_FIRST_LOGP_ATOL}); {WINDOW_NEW} tokens identical={same}; flash launches "
        f"{counts[True]['flash_attention']} (expected {n_flash}) and "
        f"{counts[False]['flash_attention']} [{card}]")
    if not (first <= SLICE_FIRST_LOGP_ATOL and same):
        raise AssertionError(f"gemma3 window check failed: first-token logp diff {first}, "
                             f"tokens {a.tokens.tolist()} vs {b.tokens.tolist()}")
    if counts[True]["flash_attention"] != n_flash or counts[False]["flash_attention"] != 0:
        raise AssertionError(f"window check launches {counts}")
    return dict(first_logp_diff=first, tokens_equal=same)


def phase_slice_dense(torch, card):
    """h2o-danube-1.8b, gemma2-27b and gemma3-27b (DENSE_SLICES) on the
    dense engine: a greedy run each with exact launch counts, paged
    refused (every one has windowed layers), gemma3's window check at its
    published window, then each SMOKE engine on the card against the CPU."""
    kernels = ("flash_attention", "bma_select")
    out, by_path = {}, {}
    for arch, layers, seed0 in DENSE_SLICES:
        sl = serve_slice(torch, card, arch, paged=False, kernels=kernels, tag="slice-dense",
                         seed0=seed0, layers=layers, sampled=False, **FAMILY_TRACE)
        by_path[arch] = family_launches(sl, sl["greedy"], sl["counts"], "slice-dense", paged=False)
        out[arch] = family_record(sl)
        check_paged_refused(sl, "slice-dense")
        if arch == "gemma3-27b":
            out[arch]["window"] = window_check(torch, card, sl)
        del sl
        gc.collect()
        torch.cuda.empty_cache()
        phase_smoke_engine(torch, arch, paged=False, kernels=kernels, label="slice-dense")
    return by_path, out


def phase_slice_moe(torch, card):
    """olmoe-1b-7b and grok-1-314b (MOE_SLICES) on the paged engine, with
    exact launch counts on each run; each SMOKE engine on the card against
    the CPU; and SMOKE olmoe training on the card against the CPU (the MoE
    backward)."""
    out, by_path = {}, {}
    for arch, layers, seed0, sampled in MOE_SLICES:
        sl = serve_slice(torch, card, arch, paged=True, kernels=SERVING_KERNELS,
                         tag="slice-moe", seed0=seed0, layers=layers, sampled=sampled,
                         **FAMILY_TRACE)
        by_path[arch] = family_launches(sl, sl["greedy"], sl["counts"], "slice-moe", paged=True)
        if sampled:
            family_launches(sl, sl["sampled"], sl["sampled_counts"], "slice-moe", paged=True)
        out[arch] = family_record(sl)
        del sl
        gc.collect()
        torch.cuda.empty_cache()
        phase_smoke_engine(torch, arch, paged=True, label="slice-moe")
    phase_smoke_train(torch, arch="olmoe-1b-7b", label="slice-moe")
    return by_path, out


# ---------------------------------------------------------------------------
# every architecture: the ssm (xlstm), vlm (qwen2-vl) and audio (whisper)
# families
# ---------------------------------------------------------------------------

BMA_ONLY = ("bma_select",)  # the one hand kernel of a path whose prefill reaches no flash
VLM_PREFILL_PATCHES = 64  # launch/specs.py's VLM_PATCHES: an 8 x 8 grid of patches
AUDIO_ENSEMBLE = dict(K=4, batch=4, prompt_len=16, gen=16)


XLSTM_LAYERS = 8  # [slice-xlstm]: one period of 24 (cut so that [dryrun] fits the time limit)


def phase_slice_xlstm(torch, card):
    """xlstm-350m at its published widths cut to XLSTM_LAYERS (one period:
    7 mLSTM and 1 sLSTM block), K = 4, on the dense engine over
    ``[slice-dense]``'s trace,
    greedy: bma_select once a tick, no flash or paged launch (no attention
    layer), paged refused; the SMOKE engine and SMOKE training on the card
    against the CPU."""
    arch = "xlstm-350m"
    sl = serve_slice(torch, card, arch, paged=False, kernels=BMA_ONLY, tag="slice-xlstm",
                     seed0=700, layers=XLSTM_LAYERS, **FAMILY_TRACE)
    counts = family_launches(sl, sl["greedy"], sl["counts"], "slice-xlstm", paged=False,
                             flash_layers=0)
    out = family_record(sl)
    check_paged_refused(sl, "slice-xlstm")
    del sl
    gc.collect()
    torch.cuda.empty_cache()
    phase_smoke_engine(torch, arch, paged=False, kernels=BMA_ONLY, label="slice-xlstm")
    phase_smoke_train(torch, arch=arch, label="slice-xlstm", steps=1)
    return counts, out


def vlm_patch_prefill(torch, card, sl):
    """One prefill of member 0 at full width: VLM_PREFILL_PATCHES patch
    embeddings on a square grid of (t=0, h, w) positions, then as many text
    tokens continuing every stream at the grid's max + 1.  Logits finite,
    ``t`` the whole length, and no kernel launched: M-RoPE keeps the plain
    attention path, as in the reference."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import tree_map

    cfg, model, n = sl["cfg"], sl["model"], VLM_PREFILL_PATCHES
    side = math.isqrt(n)
    g = torch.Generator(device="cuda").manual_seed(730)
    patches = (0.02 * torch.randn((1, n, cfg.d_model), generator=g, device="cuda")).to(
        cfg.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device="cuda",
                           dtype=torch.int32)
    i = torch.arange(n, device="cuda")
    text = side + i
    pos = torch.stack([torch.cat([torch.zeros_like(i), text]), torch.cat([i // side, text]),
                       torch.cat([i % side, text])])[:, None].to(torch.int32)  # (3, 1, 2n)
    member = tree_map(lambda a: a[0], sl["members"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(cfg, member, {"tokens": tokens, "patch_embeds": patches,
                                                    "positions": pos}, 2 * n + 1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = {k: launches[k] for k in SERVING_KERNELS}
    finite = bool(torch.isfinite(logits).all())
    log(f"[slice-vlm] patch prefill: {n} patch embeddings ({side} x {side} grid) + {n} text "
        f"tokens, 3-stream positions, member 0 at full width: logits {tuple(logits.shape)} "
        f"finite={finite}, t={int(cache['t'])}, {ms:.1f} ms on the host clock; launches "
        f"{counts} (expected none: M-RoPE stays on the plain path) [{card}]")
    if not (finite and tuple(logits.shape) == (1, 1, cfg.vocab_size)
            and int(cache["t"]) == 2 * n and not any(counts.values())):
        raise AssertionError(f"[slice-vlm] patch prefill failed: finite={finite}, "
                             f"t={int(cache['t'])}, launches {counts}")
    return counts, dict(ms=ms, tokens=2 * n)


def phase_slice_vlm(torch, card):
    """qwen2-vl-7b at its published widths and depth (bf16, K = 2) on the
    dense engine over ``[slice-dense]``'s trace (text prompts), greedy:
    bma_select once a tick, no flash (M-RoPE keeps the reference's plain
    prefill) and no paged launch, paged refused; a full-width prefill with
    patch embeddings and 3-stream positions; the SMOKE engine and SMOKE
    training on the card against the CPU."""
    arch = "qwen2-vl-7b"
    sl = serve_slice(torch, card, arch, paged=False, kernels=BMA_ONLY, tag="slice-vlm",
                     seed0=720, **FAMILY_TRACE)
    by_path = {"engine": family_launches(sl, sl["greedy"], sl["counts"], "slice-vlm",
                                         paged=False, flash_layers=0)}
    out = family_record(sl)
    check_paged_refused(sl, "slice-vlm")
    by_path["patch-prefill"], out["patch_prefill"] = vlm_patch_prefill(torch, card, sl)
    del sl
    gc.collect()
    torch.cuda.empty_cache()
    phase_smoke_engine(torch, arch, paged=False, kernels=BMA_ONLY, label="slice-vlm")
    phase_smoke_train(torch, arch=arch, label="slice-vlm", steps=1)
    return by_path, out


def phase_slice_audio(torch, card):
    """whisper-base at its published widths and depth (6 encoder and 6
    decoder layers, 1500 frames) with K = 4: ``launch.serve.main``'s
    ensemble path on the card (the bootstrap ensemble, random frame
    embeddings, ``ensemble_decode``), then ``ensemble_decode`` alone on
    drawn members, timed; flash exactly once per decoder layer per member
    (each member's prefill), no other kernel; the SMOKE ensemble and SMOKE
    training on the card against the CPU."""
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import get_model

    arch = "whisper-base"
    a = AUDIO_ENSEMBLE
    cfg = configs.get_config(arch).replace(use_flash_kernel=True)
    want = {"flash_attention": cfg.num_layers * a["K"], "paged_attention": 0, "bma_select": 0}
    args = ["--arch", arch, "--ensemble", str(a["K"]), "--batch", str(a["batch"]),
            "--prompt-len", str(a["prompt_len"]), "--gen", str(a["gen"])]
    reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    toks = serve_launch.main(args)
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in want}
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice-audio] launch.serve.main({' '.join(args)}): tokens {tuple(toks.shape)} in "
        f"{wall:.2f} s with the bootstrap; launches {counts}, expected {want}; peak {gib(peak)} "
        f"[{card}]")
    if (counts != want or tuple(toks.shape) != (a["batch"], a["gen"]) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size):
        raise AssertionError(f"[slice-audio] launch.serve.main: launches {counts}, tokens {toks}")

    model = get_model(cfg)
    reset_peak(torch)
    members = stacked_members(torch, cfg, model, a["K"], "cuda", seed0=740)
    draw_peak = torch.cuda.max_memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(741)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (a["batch"], a["prompt_len"]),
                                     generator=g, device="cuda", dtype=torch.int32),
             "frame_embeds": 0.02 * torch.randn((a["batch"], cfg.enc_seq, cfg.d_model),
                                                generator=g, device="cuda")}
    max_seq = a["prompt_len"] + a["gen"] + 1
    serve_launch.ensemble_decode(cfg, model, members, batch, max_seq, 2)  # warm-up
    reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    first = serve_launch.ensemble_decode(cfg, model, members, batch, max_seq, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = serve_launch.ensemble_decode(cfg, model, members, batch, max_seq, a["gen"])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts2 = {k: launches[k] for k in want}
    peak2 = torch.cuda.max_memory_allocated()
    n_tok = a["batch"] * a["gen"]
    log(f"[slice-audio] ensemble_decode, K={a['K']} members at full width "
        f"({cfg.enc_layers} + {cfg.num_layers} layers, {cfg.enc_seq} frames): first token "
        f"{first_s:.3f} s (encode + prefill), {a['batch']} x {a['gen']} tokens in {decode_s:.3f} "
        f"s = {n_tok / decode_s:.1f} tok/s; launches over both runs {counts2} (expected flash "
        f"{2 * want['flash_attention']}); peak serving {gib(peak2)}, drawing {gib(draw_peak)} "
        f"[{card}]")
    if counts2 != {k: 2 * v for k, v in want.items()} or not torch.equal(toks[:, :1], first):
        raise AssertionError(f"[slice-audio] ensemble_decode launched {counts2}")
    del members
    gc.collect()
    torch.cuda.empty_cache()
    phase_smoke_encdec(torch, arch, label="slice-audio")
    phase_smoke_train(torch, arch=arch, label="slice-audio", steps=1)
    return counts, dict(launch_wall=wall, launch_peak=peak, first_token_s=first_s,
                        decode_s=decode_s, tokens_per_s=n_tok / decode_s, peak=peak2,
                        draw_peak=draw_peak, launches=counts2)


def phase_smoke_encdec(torch, arch, label):
    """The encoder-decoder's serving path on the card against the CPU at the
    SMOKE size in f32, flash on: ``ensemble_decode`` over K = 2 members
    gives the same tokens, and member 0's prefill and three decode steps
    the same log-probs within SMOKE_LOGP_ATOL."""
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import get_model, tree_map

    cfg = configs.get_config(arch, smoke=True).replace(use_flash_kernel=True)
    model = get_model(cfg)
    members = stacked_members(torch, cfg, model, 2, "cpu", seed0=100)
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, 8), generator=g, dtype=torch.int32),
             "frame_embeds": 0.02 * torch.randn((3, cfg.enc_seq, cfg.d_model), generator=g)}
    out = {}
    for dev in ("cpu", "cuda"):
        mem = tree_map(lambda x: x.to(dev), members)
        b = {k: v.to(dev) for k, v in batch.items()}
        reset_launches()
        toks = serve_launch.ensemble_decode(cfg, model, mem, b, 16, 6)
        p0 = tree_map(lambda x: x[0], mem)
        with torch.no_grad():
            lg, cache = model.prefill(cfg, p0, b, 16)
            logps = [torch.log_softmax(lg.float(), -1).cpu()]
            for t in range(3):
                lg, cache = model.decode_step(cfg, p0, cache, toks[:, t:t + 1])
                logps.append(torch.log_softmax(lg.float(), -1).cpu())
        if dev == "cuda" and launches["flash_attention"] <= 0:
            raise AssertionError(f"{label} on the card missed flash: {dict(launches)}")
        out[dev] = (toks.cpu(), logps)
    same = torch.equal(out["cpu"][0], out["cuda"][0])
    diff = max((a - b).abs().max().item() for a, b in zip(out["cpu"][1], out["cuda"][1]))
    log(f"[{label}] {arch} SMOKE f32, ensemble_decode K=2, flash on: card vs CPU tokens "
        f"equal={same}, member 0 logp max diff {diff:.3e} (atol {SMOKE_LOGP_ATOL})")
    if not (same and diff <= SMOKE_LOGP_ATOL):
        raise AssertionError(f"{label}: ensemble_decode on the card disagrees with the CPU")


KERNEL_CLASSES = (  # (label, substrings of a device kernel's name), first match wins
    ("hand kernels", ("flash_fwd", "paged_fwd", "bma_stats", "bma_mix", "bma_radix", "bma_pick",
                      "rglru_scan")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("copies and casts", ("copy",)),
)


def kernel_class(name: str) -> str:
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other elementwise and reductions"


def profile_serving(torch, cfg, model, members, kw, card, paged=True, label="profile"):
    """Where a serving run's time goes: the device kernels of a short
    greedy run (torch.profiler, CUDA activity only) against the wall clock
    of the same run without the profiler; the busy share is the device
    time over the profiled run's own wall clock (a lower bound on the
    unprofiled run's, since the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine, synthetic_trace

    trace = synthetic_trace(8, vocab_size=cfg.vocab_size, prompt_lens=(64, 128), max_new=4, seed=1)

    def run():
        eng = ServeEngine(cfg, model, members, paged=paged, **dict(kw, record_logprobs=False))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.run(trace)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    rep, wall = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, pwall = run()
    kernels = device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    busy_us, streams = device_busy(prof)
    (OUT / f"{label.replace('-', '_')}.txt").write_text(kernel_table(kernels))
    if device_us <= 0:
        log(f"[{label}] torch.profiler recorded no device time: busy share not measured")
        return None
    n = sum(e.count for e in kernels)
    log(f"[{label}] {'paged' if paged else 'dense'} greedy, {len(trace)} requests x 4 tokens "
        f"({len(trace)} admits, {rep.decode_steps} ticks): wall {wall:.3f} s without the "
        f"profiler; under it wall {pwall:.3f} s, device kernels {device_us / 1e6:.3f} s summed, "
        f"busy {busy_us / 1e6:.3f} s on {streams} stream(s) = {100 * busy_us / 1e6 / pwall:.1f}% "
        f"busy, {n} kernels [{card}]")
    classes: dict = {}
    for e in kernels:
        c = kernel_class(e.key)
        classes[c] = classes.get(c, 0.0) + e.self_device_time_total
    for c, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        log(f"[{label}]   {100 * us / device_us:5.1f}%  {us / 1e3:9.3f} ms  {c}")
    hand = [e for e in kernels if kernel_class(e.key) == "hand kernels"]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top + [e for e in hand if e not in top]:
        log(f"[{label}]   {100 * e.self_device_time_total / device_us:5.1f}%  "
            f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.self_device_time_total / e.count:8.2f} us each  {e.key[:80]}")
    bma_us = sum(e.self_device_time_total for e in kernels if "bma_" in e.key)
    ticks = max(rep.decode_steps, 1)
    log(f"[{label}]   bma_select: {bma_us / 1e3:.3f} ms of device time over {rep.decode_steps} "
        f"ticks = {bma_us / ticks:.2f} us per tick (one call per tick; all its kernels)")
    return dict(wall=wall, profiled_wall=pwall, device_us=device_us, busy_us=busy_us,
                kernels=n, classes=classes, bma_us_per_tick=bma_us / ticks)


def phase_smoke_engine(torch, arch="qwen3-0.6b", paged=True, kernels=SERVING_KERNELS,
                       label="smoke-engine"):
    """The whole engine on the card against the CPU, at the SMOKE size in
    f32: the same params, trace and greedy sampling give the same tokens."""
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import get_model, tree_map
    from repro_torch.serve.engine import ServeEngine, synthetic_trace

    cfg = configs.get_config(arch, smoke=True).replace(use_flash_kernel=True)
    model = get_model(cfg)
    members = stacked_members(torch, cfg, model, 4, "cpu", seed0=100)
    trace = synthetic_trace(6, vocab_size=cfg.vocab_size, prompt_lens=(16, 8), max_new=6, seed=3)
    reps = {}
    for dev in ("cpu", "cuda"):
        mem = tree_map(lambda a: a.to(dev), members)
        reset_launches()
        reps[dev] = ServeEngine(cfg, model, mem, num_slots=4, max_seq=24, paged=paged,
                                record_logprobs=True, device=dev).run(trace)
        if dev == "cuda" and min(launches[n] for n in kernels) <= 0:
            raise AssertionError(f"{label} on the card missed a kernel: {dict(launches)}")
    diff = max(float(np.abs(a.logprobs - b.logprobs).max())
               for a, b in zip(reps["cpu"].results, reps["cuda"].results))
    same = all((a.tokens == b.tokens).all() for a, b in zip(reps["cpu"].results, reps["cuda"].results))
    atol = SMOKE_LOGP_ATOL + SMOKE_LOGP_EXTRA.get(arch, 0.0)
    log(f"[{label}] {arch} SMOKE f32, {'paged' if paged else 'dense'}, flash on: card vs CPU "
        f"tokens equal={same}, logp max diff {diff:.3e} (atol {atol:g})")
    if not (same and diff <= atol):
        raise AssertionError(f"{label}: engine on the card disagrees with the CPU at the SMOKE size")


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

# The on-card Async SGHMC case (the paper's approach-I baseline): K = 4
# workers on U = (lam/2)||theta - mu||^2 at s in {1, 4}, the battery's case of
# tests/test_stationary.py.  The theta variances are those of
# repro.diagnostics.async_sghmc_stationary, which imports jax;
# tests/test_torch_paper_samplers.py pins them to it.
ASYNC_STATIONARY_CASE = dict(eps=0.1, friction=1.0, K=4, lam=1.0, mu=1.5)
ASYNC_STATIONARY_D = 4096
ASYNC_ORACLE_VAR = {1: 1.114027386561726, 4: 1.6457419107663855}

SMOKE_TRAIN_ATOL = 1e-5  # card vs CPU after 3 steps: GEMMs sum in another order
# Some SMOKE models amplify f32 rounding in their training gradient: the
# worst leaf's max|g32 - g64| / max|g64| on the CPU (the check's members and
# batch, scripts/torch_f64_distance.py) is 6.7e-5 for xlstm, 1.8e-4 for
# qwen2-vl, 2.8e-5 for whisper and 8.1e-5 for recurrentgemma, against 1.5e-6
# and 1.6e-6 for qwen3 and olmoe.  Two f32 runs (card, CPU) may each be that far from the f64 one,
# so beyond the atol a leaf of these archs may differ by twice it, relative
# to the leaf's largest magnitude; qwen3 and olmoe keep the plain atol.
SMOKE_TRAIN_RTOL = {"xlstm-350m": 1.4e-4, "qwen2-vl-7b": 3.6e-4, "whisper-base": 6e-5,
                    "recurrentgemma-2b": 1.6e-4}
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
    b_ms, b_by = bound(nbytes, 0.0, "f32")
    pb_ms, _ = bound(parity_bytes, 0.0, "f32")
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
    # chain_offset: a rank's chains k.. of a split run draw the unsplit
    # run's noise, on both paths, and the plain version's bits from the
    # global element on
    offsets = {}
    for full in (a, wide):
        zk = torch.zeros_like(full)
        for off in (1, 3):
            part = ops.fused_ec_update(zk[off:], zk[off:], zk[off:], zk[0], seed=EC_KEY, leaf=3,
                                       step=5, chain_offset=off, **hyper)[1]
            h1, h2 = ref.philox_bits(EC_KEY, 3, 5, part.numel(), off * zk.shape[1])
            bits = tuple(torch.from_numpy(h.view(np.int32)).cuda().view(part.shape)
                         for h in (h1, h2))
            plain_part = ops.fused_ec_update(zk[off:], zk[off:], zk[off:], zk[0], bits=bits,
                                             **hyper)[1]
            offsets[(full.shape[1], off)] = (torch.equal(part, full[off:]),
                                            torch.equal(part, plain_part))
    log(f"[philox] chain_offset (N, offset): (== the unsplit launch's chains, == plain bits "
        f"from the global element): {offsets}")
    if not all(all(v) for v in offsets.values()):
        raise AssertionError("chain_offset does not draw the unsplit run's noise")
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
    against the oracle's mean, variance and cross-covariance (None: not
    checked), as ``phase_stationary`` forms them."""
    from repro_torch import diagnostics as diag

    K = traj.shape[0]
    ess = float(np.sum(diag.coupled_ess_nd(traj)))
    checks = [("mean", traj.mean(), mean, 3.0 * math.sqrt(var / ess) + 1e-4, ess)]
    dev = traj - mean
    moments = [("var", np.mean(dev * dev, axis=0), var)]
    if cross is not None:  # one chain (Async SGHMC's server) has no pairs
        moments.append(("cross-cov", np.mean([dev[i] * dev[j] for i in range(K)
                                              for j in range(i + 1, K)], axis=0), cross))
    for name, series, want in moments:
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


def phase_smoke_train(torch, arch="qwen3-0.6b", label="smoke-train", steps=3):
    """SMOKE training, card against CPU: the same params, batches, bits and
    center noise through train.loop.run with the fused sampler, ``steps``
    steps (``[slice-moe]`` runs it on olmoe-1b-7b: the MoE backward, through
    the top-k, the one-hots and the capacity cumsum, on the card; the
    ``[slice-xlstm]``, ``[slice-vlm]`` and ``[slice-audio]`` phases run one
    step on their archs, with the family's batch from
    ``launch.train.build_batch_fn``: patch or frame embeddings).  A step's
    momentum is linear in the gradient, so SMOKE_TRAIN_RTOL, set from one
    gradient's distance from f64, holds for one step; over more steps an
    ill-conditioned model's runs drift apart further (qwen2-vl's momentum,
    1.7e-3 of its scale after 3 steps)."""
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import default_sampler
    from repro_torch.launch.train import build_batch_fn
    from repro_torch.models import get_model, tree_leaves, tree_map
    from repro_torch.train import LoopConfig, loop, make_train_step

    cfg = configs.get_config(arch, smoke=True)
    model = get_model(cfg)
    K = 4
    members = stacked_members(torch, cfg, model, K, "cpu", seed0=200)
    batch_fn = build_batch_fn(cfg, K, 2, 16, seed=5, device="cpu")
    batches = [batch_fn(t) for t in range(steps)]
    gen = torch.Generator().manual_seed(77)
    n_leaves = len(tree_leaves(members))
    noise = []
    for _ in range(steps):
        bits = tree_map(lambda x: tuple(torch.randint(-2**31, 2**31 - 1, x.shape, generator=gen,
                                                      dtype=torch.int32) for _ in range(2)), members)
        r = tree_map(lambda x: torch.randn(x.shape[1:], generator=gen), members)
        noise.append((bits, r))
    out = {}
    torch.use_deterministic_algorithms(True)  # a nondeterministic op raises and names itself
    for dev in ("cpu", "cuda"):
        to = lambda t: tree_map(lambda x: x.to(dev, copy=True), t)  # the run updates in place
        samp = default_sampler(cfg, arch, K, sync_every=2, fused=True, step_size=1e-3)
        params = to(members)
        noise_fn = lambda step: {"p": tree_map(lambda b: tuple(x.to(dev) for x in b), noise[step][0]),
                                 "r": to(noise[step][1])}
        step = make_train_step(cfg, model, samp, 1000, noise_fn=noise_fn)
        reset_launches()
        p, s, h = loop.run(step, params, samp.init(params), lambda t: to(batches[t]),
                           LoopConfig(num_steps=steps, log_every=1), num_chains=K, sampler=samp)
        if dev == "cuda":
            # the hybrid's RG-LRU layers run the scan and its backward once a
            # chain a step each
            n_rglru = sum(k.kind == "rglru" for k in cfg.layer_kinds)
            want = {"fused_ec_update": steps * n_leaves, "rglru_scan": steps * K * n_rglru,
                    "rglru_scan_bwd": steps * K * n_rglru}
            got = {n: launches[n] for n in want}
            if got != want:
                raise AssertionError(f"SMOKE training launched {got}, not {want}")
        out[dev] = (p, s, h)
    torch.use_deterministic_algorithms(False)
    rtol = SMOKE_TRAIN_RTOL.get(arch, 0.0)
    diffs, over = {}, []
    for name, get in (("params", lambda o: o[0]), ("momentum", lambda o: o[1].momentum),
                      ("center", lambda o: o[1].center)):
        errs = [((a.cpu() - b).abs().max().item(), b.abs().max().item())
                for a, b in zip(tree_leaves(get(out["cuda"])), tree_leaves(get(out["cpu"])))]
        diffs[name] = max(e for e, _ in errs)
        over += [(name, i, e, m) for i, (e, m) in enumerate(errs) if e > SMOKE_TRAIN_ATOL + rtol * m]
    nll = [(a["nll_per_token"], b["nll_per_token"]) for a, b in zip(out["cuda"][2], out["cpu"][2])]
    log(f"[{label}] {arch} SMOKE f32 K={K}, {steps} steps, fused, parity noise: card vs CPU max diff "
        f"params {diffs['params']:.3e}, momentum {diffs['momentum']:.3e}, center "
        f"{diffs['center']:.3e} (atol {SMOKE_TRAIN_ATOL} + {rtol} x a leaf's max magnitude); nll "
        f"per step card/CPU {nll}")
    if over:
        raise AssertionError(f"[{label}] SMOKE training on the card disagrees with the CPU: "
                             f"(tree, leaf, max diff, max magnitude) {over}")


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

    # where a step's time goes: 2 more steps under the profiler, their
    # device time over their own wall clock, beside 2 unprofiled steps
    def two_steps(start):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop.run(step, params, state, lambda s: batch_fn(start + s),
                 LoopConfig(num_steps=2, log_every=0, seed=1), num_chains=K)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    wall2 = two_steps(100)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pwall2 = two_steps(200)
    kernels = device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    busy_us, streams = device_busy(prof)
    (OUT / f"{label.replace('-', '_')}_profile.txt").write_text(kernel_table(kernels))
    split = {}
    if device_us > 0:
        for e in kernels:
            lab = next((lab for lab, keys in TRAIN_CLASSES if any(k in e.key for k in keys)),
                       "other elementwise and reductions")
            split[lab] = split.get(lab, 0.0) + e.self_device_time_total
        log(f"[{label}-profile] 2 steps: wall {wall2:.3f} s without the profiler; under it wall "
            f"{pwall2:.3f} s, device kernels {device_us / 1e6:.3f} s summed, busy "
            f"{busy_us / 1e6:.3f} s on {streams} stream(s) = "
            f"{100 * busy_us / 1e6 / pwall2:.1f}% busy, "
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


HYBRID_TRAIN_LAYERS = 3  # one (rglru, rglru, attn) period of recurrentgemma-2b's 26 layers
# EC_CHAINS["recurrentgemma-2b"] is 4, but at K = 4 the step outgrew an
# H100 80GB even at 3 layers (3.65 GB a member): params, momentum, the four
# center trees, the stacked gradients and the sampler's update tree are ~20
# member copies, and the first sync's mean over the (K, 256000, 2560)
# embedding another 10.5 GB (77.95 GiB allocated when it ran out).  K = 2
# peaks at ~51 GiB.
HYBRID_TRAIN_K = 2
TRAIN_PEAK_LIMIT = 78 * 2**30


def phase_train_hybrid(torch, card):
    """recurrentgemma-2b at its published widths cut to HYBRID_TRAIN_LAYERS
    layers (a member is 3.65 GB of f32 at 3 layers, 11.58 GB at 26),
    HYBRID_TRAIN_K = 2 chains (see there) with ``[train]``'s other
    settings for TRAIN_STEPS steps through train.loop.run in
    production mode: every RG-LRU layer runs the scan kernel forward and
    its backward kernel once a chain a step.  Exact launches, finite nll,
    s/step over steps 2-8, peak memory and the step's model-FLOPs share of
    the card's bf16 peak (6 * active params * tokens, ``roofline.HW``)."""
    from repro_torch import configs
    from repro_torch.data import chain_batches, synthetic_token_stream
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import default_sampler
    from repro_torch.models import active_params, get_model, tree_leaves
    from repro_torch.train import LoopConfig, loop, make_train_step

    arch, K = "recurrentgemma-2b", HYBRID_TRAIN_K
    cfg = configs.get_config(arch).replace(num_layers=HYBRID_TRAIN_LAYERS)
    model = get_model(cfg)
    log(f"[train-hybrid] device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    params = stacked_members(torch, cfg, model, K, "cuda", seed0=700)
    samp = default_sampler(cfg, arch, K, sync_every=4, fused=True, step_size=1e-6)
    state = samp.init(params)
    stream = synthetic_token_stream(cfg.vocab_size, seed=0, device="cuda")
    batch_fn = lambda t: chain_batches(stream, t, K, 4, 64)  # noqa: E731
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
    n_rglru = sum(k.kind == "rglru" for k in cfg.layer_kinds)
    n_param = sum(x[0].numel() for x in tree_leaves(params))
    want = {n: 0 for n in counts}
    want.update(rglru_scan=n_rglru * K * TRAIN_STEPS, rglru_scan_bwd=n_rglru * K * TRAIN_STEPS,
                fused_ec_update=n_leaves * TRAIN_STEPS)
    nll = [m["nll_per_token"] for m in hist]
    steady = (hist[-1]["wall_s"] - hist[0]["wall_s"]) / max(len(hist) - 1, 1)
    tokens = K * 4 * 64
    model_flops = 6.0 * active_params(cfg) * tokens
    share = model_flops / max(steady, 1e-9) / card_peaks()["peak_flops_bf16"]
    log(f"[train-hybrid] recurrentgemma-2b published widths, {cfg.num_layers} layers "
        f"({n_rglru} rglru + {cfg.num_layers - n_rglru} attn; {n_param / 1e9:.4f}e9 parameters a "
        f"member), K={K}, EC-SGHMC fused, batch 4 x 64 per chain, sync every 4, eps 1e-6, "
        f"{TRAIN_STEPS} steps in {wall:.2f} s; steady {steady:.3f} s/step = "
        f"{1 / max(steady, 1e-9):.3f} steps/s; peak device memory {peak / 2**30:.2f} GiB [{card}]")
    log(f"[train-hybrid] nll per token by step {[round(v, 4) for v in nll]} (ln V = "
        f"{math.log(cfg.vocab_size):.3f}); launches {counts}, expected {want}")
    log(f"[train-hybrid] model FLOPs a step 6 x {active_params(cfg)} x {tokens} tokens = "
        f"{model_flops:.4e}: {100 * share:.3f}% of the card's dense bf16 peak at the steady step "
        f"time ({card_peaks()['card']} in roofline.HW)")
    if not all(math.isfinite(v) for v in nll) or len(nll) != TRAIN_STEPS:
        raise AssertionError(f"[train-hybrid] non-finite or missing nll: {nll}")
    if counts != want:
        raise AssertionError(f"[train-hybrid] launched {counts}, expected {want}")
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"[train-hybrid] peak {peak / 2**30:.2f} GiB over 78 GiB")
    del params, state, samp, step
    gc.collect()
    torch.cuda.empty_cache()
    phase_smoke_train(torch, arch, label="train-hybrid", steps=1)
    launcher = launch_train_smoke(torch, arch, card)
    return counts, dict(wall=wall, steady=steady, peak=peak, nll=nll, layers=cfg.num_layers,
                        K=K, params_per_member=n_param, model_flops=model_flops,
                        model_flops_share=share, launcher=launcher)


def launch_train_smoke(torch, arch, card):
    """``python -m repro_torch.launch.train --arch <arch> --smoke`` on the
    card, 4 chains for LAUNCH_TRAIN_STEPS steps (the launcher logs every
    10): finite nll, and each RG-LRU layer's scan and backward kernels once
    a chain a step."""
    from repro_torch import configs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import train as train_launch

    cfg = configs.get_config(arch, smoke=True)
    args = ["--arch", arch, "--smoke", "--steps", str(LAUNCH_TRAIN_STEPS), "--chains", "4"]
    reset_launches()
    hist = train_launch.main(args)
    torch.cuda.synchronize()
    n = sum(k.kind == "rglru" for k in cfg.layer_kinds) * 4 * LAUNCH_TRAIN_STEPS
    got = {k: launches[k] for k in ("rglru_scan", "rglru_scan_bwd")}
    nll = [m["nll_per_token"] for m in hist]
    log(f"[train-hybrid] launch.train.main({' '.join(args)}): nll per token {nll}; launches "
        f"{got} [{card}]")
    if not hist or not all(math.isfinite(v) for v in nll):
        raise AssertionError(f"[train-hybrid] launcher nll per token {nll}")
    if got != {"rglru_scan": n, "rglru_scan_bwd": n}:
        raise AssertionError(f"[train-hybrid] launcher launched {got}, not {n} each")
    return dict(nll=nll, launches=got)


# ---------------------------------------------------------------------------
# the paper's experiments: Async SGHMC, swept runs, the MLP and ResNet-32
# posteriors of Fig. 1 and Fig. 2
# ---------------------------------------------------------------------------

PAPER_K = 6  # the paper's threads: EC chains or Async workers (Fig. 2)
PAPER_LR, PAPER_BETA = 3e-7, 0.9  # benchmarks/posterior_driver.py's sgd_map(lr, beta)
PAPER_PRIOR = 1e-5  # Gaussian prior lambda (the paper's MNIST value)
PAPER_BURNIN = 0.25  # share of the steps before the BMA starts accumulating
MLP_TRAIN, MLP_TEST, MLP_BATCH = 60_000, 2_000, 100
MLP_STEPS, MLP_EVAL = 500, 20  # the paper runs 2000 steps: cut for the call's time
RESNET_WIDTH = 16
RESNET_TRAIN, RESNET_TEST, RESNET_BATCH = 50_000, 1_000, 50
RESNET_STEPS, RESNET_EVAL = 240, 80  # the paper runs 2000 steps: cut for the call's time
FIG1_STEPS, FIG1_SG_SEEDS, FIG1_EC_SEEDS = 600, tuple(range(8)), (100, 101)
SMOKE_PAPER_STEPS, SMOKE_PAPER_N, SMOKE_PAPER_BATCH = 12, 2000, 16


def sgd_map(lr: float, beta: float = 0.9):
    """SGD-with-momentum (lr, beta) as SGHMC (step size, friction):
    eps = sqrt(lr (1 - beta)), V = (1 - beta) / eps
    (benchmarks/posterior_driver.py::sgd_map)."""
    eps = math.sqrt(lr * (1.0 - beta))
    return eps, (1.0 - beta) / eps


def paper_leaf_shapes():
    """{model: [leaf shape, ...]} of the 2x800 MLP and ResNet-32 at width 16,
    in flatten order."""
    from repro_torch.models import mlp, resnet, tree_leaves

    return {"mlp": [s.shape for s in tree_leaves(mlp.param_specs())],
            "resnet32": [s.shape for s in tree_leaves(resnet.param_specs(width=RESNET_WIDTH))]}


def phase_fused_ec_small(torch, ops, ref):
    """The fused kernel at every leaf shape of the paper's two models, K = 6,
    f32: bitwise against its plain version in parity mode (bits from a
    seeded generator) and in Philox mode (the plain version given the
    kernel's Philox bits); N = 10 and the other N that are not multiples
    of 4 take the single-element path.  Each shape's time per launch by
    CUDA events and by device time, beside its byte bound; then per step
    of each model (a launch per leaf)."""
    import repro_torch.kernels.fused_ecsghmc as fe

    K = PAPER_K
    g = torch.Generator(device="cuda").manual_seed(19)
    scalars = ref.ec_scalars(EC_HYPER["eps"], EC_HYPER["friction"], 1.0 / EC_HYPER["mass"],
                             EC_HYPER["alpha"], EC_HYPER["sigma_p"])
    models = paper_leaf_shapes()
    rows, max_err = {}, 0.0
    for shape in sorted({s for v in models.values() for s in v}, key=math.prod):
        N = math.prod(shape)
        o = fused_operands(torch, g, (K,) + shape, torch.float32)
        args = (o["theta"], o["p"], o["g"], o["c"])
        plain = lambda bits: ref.fused_ec_update(*args, *bits, scalars=scalars,
                                                 stochastic_round=True)
        h1, h2 = ref.philox_bits(EC_KEY, 3, 9, K * N)
        philox = tuple(torch.from_numpy(h.view(np.int32)).cuda().view((K,) + shape)
                       for h in (h1, h2))
        pairs = [(ops.fused_ec_update(*args, bits=o["bits"], **EC_HYPER), plain(o["bits"])),
                 (ops.fused_ec_update(*args, seed=EC_KEY, leaf=3, step=9, **EC_HYPER),
                  plain(philox))]
        torch.cuda.synchronize()
        same = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in pairs]
        err = max((x - y).abs().max().item() for a, b in pairs for x, y in zip(a, b))
        t_out = torch.empty_like(o["theta"])
        launch = lambda: fe.launch(*args, None, None, t_out, o["p"], K=K, N=N, seed=EC_KEY,
                                   leaf=0, step=0, scalars=scalars, stochastic_round=True)
        ms, dev = time_ms(torch, launch), device_ms(torch, launch)
        b_ms, b_by = bound(ec_bytes(K, N), 0.0, "f32")
        path = "4-wide" if fe._vec(N, *args, t_out) else "1-wide"
        log(f"[fused_ec] paper leaf {shape} K={K} (N={N}, {path} path) f32: bitwise equal to the "
            f"plain version in parity mode {same[0]}, Philox mode {same[1]} (max abs err "
            f"{err:.3e}); {ms:.4f} ms by events, device {fmt_ms(dev)}, bound {b_ms:.6f} ms "
            f"({b_by})")
        if not all(same):
            raise AssertionError(f"fused_ec_update at the paper leaf {shape}: not bitwise equal "
                                 "to its plain version")
        max_err = max(max_err, err)
        rows[shape] = dict(shape=shape, N=N, path=path, ms=ms, device_ms=dev, bound_ms=b_ms)
        del o, args, pairs, philox, t_out
    steps = {}
    for model, shapes in models.items():
        tot = {k: sum(rows[s][k] or 0.0 for s in shapes) for k in ("ms", "device_ms", "bound_ms")}
        steps[model] = dict(tot, leaves=len(shapes))
        log(f"[fused_ec] one EC step of the paper's {model}, K={K}: {len(shapes)} launches, "
            f"{tot['ms']:.4f} ms by events, device {tot['device_ms']:.4f} ms, byte bound "
            f"{tot['bound_ms']:.4f} ms: launch-bound")
    torch.cuda.empty_cache()
    return dict(rows=list(rows.values()), steps=steps, err=max_err)


def phase_stationary_async(torch):
    """Async SGHMC (K = 4 workers, the paper's approach-I baseline) on the
    Gaussian target at s = 1 and 4, through the port's rollout, against the
    exact delay-augmented oracle at 3 sigma: the mean by the ESS of theta,
    the variance about the oracle's mean by the ESS of its own series."""
    from repro_torch import core
    from repro_torch.core import rng
    from repro_torch.run import rollout

    c = ASYNC_STATIONARY_CASE
    bad, out = [], {}
    for s, var in ASYNC_ORACLE_VAR.items():
        sampler = core.async_sghmc(step_size=c["eps"], num_workers=c["K"], friction=c["friction"],
                                   sync_every=s)
        p0 = torch.full((ASYNC_STATIONARY_D,), c["mu"] + 1.0, device="cuda")
        t0 = time.perf_counter()
        res = rollout(sampler, lambda th: c["lam"] * (th - c["mu"]), p0,
                      num_steps=STATIONARY_STEPS, keys=rng.split(rng.key(41 + s), STATIONARY_STEPS),
                      moments=False, chunk_steps=1000)
        wall = time.perf_counter() - t0
        traj = res.trace.cpu().numpy()[STATIONARY_BURN:][None].astype(np.float64)  # (1, T, D)
        checks = stationary_checks(traj, c["mu"], var, None)
        log(f"[stationary-async] Async SGHMC K={c['K']} workers, s={s}, "
            f"D={ASYNC_STATIONARY_D}, eps={c['eps']}, {STATIONARY_STEPS} steps (burn-in "
            f"{STATIONARY_BURN}) in {wall:.2f} s: "
            + "; ".join(f"{n} {got:.6f} vs oracle {want:.6f} (3 sigma {tol:.2e}, ESS {e:.0f})"
                        for n, got, want, tol, e in checks))
        bad += [f"s={s} {n}" for n, got, want, tol, _ in checks if not abs(got - want) < tol]
        out[s] = dict(wall=wall, checks=checks)
    if bad:
        raise AssertionError(f"on-card Async SGHMC {bad} miss the oracle")
    return out


def phase_sweep(torch):
    """Fig. 1 as swept runs: the 2-D Gaussian N((2, -1), I) from (-2, 3),
    600 steps; SGHMC (eps 1e-2, V 1) over 8 seeds and fused EC-SGHMC (K = 4,
    alpha 1, V = C = 1, s 1, eq6 noise) over 2 seeds, each through
    ``ChainExecutor.run(..., sweep=True)``, every swept run held bitwise
    against its member run on the card.  Records benchmarks/fig1's worst
    mean NLL over the first 150 steps and the late cross-run / cross-chain
    spread."""
    from repro_torch import core
    from repro_torch import diagnostics as diag
    from repro_torch.core import rng
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.run import ChainExecutor, stack_runs

    mu = torch.tensor([2.0, -1.0], device="cuda")
    start = torch.tensor([-2.0, 3.0], device="cuda")
    nll = lambda x: 0.5 * np.sum((x - np.array([2.0, -1.0])) ** 2, axis=-1)
    K = 4

    def swept(label, make, p1, seeds):
        keys = [rng.split(rng.key(s), FIG1_STEPS) for s in seeds]
        ex = ChainExecutor(sampler=make(), grad_fn=lambda t, _b: t - mu, trace_fn=lambda p: p,
                           chunk_steps=FIG1_STEPS, key_mode="keys")
        p0 = p1[None].repeat((len(seeds),) + (1,) * p1.ndim)
        st0 = stack_runs([make().init(p0[i]) for i in range(len(seeds))])
        torch.cuda.synchronize()
        reset_launches()
        res = ex.run(p0, st0, num_steps=FIG1_STEPS, keys=keys, sweep=True)
        n_launch = launches["fused_ec_update"]
        members = [ChainExecutor(sampler=make(), grad_fn=lambda t, _b: t - mu,
                                 trace_fn=lambda p: p, chunk_steps=FIG1_STEPS, key_mode="keys")
                   .run(p1.clone(), make().init(p1.clone()), num_steps=FIG1_STEPS, keys=k).trace
                   for k in keys]
        same = all(torch.equal(res.trace[i], m) for i, m in enumerate(members))
        log(f"[sweep] {label}: {len(seeds)} runs x {FIG1_STEPS} steps swept in {res.wall_s:.3f} s "
            f"({1e6 * res.wall_s / (FIG1_STEPS * len(seeds)):.1f} us per run step); swept == "
            f"per-member runs bitwise: {same}; fused_ec_update launches {n_launch}")
        if not same:
            raise AssertionError(f"[sweep] {label}: the swept runs differ from their member runs")
        return res.trace.cpu().numpy(), res.wall_s, n_launch

    t_sg, w_sg, _ = swept("SGHMC", lambda: core.sghmc(step_size=1e-2, friction=1.0), start,
                          FIG1_SG_SEEDS)
    ec = lambda: core.ec_sghmc(step_size=1e-2, alpha=1.0, friction=1.0, center_friction=1.0,
                               sync_every=1, noise_convention="eq6", fused=True)
    t_ec, w_ec, n_ec = swept("EC-SGHMC K=4 fused", ec, start[None].repeat(K, 1), FIG1_EC_SEEDS)
    if n_ec != FIG1_STEPS * len(FIG1_EC_SEEDS):
        raise AssertionError(f"[sweep] fused_ec_update launched {n_ec} times, not "
                             f"{FIG1_STEPS * len(FIG1_EC_SEEDS)}")
    sg_worst = float(max(nll(t_sg[r, :150]).mean() for r in range(len(FIG1_SG_SEEDS))))
    ec_worst = float(max(nll(t_ec[g, :150, i]).mean() for g in range(len(FIG1_EC_SEEDS))
                         for i in range(K)))
    sg_spread = float(diag.cross_chain_spread(torch.from_numpy(t_sg[:, 400:])))
    ec_spread = float(diag.cross_chain_spread(torch.from_numpy(np.moveaxis(t_ec[0, 400:], 1, 0))))
    finite = np.isfinite(t_sg).all() and np.isfinite(t_ec).all()
    log(f"[sweep] Fig. 1: worst mean NLL over the first 150 steps SGHMC {sg_worst:.3f} (worst of "
        f"{len(FIG1_SG_SEEDS)} runs), EC-SGHMC {ec_worst:.3f} (worst of "
        f"{len(FIG1_EC_SEEDS) * K} chains); late spread across SGHMC runs {sg_spread:.4f}, across "
        f"EC chains {ec_spread:.4f}; the paper's claim (EC coherent and faster to the mode): "
        f"{'held' if ec_worst < sg_worst and ec_spread < sg_spread else 'not held'} (recorded, "
        "not asserted)")
    if not finite:
        raise AssertionError("[sweep] non-finite trajectory")
    return dict(sg_worst=sg_worst, ec_worst=ec_worst, sg_spread=sg_spread, ec_spread=ec_spread,
                sg_wall=w_sg, ec_wall=w_ec, launches=n_ec)


def noise_sampler(inner, noises):
    """``inner`` with step t's noise taken from ``noises[t]`` (the draws a
    card-against-CPU check hands both sides)."""
    from repro_torch.core import Sampler

    return Sampler(inner.init,
                        lambda g, st, p, rng=None: inner.update(g, st, p, None,
                                                                noise=noises[st.step]),
                        inner.grad_targets, inner.stats)


def paper_samplers(core, job, eps, fric):
    """The samplers of benchmarks/fig2_*.py: ``sghmc``, ``ec_s<s>`` (K = 6
    fused EC-SGHMC, eq4 noise, no center noise in p) and ``async_s<s>``
    (6 workers).  Returns (sampler, chains, workers)."""
    if job == "sghmc":
        return core.sghmc(step_size=eps, friction=fric), 1, 1
    s = int(job.split("_s")[1])
    if job.startswith("ec"):
        return core.ec_sghmc(step_size=eps, friction=fric, center_friction=fric, alpha=1.0,
                             sync_every=s, noise_convention="eq4", center_noise_in_p=False,
                             fused=True), PAPER_K, PAPER_K
    return core.async_sghmc(step_size=eps, friction=fric, num_workers=PAPER_K,
                            sync_every=s), 1, PAPER_K


def phase_smoke_paper(torch):
    """The paper's two models at a small width (MLP hidden 32, ResNet-32 at
    width 4), card against CPU: the same params, data, batches and noise
    through ``ChainExecutor`` and ``ShardedLoader``, 12 steps of fused
    EC-SGHMC in parity-bits mode (K = 6) and of Async SGHMC (6 workers,
    s = 2, the normals handed in), within [smoke-train]'s atol."""
    from repro_torch import core
    from repro_torch.core import potential
    from repro_torch.data import ShardedLoader, synthetic_cifar10, synthetic_mnist
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_params, mlp, resnet, tree_leaves, tree_map
    from repro_torch.run import ChainExecutor

    eps, fric = sgd_map(PAPER_LR, PAPER_BETA)
    K, steps = PAPER_K, SMOKE_PAPER_STEPS
    models = {"mlp": (mlp, mlp.param_specs(hidden=32), synthetic_mnist),
              "resnet": (resnet, resnet.param_specs(width=4), synthetic_cifar10)}
    out = {}
    bs = SMOKE_PAPER_BATCH
    for name, (mod, specs, data_fn) in models.items():
        x, y = data_fn(SMOKE_PAPER_N, seed=3, device="cpu")
        p1 = init_params(specs, torch.Generator().manual_seed(21), device="cpu")
        for job in ("ec_s2", "async_s2"):
            gen = torch.Generator().manual_seed(22)
            if job.startswith("ec"):
                base = tree_map(lambda v: v[None].repeat((K,) + (1,) * v.ndim), p1)
                noises = [{"p": tree_map(lambda v: tuple(
                    torch.randint(-2**31, 2**31 - 1, v.shape, generator=gen, dtype=torch.int32)
                    for _ in range(2)), base),
                           "r": tree_map(lambda v: torch.randn(v.shape, generator=gen), p1)}
                          for _ in range(steps)]
            else:
                base = p1
                noises = [tree_map(lambda v: torch.randn(v.shape, generator=gen), p1)
                          for _ in range(steps)]
            res = {}
            for dev in ("cpu", "cuda"):
                to = lambda t: tree_map(
                    lambda v: (tuple(b.to(dev) for b in v) if isinstance(v, tuple)
                               else v.to(dev, copy=True)), t)
                samp, _, workers = paper_samplers(core, job, eps, fric)
                params = to(base)
                pot = potential.make_potential(mod.nll_fn, n_data=SMOKE_PAPER_N,
                                               prior=potential.gaussian_prior(PAPER_PRIOR))
                loader = ShardedLoader(x, y, bs, workers, seed=4, device=dev)
                ex = ChainExecutor(sampler=noise_sampler(samp, [to(n) for n in noises]),
                                   grad_fn=potential.chainwise(pot).grad,
                                   batch_fn=loader.batch,
                                   chunk_steps=4, key_mode="keys")
                reset_launches()
                res[dev] = ex.run(params, samp.init(params), num_steps=steps,
                                  keys=list(range(steps)))
                if dev == "cuda" and job.startswith("ec"):
                    want = steps * len(tree_leaves(params))
                    if launches["fused_ec_update"] != want:
                        raise AssertionError(f"[smoke-paper] {name} {job}: fused_ec_update "
                                             f"launched {launches['fused_ec_update']}, not {want}")
            fields = ("momentum", "center") if job.startswith("ec") else ("momentum", "snapshots")
            gap = lambda card_tree, cpu_tree: max(
                (a.cpu() - b).abs().max().item()
                for a, b in zip(tree_leaves(card_tree), tree_leaves(cpu_tree)))
            diffs = {f: gap(getattr(res["cuda"].state, f), getattr(res["cpu"].state, f))
                     for f in fields}
            diffs["params"] = gap(res["cuda"].params, res["cpu"].params)
            log(f"[smoke-paper] {name} {job}, {steps} steps, noise handed in: card vs CPU max diff "
                + ", ".join(f"{f} {d:.3e}" for f, d in diffs.items())
                + f" (atol {SMOKE_TRAIN_ATOL})")
            if max(diffs.values()) > SMOKE_TRAIN_ATOL:
                raise AssertionError(f"[smoke-paper] {name} {job}: the card disagrees with the CPU")
            out[f"{name}/{job}"] = diffs
    return out


def posterior_run(torch, mod, params, sampler, chains, workers, data, *, n_data, batch, steps,
                  eval_every, seed):
    """One job of the paper's Fig. 2 driver (benchmarks/posterior_driver.py's
    run_sampling, not ported as a file): the sampler through
    ``ChainExecutor`` in chunks of ``eval_every`` steps, each chain or worker
    drawing its own minibatch from ``ShardedLoader``, the chains' or workers'
    gradients in one ``torch.func.vmap`` pass (the reference's ``jax.vmap``); at every chunk
    boundary the predictive NLL on the test set of the current chains'
    mixture, and the BMA NLL of every evaluation after the burn-in.  Returns
    (curve, the step-0 NLL, wall s, evaluation s, RunResult, the executor)."""
    from repro_torch.core import potential
    from repro_torch.data import ShardedLoader
    from repro_torch.models import tree_map
    from repro_torch.run import ChainExecutor

    (xtr, ytr), (xt, yt) = data
    pot = potential.make_potential(mod.nll_fn, n_data=n_data,
                                   prior=potential.gaussian_prior(PAPER_PRIOR))
    grad_fn = potential.chainwise(pot).grad if workers > 1 else pot.grad
    loader = ShardedLoader(xtr, ytr, batch, workers, seed=seed, device=xtr.device)
    gold = yt.long()[:, None]

    def chain_probs(p):
        members = [tree_map(lambda v: v[k], p) for k in range(chains)] if chains > 1 else [p]
        with torch.no_grad():
            return sum(torch.softmax(mod.apply(m, xt).float(), -1) for m in members)

    def predictive_nll(prob_sum, n):
        logp = torch.log(torch.clamp(prob_sum / n, min=1e-12))
        return -torch.mean(torch.gather(logp, -1, gold)[:, 0]).item()

    burnin = int(steps * PAPER_BURNIN)
    nll0 = predictive_nll(chain_probs(params), chains)
    acc = {"sum": None, "n": 0, "eval_s": 0.0}
    curve = []

    def on_chunk(step_end, p, st, outs):
        t0 = time.perf_counter()
        cur = chain_probs(p)
        if step_end - 1 >= burnin:
            acc["sum"] = cur if acc["sum"] is None else acc["sum"] + cur
            acc["n"] += chains
        now = predictive_nll(cur, chains)
        bma = predictive_nll(acc["sum"], acc["n"]) if acc["n"] else now
        curve.append({"step": step_end, "nll": now, "nll_bma": bma})
        acc["eval_s"] += time.perf_counter() - t0

    ex = ChainExecutor(sampler=sampler, grad_fn=grad_fn, batch_fn=loader.batch,
                       chunk_steps=eval_every, key_mode="fold")
    res = ex.run(params, sampler.init(params), num_steps=steps, key=seed + 1, on_chunk=on_chunk)
    return curve, nll0, res.wall_s, acc["eval_s"], res, ex


PAPER_CLASSES = (  # (label, substrings of a device kernel's name), first match wins
    ("fused EC kernel", ("ec_update",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "winograd")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "cublas", "splitKreduce", "xmma")),
    ("copies and casts", ("copy",)),
)
PAPER_PROFILE_STEPS = 20


def profile_paper_steps(torch, label, job, ex, res, steps, card):
    """``PAPER_PROFILE_STEPS`` more steps of a finished job, once on the wall
    clock and once under torch.profiler: device time by kernel class and
    the device's busy share of the profiled window's own wall clock (the
    profiler slows the host, so the share is a lower bound on the
    unprofiled run's)."""
    from torch.profiler import ProfilerActivity, profile

    def more(start):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.run(res.params, res.state, num_steps=PAPER_PROFILE_STEPS, key=7, start_step=start)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    wall = more(steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pwall = more(steps + PAPER_PROFILE_STEPS)
    kernels = device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    busy_us, streams = device_busy(prof)
    if device_us <= 0:
        log(f"[{label}-profile] torch.profiler recorded no device time: busy share not measured")
        return None
    split = {}
    for e in kernels:
        lab = next((lab for lab, keys in PAPER_CLASSES if any(k in e.key for k in keys)),
                   "other elementwise and reductions")
        split[lab] = split.get(lab, 0.0) + e.self_device_time_total / 1e3
    n = sum(e.count for e in kernels)
    log(f"[{label}-profile] {job}, {PAPER_PROFILE_STEPS} steps: wall {wall:.3f} s without the "
        f"profiler ({1e3 * wall / PAPER_PROFILE_STEPS:.2f} ms/step); under it wall {pwall:.3f} s, "
        f"device kernels {device_us / 1e6:.4f} s summed, busy {busy_us / 1e6:.4f} s on {streams} "
        f"stream(s) = {100 * busy_us / 1e6 / pwall:.1f}% busy, {n} kernels "
        f"({n / PAPER_PROFILE_STEPS:.0f} per step) [{card}]")
    for lab, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        log(f"[{label}-profile]   {100 * ms * 1e3 / device_us:5.1f}%  {ms:9.3f} ms  {lab}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[{label}-profile]   {100 * e.self_device_time_total / device_us:5.1f}%  "
            f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:80]}")
    return dict(wall=wall, profiled_wall=pwall, device_ms=device_us / 1e3, busy_ms=busy_us / 1e3,
                kernels=n, split=split)


def phase_paper(torch, card, label, mod, specs, data_fn, n_train, n_test, batch, jobs, steps,
                eval_every, profile_job):
    """One Fig. 2 experiment at the paper's size: each job from the same
    seeded init (chains start equal, as the reference's driver starts
    them), on the same synthetic data.  Checks every NLL finite, each
    job's final BMA NLL below its step-0 NLL, and ``fused_ec_update``'s
    launches (a leaf per step) on the EC jobs.  Records s/step and the
    final BMA NLLs, and profiles a few more steps of ``profile_job``."""
    from repro_torch import core
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_params, tree_leaves, tree_map

    eps, fric = sgd_map(PAPER_LR, PAPER_BETA)
    reset_peak(torch)
    x, y = data_fn(n_train + n_test, seed=0, device="cuda")
    data = ((x[:n_train], y[:n_train]), (x[n_train:], y[n_train:]))
    p1 = init_params(specs, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(v.numel() for v in tree_leaves(p1))
    log(f"[{label}] {n_params} parameters, {len(tree_leaves(p1))} leaves; synthetic data "
        f"{tuple(x.shape)} ({n_train} train, {n_test} test); batch {batch} per chain or worker, "
        f"eps {eps:.6g}, V {fric:.6g} (sgd_map lr {PAPER_LR}, beta {PAPER_BETA}), prior "
        f"{PAPER_PRIOR}, {steps} steps, evaluated every {eval_every}")
    out, counts = {}, {}
    for job in jobs:
        sampler, chains, workers = paper_samplers(core, job, eps, fric)
        params = (tree_map(lambda v: v[None].repeat((chains,) + (1,) * v.ndim), p1) if chains > 1
                  else tree_map(torch.clone, p1))
        torch.cuda.synchronize()
        reset_launches()
        curve, nll0, wall, eval_s, res, ex = posterior_run(
            torch, mod, params, sampler, chains, workers, data, n_data=n_train, batch=batch,
            steps=steps, eval_every=eval_every, seed=1)
        counts[job] = launches["fused_ec_update"]
        final = curve[-1]
        per_step = (wall - eval_s) / steps
        log(f"[{label}] {job}: step-0 NLL {nll0:.4f}; NLL at "
            + ", ".join(f"{c['step']}: {c['nll']:.4f}" for c in curve[:: max(len(curve) // 5, 1)])
            + f"; final {final['nll']:.4f}, BMA {final['nll_bma']:.4f}; {wall:.2f} s "
            f"({eval_s:.2f} s evaluating), {per_step * 1e3:.2f} ms/step; fused_ec_update "
            f"launches {counts[job]} [{card}]")
        nlls = [v for c in curve for v in (c["nll"], c["nll_bma"])]
        if not all(math.isfinite(v) for v in nlls):
            raise AssertionError(f"[{label}] {job}: a non-finite NLL")
        if not final["nll_bma"] < nll0:
            raise AssertionError(f"[{label}] {job}: final BMA NLL {final['nll_bma']} is not below "
                                 f"the step-0 NLL {nll0}")
        want = steps * len(tree_leaves(p1)) if job.startswith("ec") else 0
        if counts[job] != want:
            raise AssertionError(f"[{label}] {job}: fused_ec_update launched {counts[job]} "
                                 f"times, not {want}")
        out[job] = dict(nll0=nll0, final=final, per_step_s=per_step, wall=wall, eval_s=eval_s,
                        curve=curve)
        if job == profile_job:
            out[job]["profile"] = profile_paper_steps(torch, label, job, ex, res, steps, card)
        del params, sampler, res, ex
        gc.collect()
    finals = {j: o["final"]["nll_bma"] for j, o in out.items()}
    if "async_s8" in out:
        held = (finals["ec_s8"] - finals["ec_s1"]) <= (finals["async_s8"] - finals["async_s1"])
        log(f"[{label}] final BMA NLL {finals}; the paper's claim, EC-SGHMC degrades less than "
            f"Async SGHMC from s=1 to s=8: {'held' if held else 'not held'} (ec_s8 "
            f"{finals['ec_s8']:.4f} vs async_s8 {finals['async_s8']:.4f}; recorded, not asserted)")
    else:
        log(f"[{label}] final BMA NLL {finals}; EC-SGHMC below SGHMC: "
            f"{finals['ec_s4'] < finals['sghmc']} (recorded, not asserted)")
    log(f"[{label}] peak device memory {gib(torch.cuda.max_memory_allocated())}")
    del x, y, data, p1
    reset_peak(torch)
    return counts, out


def phase_paper_mlp(torch, card):
    from repro_torch.data import synthetic_mnist
    from repro_torch.models import mlp

    return phase_paper(torch, card, "paper-mlp", mlp, mlp.param_specs(), synthetic_mnist,
                       MLP_TRAIN, MLP_TEST, MLP_BATCH,
                       ("sghmc", "ec_s1", "ec_s8", "async_s1", "async_s8"), MLP_STEPS, MLP_EVAL,
                       "ec_s8")


def phase_paper_resnet(torch, card):
    from repro_torch.data import synthetic_cifar10
    from repro_torch.models import resnet

    return phase_paper(torch, card, "paper-resnet", resnet, resnet.param_specs(width=RESNET_WIDTH),
                       synthetic_cifar10, RESNET_TRAIN, RESNET_TEST, RESNET_BATCH,
                       ("sghmc", "ec_s4"), RESNET_STEPS, RESNET_EVAL, "ec_s4")


# ---------------------------------------------------------------------------
# serving meets sampling: live refresh, the launchers, checkpointed training
# ---------------------------------------------------------------------------

QWEN_V = 151936
REFRESH_EVERY = 8  # decode ticks per sampler chunk of 16 steps (launch/serve.py's chunk)
REFRESH_TOTAL_STEPS = 128  # 8 proposals: both refreshers exhaust within or just after a run
# the refresh phases and the serve launcher serve 8 requests of the [slice]
# trace's 16 (its first 8 when drawn with the same seed): the script's time
# budget
REFRESH_REQUESTS = 8
# back-to-back (frozen, overlapped) pairs, as DESIGN.md section 9 pairs them;
# one pair keeps the script's phases within their time budget
REFRESH_PAIRS = 1
EC_REFRESH_STEP = 1e-3  # EC-SGHMC over the bootstrap prior: a chunk spreads the chains past the gate
CKPT_LAYERS = 2  # [ckpt]: qwen3-0.6b widths, depth cut from 28 and
CKPT_K = 2  # the chains from 4, so one checkpoint is ~6 GB: the disk sets the phase's time
# a checkpoint every 4 steps, not 2: two ~10 GB saves instead of four, each
# bound by the disk
CKPT_STEPS, CKPT_EVERY, CKPT_PREEMPT, CKPT_KEEP = 8, 4, 4, 2
LAUNCH_TRAIN_STEPS = 10  # launch/train.py logs every 10 steps (LoopConfig's default)


def reset_peak(torch):
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def gib(x) -> str:
    return f"{x / 2**30:.2f} GiB"


def check_served(rep, n_req, max_new, V, label):
    """Every request retired with max_new tokens in the vocabulary."""
    if len(rep.results) != n_req:
        raise AssertionError(f"{label}: {len(rep.results)} of {n_req} requests retired")
    for r in rep.results:
        t = r.tokens
        if r.truncated or t.size != max_new or t.min() < 0 or t.max() >= V:
            raise AssertionError(f"{label}: request {r.rid} bad: {t.size} tokens, "
                                 f"truncated={r.truncated}, range [{t.min()}, {t.max()}]")


def check_health(rep, label):
    """The last gated candidate's spread report: finite norms mean every
    member element was finite."""
    h = rep.registry["last_health"]
    if h is None or not (math.isfinite(h["mean_param_norm"]) and math.isfinite(h["rel_spread"])):
        raise AssertionError(f"{label}: the members are not finite: {h}")
    return h


def phase_serve_launch(torch, card):
    """``repro_torch.launch.serve.main`` at full-width qwen3-0.6b: the engine
    with K = 4 and overlapped live refresh every 8 ticks, then the
    non-engine ``--ensemble 4`` path."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import serve as serve_launch

    from repro_torch.obs import trace as obs_trace

    common = ["--arch", "qwen3-0.6b", "--ensemble", "4", "--prompt-len", "128", "--gen", "32"]
    trace_path = OUT / "serve_launch_trace.json"
    engine_args = common + ["--engine", "--slots", "8", "--requests", str(REFRESH_REQUESTS),
                            "--refresh-every", str(REFRESH_EVERY), "--trace", str(trace_path)]
    reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    rep = serve_launch.main(engine_args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    obs_trace.disable()  # main leaves its tracer installed
    validated = check_trace(trace_path, "serve", "serve-launch")
    counts, peak = dict(launches), torch.cuda.max_memory_allocated()
    check_served(rep, REFRESH_REQUESTS, 32, QWEN_V, "serve-launch")
    rf = rep.refresher
    h = check_health(rep, "serve-launch")
    pct = rep.latency_percentiles()
    log(f"[serve-launch] launch.serve.main({' '.join(engine_args)}): {rep.total_tokens} tokens, "
        f"{rep.decode_steps} ticks, {rep.tokens_per_s:.1f} tok/s, latency p50 "
        f"{pct['latency_p50_s']:.3f} s p99 {pct['latency_p99_s']:.3f} s, first token p99 "
        f"{pct['first_token_p99_s']:.3f} s; registry version {rep.registry['version']}, "
        f"promotions {rf['promotions']}, rejections {rf['rejections']}, {rf['steps_done']} "
        f"sampler steps in {rf['micro_chunks']} micro-chunks, pump {rf['pump_wall_s']:.3f} s, "
        f"stall {rf['stall_wall_s']:.3f} s; last rel_spread {h['rel_spread']:.3e}; launches "
        f"{counts}; peak {gib(peak)}; {wall:.1f} s with the bootstrap [{card}]")
    if not rep.registry["version"] == rf["promotions"] >= 1:
        raise AssertionError(f"serve-launch: registry version {rep.registry['version']} vs "
                             f"{rf['promotions']} promotions")
    if min(counts["flash_attention"], counts["bma_select"]) <= 0:
        raise AssertionError(f"serve-launch missed a kernel of its path: {counts}")
    engine = dict(tokens_per_s=rep.tokens_per_s, promotions=rf["promotions"], peak=peak,
                  launches=counts, refresher=rf, trace=validated, **pct)
    del rep
    reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    toks = serve_launch.main(common)
    wall = time.perf_counter() - t0
    counts2, peak2 = dict(launches), torch.cuda.max_memory_allocated()
    log(f"[serve-launch] launch.serve.main({' '.join(common)}): tokens {tuple(toks.shape)} in "
        f"{wall:.1f} s with the bootstrap; launches {counts2}; peak {gib(peak2)} [{card}]")
    if tuple(toks.shape) != (4, 32) or int(toks.min()) < 0 or int(toks.max()) >= QWEN_V:
        raise AssertionError(f"serve-launch ensemble path: tokens {toks}")
    if counts2["flash_attention"] <= 0:
        raise AssertionError(f"serve-launch ensemble path missed flash_attention: {counts2}")
    reset_peak(torch)
    return dict(engine=engine, ensemble=dict(wall=wall, launches=counts2, peak=peak2))


def check_trace(path, profile, label):
    """``repro_torch.obs.validate`` on an exported trace with ``--require
    profile``; its lines are printed, and a trace it refuses fails the
    phase."""
    from repro_torch.obs import validate

    rc = validate.main([str(path), "--require", profile])
    events = len(json.loads(pathlib.Path(path).read_text())["traceEvents"])
    log(f"[{label}] trace {path.name}: {events} events, validator exit {rc} (profile {profile})")
    if rc != 0:
        raise AssertionError(f"[{label}] the trace fails the {profile} profile")
    return dict(path=str(path.relative_to(ROOT)), events=events, profile=profile)


def refresh_setup(torch, card):
    """What ``[refresh]`` and ``[refresh-ec]`` share: the qwen3-0.6b paged
    engine and the first ``REFRESH_REQUESTS`` requests of the ``[slice]``
    trace, one bootstrap ensemble (kept on the
    host, so no run holds a spare 9.6 GB stack on the card) and ``serve``,
    which serves the trace from that ensemble, frozen or with a refresher
    as ``launch/serve.py::_live_refresher`` builds it (with a finite
    ``total_steps``), checks it, and logs and returns its row."""
    from repro_torch import configs, core
    from repro_torch.core import rng as rnglib
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import get_model, tree_leaves, tree_map
    from repro_torch.serve.engine import (ChainRefresher, RefreshScheduler, ServeEngine,
                                          SnapshotRegistry, synthetic_trace)

    cfg = configs.get_config("qwen3-0.6b").replace(use_flash_kernel=True)
    model = get_model(cfg)
    specs = model.param_specs(cfg)
    key = rnglib.key(0)
    reset_peak(torch)
    t0 = time.perf_counter()
    members, res = serve_launch._bootstrap_ensemble(specs, key, 4, "cuda")
    torch.cuda.synchronize()
    boot_s, boot_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    log(f"[refresh] bootstrap: K=4 members from one SGLD chain ({res.steps} steps, thin 16) in "
        f"{boot_s:.2f} s, {res.steps_per_s:.1f} steps/s, peak {gib(boot_peak)} [{card}]")
    host_members = tree_map(lambda a: a.cpu(), members)
    del members, res
    trace = synthetic_trace(REFRESH_REQUESTS, vocab_size=QWEN_V, prompt_lens=(64, 128),
                            max_new=32, seed=0)
    kw = dict(num_slots=8, max_seq=128 + 32, paged=True, device="cuda")

    def serve(label, mode=None, sampler=None, tag="refresh", sync_every=None):
        reg = SnapshotRegistry(tree_map(lambda a: a.to("cuda"), host_members))
        ref = None
        if mode is not None:
            center = serve_launch._init(specs, key, "cuda")
            start = tree_map(lambda x: x[None].expand((4,) + tuple(x.shape)).contiguous(), center)
            cls = RefreshScheduler if mode == "overlapped" else ChainRefresher
            ref = cls(reg, sampler or core.sgld(step_size=serve_launch._EPS),
                      serve_launch._prior_grad(center), start, key=rnglib.fold_in(key, 2),
                      chunk_steps=16, total_steps=REFRESH_TOTAL_STEPS,
                      **({"sync_every": sync_every} if sync_every else {}))
            del center, start
        eng = ServeEngine(cfg, model, reg, refresher=ref,
                          refresh_every=REFRESH_EVERY if ref is not None else 0, **kw)
        reset_peak(torch)
        reset_launches()
        rep = eng.run(trace)
        torch.cuda.synchronize()
        counts, peak = dict(launches), torch.cuda.max_memory_allocated()
        check_served(rep, len(trace), 32, QWEN_V, f"{tag} {label}")
        if mode is not None:
            check_health(rep, f"{tag} {label}")
        if min(counts[n] for n in SERVING_KERNELS) <= 0:
            raise AssertionError(f"{tag} {label} missed a serving kernel: {counts}")
        pct = rep.latency_percentiles()
        rf = rep.refresher or {}
        ticks = max(rep.decode_steps, 1)
        row = dict(label=label, tokens_per_s=rep.tokens_per_s, wall=rep.wall_s,
                   ticks=rep.decode_steps, peak=peak, launches=counts,
                   promotions=rep.registry["version"], rejections=rep.registry["rejected"],
                   micro_chunks=rf.get("micro_chunks", 0), steps_done=rf.get("steps_done", 0),
                   pump_wall_s=rf.get("pump_wall_s", rf.get("refresh_wall_s", 0.0)),
                   stall_wall_s=rf.get("stall_wall_s", 0.0),
                   flips_deferred=rf.get("flips_deferred", 0),
                   backpressure_ticks=rf.get("backpressure_ticks", 0),
                   decode_steps_stalled=rf.get("decode_steps_stalled", 0), **pct)
        log(f"[{tag}] {label}: {rep.total_tokens} tokens, {rep.decode_steps} ticks, "
            f"{rep.tokens_per_s:.2f} tok/s, latency p50 {pct['latency_p50_s']:.3f} s p99 "
            f"{pct['latency_p99_s']:.3f} s, first token p50 {pct['first_token_p50_s']:.3f} s "
            f"p99 {pct['first_token_p99_s']:.3f} s; promotions {row['promotions']}, rejections "
            f"{row['rejections']}, {row['steps_done']} sampler steps in {row['micro_chunks']} "
            f"micro-chunks; pump {row['pump_wall_s']:.3f} s = "
            f"{1e3 * row['pump_wall_s'] / ticks:.1f} ms per tick against "
            f"{1e3 * rep.wall_s / ticks:.1f} ms of wall per tick; stall "
            f"{row['stall_wall_s']:.3f} s ({row['decode_steps_stalled']} ticks), deferred flips "
            f"{row['flips_deferred']}, backpressure ticks {row['backpressure_ticks']}; peak "
            f"{gib(peak)}; launches {counts} [{card}]")
        return reg, ref, row

    ServeEngine(cfg, model, SnapshotRegistry(tree_map(lambda a: a.to("cuda"), host_members)),
                **kw).run(warmup_trace(QWEN_V))
    return dict(cfg=cfg, serve=serve, n_leaves=len(tree_leaves(host_members)),
                bootstrap_s=boot_s, bootstrap_peak=boot_peak)


def phase_refresh(torch, card, setup):
    """The ``[slice]`` paged engine and 8 of its trace's requests with the sync
    ``ChainRefresher``, then ``REFRESH_PAIRS`` back-to-back (frozen,
    overlapped ``RefreshScheduler``) pairs, over the launcher's SGLD on the
    bootstrap prior.  Each overlapped run's final chain stack must equal
    the sync one's bit for bit after the same total steps.  (Serving at a
    high stream priority, an experiment that ran here through PR 22, waits
    for a benchmark cell: ROADMAP 5d.)"""
    from repro_torch.models import tree_leaves, tree_map

    serve = setup["serve"]

    def check_final(reg, ref, label):
        version, final = final_stack(reg, ref, label)
        same = version == sync_version and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(final), tree_leaves(sync_final)))
        log(f"[refresh] {label} vs sync after {REFRESH_TOTAL_STEPS} steps: promotions "
            f"{version} vs {sync_version}, final chain stack bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{label}: the overlapped refresh diverged from the sync one")
        return same

    def final_stack(reg, ref, label):
        """Run the refresher to total_steps (the sync surface, after the
        serving run) and return its last promoted stack on the host."""
        while not ref.exhausted:
            ref.refresh()
        if reg.staged is not None or ref.steps_done != REFRESH_TOTAL_STEPS:
            raise AssertionError(f"{label}: refresher stopped at {ref.steps_done} steps")
        torch.cuda.synchronize()
        return reg.version, tree_map(lambda a: a.cpu(), reg.members)

    reg, ref, sync_row = serve("sync ChainRefresher", "sync")
    sync_version, sync_final = final_stack(reg, ref, "sync")
    del reg, ref
    rows, matches = [], []
    for i in range(REFRESH_PAIRS):
        _, _, frozen = serve(f"frozen #{i + 1}")
        reg, ref, over = serve(f"overlapped RefreshScheduler #{i + 1}", "overlapped")
        matches.append(check_final(reg, ref, f"overlapped #{i + 1}"))
        rows.append((frozen, over))
        del reg, ref
    p99 = [o["latency_p99_s"] / f["latency_p99_s"] for f, o in rows]
    over_tps = float(np.median([o["tokens_per_s"] for _, o in rows]))
    p99_ratio = float(np.median(p99))
    tps_ratio = over_tps / sync_row["tokens_per_s"]
    log(f"[refresh] overlapped/frozen latency p99 ratio per pair {['%.3f' % r for r in p99]}, "
        f"median {p99_ratio:.3f} (DESIGN.md section 9 target <= 1.2); overlapped/sync tok/s "
        f"{over_tps:.2f}/{sync_row['tokens_per_s']:.2f} = {tps_ratio:.2f}x (target >= 2x); "
        f"recorded, not asserted [{card}]")
    reset_peak(torch)
    return dict(sync=sync_row, pairs=rows, p99_ratio=p99_ratio, tps_ratio=tps_ratio,
                over_tps=over_tps, bitwise=matches, bootstrap_s=setup["bootstrap_s"],
                bootstrap_peak=setup["bootstrap_peak"])


def phase_refresh_ec(torch, card, setup, sgld_tps):
    """One overlapped run of the ``[refresh]`` engine and trace fed by fused
    EC-SGHMC (Philox, K = 4, sync every 4) over the same prior: at least
    one promotion and 13 ``fused_ec_update`` launches per sampler step."""
    from repro_torch import core
    from repro_torch.obs import trace as obs_trace

    samp = core.ec_sghmc(step_size=EC_REFRESH_STEP, alpha=1.0, friction=1.0,
                         center_friction=1.0, sync_every=4, fused=True,
                         state_dtype=setup["cfg"].param_dtype)
    tracer = obs_trace.enable()
    try:
        reg, ref, ec = setup["serve"]("overlapped RefreshScheduler, fused EC-SGHMC (Philox, "
                                      f"K=4, s=4, eps {EC_REFRESH_STEP:g}), traced",
                                      "overlapped", samp, tag="refresh-ec", sync_every=4)
        tracer.export(OUT / "refresh_ec_trace.json")
    finally:
        obs_trace.disable()
    ec["trace"] = check_trace(OUT / "refresh_ec_trace.json", "serve_ec", "refresh-ec")
    n_leaves = setup["n_leaves"]
    want = n_leaves * ec["steps_done"]
    log(f"[refresh-ec] fused_ec_update launches {ec['launches']['fused_ec_update']} for "
        f"{ec['steps_done']} sampler steps (expected {n_leaves} per step = {want}); serving "
        f"{ec['tokens_per_s']:.2f} tok/s against the SGLD overlapped median {sgld_tps:.2f} in "
        f"this call [{card}]")
    if ec["promotions"] < 1 or ec["launches"]["fused_ec_update"] != want or want <= 0:
        raise AssertionError(f"refresh-ec: {ec['promotions']} promotions, "
                             f"{ec['launches']['fused_ec_update']} fused launches, expected {want}")
    del reg, ref
    reset_peak(torch)
    return ec


def phase_ckpt(torch, card):
    """``train.loop.run`` with ``ckpt_dir``: fused EC-SGHMC (Philox) over the
    launcher's prior gradient at qwen3-0.6b's widths, depth cut to
    ``CKPT_LAYERS`` and ``CKPT_K`` chains; 8 steps preempted at 4 and
    resumed against an uninterrupted run, the loop's last checkpoint
    restored against the resumed state (a timed save/restore round trip),
    a truncated newest checkpoint, and an elastic restore to K = 6."""
    import shutil

    from repro_torch import configs, core
    from repro_torch.core import rng as rnglib
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import get_model, tree_leaves, tree_map
    from repro_torch.train import LoopConfig, Preempted, loop
    from repro_torch.train import checkpoint as ck

    cfg = configs.get_config("qwen3-0.6b").replace(num_layers=CKPT_LAYERS)
    model = get_model(cfg)
    K = CKPT_K
    samp = core.ec_sghmc(step_size=EC_REFRESH_STEP, alpha=1.0, friction=1.0, center_friction=1.0,
                         sync_every=4, fused=True, state_dtype=cfg.param_dtype)
    center = serve_launch._init(model.param_specs(cfg), rnglib.key(600), "cuda")
    grad = serve_launch._prior_grad(center)

    def step_fn(params, state, batch, rng_key):
        g = grad(params)
        upd, state = samp.update(g, state, params, rng_key)
        del g
        return core.apply_updates(params, upd), state, {}

    def fresh():
        params = stacked_members(torch, cfg, model, K, "cuda", seed0=500)
        return params, samp.init(params)

    def run(ckpt_dir=None, preempt_at=None):
        return loop.run(step_fn, *fresh(), lambda t: None,
                        LoopConfig(num_steps=CKPT_STEPS, ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                                   keep_ckpts=CKPT_KEEP, log_every=0, preempt_at=preempt_at,
                                   seed=3), num_chains=K, alpha=1.0)

    def leaves(params, state):
        return tree_leaves(params) + [x for f in state[:-1] for x in tree_leaves(f)]

    def same(a, b):
        return a[1].step == b[1].step and all(
            torch.equal(x, y) for x, y in zip(leaves(*a), leaves(*b)))

    root = OUT / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    reset_peak(torch)
    reset_launches()
    straight = run()[:2]
    n_leaves = len(tree_leaves(straight[0]))
    nbytes = sum(x.numel() * x.element_size() for x in leaves(*straight))
    free = shutil.disk_usage(root).free
    need = (CKPT_KEEP + 1) * nbytes
    log(f"[ckpt] qwen3-0.6b widths, depth cut to {CKPT_LAYERS} of 28 layers, K={K}, fused "
        f"EC-SGHMC over the bootstrap prior: one checkpoint {nbytes / 1e9:.2f} GB, disk free "
        f"{free / 1e9:.1f} GB (need {need / 1e9:.1f}) under {root}")
    if free < need:
        raise AssertionError(f"[ckpt] no room for the checkpoints: {free / 1e9:.1f} GB free, "
                             f"{need / 1e9:.1f} GB needed")
    saves = []
    loop_save = ck.save

    def timed_save(*args, **kw):  # the loop's own saves, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop_save(*args, **kw)
        saves.append(time.perf_counter() - t0)
        return out

    cut_dir = root / "loop"
    ck.save = timed_save
    try:
        try:
            run(str(cut_dir), preempt_at=CKPT_PREEMPT)
            raise AssertionError("[ckpt] the run was not preempted")
        except Preempted:
            pass
        kept = sorted(p.name for p in cut_dir.iterdir())
        t0 = time.perf_counter()
        resumed = run(str(cut_dir))[:2]
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        ck.save = loop_save
    counts, peak = dict(launches), torch.cuda.max_memory_allocated()
    bitwise = same(resumed, straight)
    want = n_leaves * (CKPT_STEPS + CKPT_STEPS)
    log(f"[ckpt] 8 steps, ckpt_every {CKPT_EVERY}, preempted at {CKPT_PREEMPT} (kept {kept}), "
        f"resumed in {resume_s:.1f} s (a restore, 4 steps, a save): final params and state "
        f"bitwise equal to the uninterrupted run: {bitwise}; fused_ec_update launches "
        f"{counts['fused_ec_update']} (expected {want}); peak {gib(peak)} [{card}]")
    if not bitwise or counts["fused_ec_update"] != want:
        raise AssertionError("[ckpt] the resumed run differs from the uninterrupted one")
    del straight

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, p, s, _ = ck.restore(cut_dir, *resumed)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    roundtrip = step == CKPT_STEPS and same((p, s), resumed) and leaves(p, s)[0].is_cuda
    save_s = float(np.median(saves))
    log(f"[ckpt] the loop's saves {['%.2f' % x for x in saves]} s (median "
        f"{nbytes / 1e9 / save_s:.2f} GB/s), restore of step {CKPT_STEPS} {restore_s:.2f} s "
        f"({nbytes / 1e9 / restore_s:.2f} GB/s) onto the card, {nbytes / 1e9:.2f} GB each; "
        f"bitwise round trip: {roundtrip} [{card}]")
    if not roundtrip:
        raise AssertionError("[ckpt] save -> restore is not a bitwise round trip")
    del p, s

    newest = sorted(cut_dir.glob("step_*"))[-1]
    with open(newest / "arrays.npz", "r+b") as f:
        f.truncate(f.seek(0, 2) // 2)
    got = ck.restore(cut_dir, *resumed)
    if got is None or got[0] != CKPT_PREEMPT:
        raise AssertionError(f"[ckpt] truncated {newest.name}: restore gave "
                             f"{None if got is None else got[0]}")
    fallback_center = got[2].center
    del got
    p6 = tree_map(lambda x: torch.empty((6,) + tuple(x.shape[1:]), dtype=x.dtype, device="cuda"),
                  resumed[0])
    s6 = samp.init(p6)
    del resumed
    step, p6, s6, extra = ck.restore_elastic(cut_dir, p6, s6, num_chains=6, alpha=1.0, seed=3)
    center_kept = all(torch.equal(a, b) for a, b in zip(tree_leaves(s6.center),
                                                        tree_leaves(fallback_center)))
    k6 = {int(x.shape[0]) for x in tree_leaves(p6)}
    log(f"[ckpt] truncated {newest.name}: restore fell back to step {CKPT_PREEMPT}; "
        f"restore_elastic to K=6 at step {step}: chain counts {k6}, center unchanged: "
        f"{center_kept}, {extra}")
    if k6 != {6} or step != CKPT_PREEMPT or not center_kept or not extra.get("elastic_resample"):
        raise AssertionError("[ckpt] elastic restore to K=6 failed")
    del p6, s6, fallback_center, center
    shutil.rmtree(root)
    reset_peak(torch)
    return dict(bytes=nbytes, save_s=saves, restore_s=restore_s, resume_s=resume_s,
                bitwise=bitwise, launches=counts, peak=peak)


def phase_launch_train(torch, card):
    """``repro_torch.launch.train.main`` at full-width qwen3-0.6b, 4 chains,
    no checkpoint: the nll per token of every logged step is finite.  It
    runs ``LAUNCH_TRAIN_STEPS`` = 10 steps because the launcher logs every
    10 (the loop's default cadence, as in the reference's launcher)."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import train as train_launch

    args = ["--arch", "qwen3-0.6b", "--steps", str(LAUNCH_TRAIN_STEPS), "--chains", "4"]
    reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    hist = train_launch.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nll = [m["nll_per_token"] for m in hist]
    log(f"[launch-train] launch.train.main({' '.join(args)}): logged steps "
        f"{[m['step'] for m in hist]}, nll per token {nll}, {wall:.1f} s with the init; "
        f"launches {dict(launches)} (unfused EC-SGHMC, as the reference launcher); peak "
        f"{gib(peak)} [{card}]")
    if not hist or not all(math.isfinite(v) for v in nll):
        raise AssertionError(f"launch-train: nll per token {nll}")
    reset_peak(torch)
    return dict(nll=nll, wall=wall, peak=peak)


# ---------------------------------------------------------------------------
# chains across ranks: the int8 center exchange, run_sharded over
# torch.distributed (one-rank NCCL at full width, two gloo ranks on one
# card at the SMOKE size), compressed parking
# ---------------------------------------------------------------------------

SHARD_K = 4
SHARD_SYNC = 4  # [train]'s s: 2 syncs in TRAIN_STEPS = 8 steps
SHARD_SCALE_SLACK = 1e-4  # |q*scale - x| <= scale/2 up to one more f32 rounding (127 * 2^-23)
SHARD2_STEPS = 8
SHARD2_SYNC = 2  # 4 syncs in 8 steps
SHARD2_ATOL = 1e-5  # alpha 1: 2 ranks' mean of 2-chain means vs the mean of 4, fed back 8 steps
SHARD2_STEP_SIZE = 1e-3
PARK_SLACK = 2.0 ** -8  # a restored bf16 value rounds the decoded f32 once more


def phase_codec(torch, cfg_full):
    """The int8 wire codec at the [shard] exchange's size: the f32 chain
    means of K = 4 qwen3-0.6b chains over all 13 leaves (5.96e8 elements)
    packed into one int8 buffer on the card, byte for byte the CPU port's
    encoding, and decoded bitwise alike; encode and decode timed by CUDA
    events (median of 5) against the byte bound (read 4 B, write ~1.016 B
    per element)."""
    from repro_torch.distributed import compression as cz

    g = torch.Generator(device="cuda").manual_seed(21)
    means = []
    for shape in qwen_leaf_shapes(cfg_full, SHARD_K):
        chains = 0.02 * torch.randn(shape, generator=g, device="cuda")
        means.append(torch.mean(chains, dim=0))
        del chains
    sizes = [cz.packed_nbytes(m.numel()) for m in means]
    offs = np.cumsum([0] + sizes).tolist()
    packed = torch.empty(offs[-1], dtype=torch.int8, device="cuda")

    def encode_all(out, leaves):
        for m, a, b in zip(leaves, offs, offs[1:]):
            cz.encode_packed(m, out=out[a:b])

    def decode_all():
        for m, a, b in zip(means, offs, offs[1:]):
            cz.decode_packed(packed[a:b], m.shape, m.numel())

    enc_ms = time_ms(torch, lambda: encode_all(packed, means), reps=5, warmup=1)
    dec_ms = time_ms(torch, decode_all, reps=5, warmup=1)
    n = sum(m.numel() for m in means)
    nbytes = 4 * n + offs[-1]
    b_ms, b_by = bound(nbytes, 0.0, "f32")
    t0 = time.perf_counter()
    host = torch.empty(offs[-1], dtype=torch.int8)
    encode_all(host, [m.cpu() for m in means])
    cpu_s = time.perf_counter() - t0
    card_bytes = packed.cpu()
    same_bytes = torch.equal(card_bytes, host)
    # decode the card's bytes on the card and on the CPU
    same_decode = all(
        torch.equal(cz.decode_packed(packed[a:b], m.shape, m.numel()).cpu().view(torch.int32),
                    cz.decode_packed(card_bytes[a:b], m.shape, m.numel()).view(torch.int32))
        for m, a, b in zip(means, offs, offs[1:]))
    log(f"[codec] packed means of K={SHARD_K} qwen3-0.6b chains, {len(means)} leaves, {n} "
        f"elements -> {offs[-1]} bytes ({offs[-1] / (4 * n):.4f} of f32): encode {enc_ms:.3f} ms "
        f"= {nbytes / enc_ms / 1e6:.1f} GB/s, decode {dec_ms:.3f} ms = "
        f"{nbytes / dec_ms / 1e6:.1f} GB/s; byte bound {b_ms:.3f} ms ({nbytes / 1e9:.3f} GB at "
        f"3.35 TB/s, {b_by}); card == CPU port: bytes {same_bytes}, decode bitwise "
        f"{same_decode} (CPU encode {cpu_s:.1f} s)")
    if not (same_bytes and same_decode):
        raise AssertionError("[codec] the card's int8 encoding differs from the CPU port's")
    del means, packed, host, card_bytes
    torch.cuda.empty_cache()
    return dict(n=n, packed_bytes=offs[-1], enc_ms=enc_ms, dec_ms=dec_ms, bound_ms=b_ms,
                enc_gbs=nbytes / enc_ms / 1e6, dec_gbs=nbytes / dec_ms / 1e6)


def _host(tree_leaves, tree):
    return [x.detach().cpu() for x in tree_leaves(tree)]


def _scale_gap(torch, got, want):
    """Largest |got - want| over half the int8 codec's block scale of
    ``want``, over all elements of a list of f32 leaves."""
    from repro_torch.distributed import int8_codec

    codec, worst = int8_codec(), 0.0
    for a, b in zip(got, want):
        b = b.to(a.device)
        enc = codec.encode(b)
        diff = (a.float() - b.float()).reshape(-1)
        diff = torch.nn.functional.pad(diff, (0, enc["q"].numel() - diff.numel()))
        half = 0.5 * enc["scale"].expand(-1, enc["q"].shape[1]).reshape(-1)
        worst = max(worst, (diff.abs() / half.clamp(min=1e-30)).max().item())
    return worst


STATE_TREES = ("momentum", "center", "center_momentum", "center_stale", "mean_theta_stale")


def phase_shard(torch, card, train):
    """The slice's main path: [train]'s configuration (qwen3-0.6b, K = 4,
    batch 4 x 64 per chain, fused EC-SGHMC in Philox mode, alpha 1, s 4,
    eps 1e-6) for 8 steps through ``ChainExecutor.run_sharded`` on a
    one-rank NCCL (chain,) mesh, raw and with the int8 exchange
    (``default_sampler``'s EC-SGHMC built with ``chain_axis``), and through
    ``run`` with the same key (``default_sampler``), under
    ``torch.use_deterministic_algorithms(True)``.  Raw sharded == run bit
    for bit; exactly 2 collectives each (2 all-reduces raw, 2 all-gathers
    int8); the int8 run's chains equal the raw run's (the exchanged mean
    reaches them only through c~ at the next sync) and its exchanged mean
    is within half a codec scale of the raw one; 13 launches a step."""
    import torch.distributed as dist

    from repro_torch import configs, core
    from repro_torch.core import rng
    from repro_torch.data import chain_batches, synthetic_token_stream
    from repro_torch.distributed import (collective_counts, int8_codec, local_chains,
                                         packed_nbytes, reset_collective_counts,
                                         sync_wire_bytes)
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import default_sampler
    from repro_torch.launch.mesh import initialize_distributed, make_chain_mesh
    from repro_torch.models import get_model, tree_leaves
    from repro_torch.run import ChainExecutor
    from repro_torch.train import make_train_step

    cfg = configs.get_config("qwen3-0.6b")
    model = get_model(cfg)
    stream = synthetic_token_stream(cfg.vocab_size, seed=0, device="cuda")
    batch_fn = lambda t: chain_batches(stream, t, SHARD_K, 4, 64)
    key = rng.key(2024)
    out, saved = {}, {}
    rdzv = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    initialize_distributed(backend="nccl", init_method=f"file://{rdzv}/rdzv", world_size=1,
                           rank=0)
    torch.use_deterministic_algorithms(True)
    try:
        mesh = make_chain_mesh(1)
        log(f"[shard] one-rank {dist.get_backend()} process group, mesh {mesh}; "
            f"deterministic algorithms on, CUBLAS_WORKSPACE_CONFIG="
            f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
        for label in ("run", "raw", "int8"):
            if label == "run":
                samp = default_sampler(cfg, "qwen3-0.6b", SHARD_K, sync_every=SHARD_SYNC,
                                       fused=True, step_size=1e-6)
            else:  # default_sampler's EC-SGHMC, its exchange over the chain axis
                samp = core.ec_sghmc(step_size=1e-6, alpha=1.0, friction=1.0,
                                     center_friction=1.0, sync_every=SHARD_SYNC, fused=True,
                                     state_dtype=cfg.param_dtype, chain_axis="chain",
                                     compression=int8_codec() if label == "int8" else None)
            params = stacked_members(torch, cfg, model, SHARD_K, "cuda", seed0=300)
            state = samp.init(params)
            ex = ChainExecutor(step_fn=make_train_step(cfg, model, samp, TRAIN_N_DATA),
                               batch_fn=batch_fn, key_mode="fold", chunk_steps=TRAIN_STEPS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            reset_collective_counts()
            # step 1, then steps 2-8 (the steady s/step, as [train]'s); the key
            # folds the absolute step, so the split run is the 8-step run
            if label != "run":
                params, state = local_chains(params, mesh, SHARD_K), local_chains(state, mesh,
                                                                                  SHARD_K)
            walls = []
            for start, n in ((0, 1), (1, TRAIN_STEPS - 1)):
                t0 = time.perf_counter()
                if label == "run":
                    res = ex.run(params, state, num_steps=n, key=key, start_step=start)
                else:
                    res = ex.run_sharded(params, state, num_steps=n, key=key, mesh=mesh,
                                         start_step=start)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                params, state = res.params, res.state
            wall, steady = sum(walls), walls[1] / (TRAIN_STEPS - 1)
            counts, kl = collective_counts(), dict(launches)
            peak = torch.cuda.max_memory_allocated()
            n_leaves = len(tree_leaves(res.params))
            n_params = sum(x[0].numel() for x in tree_leaves(res.params))
            trees = {"params": res.params, **{n: getattr(res.state, n) for n in STATE_TREES}}
            if not all(torch.isfinite(x).all().item() for t in trees.values()
                       for x in tree_leaves(t)):
                raise AssertionError(f"[shard] {label}: non-finite params or state")
            if kl["fused_ec_update"] != TRAIN_STEPS * n_leaves:
                raise AssertionError(f"[shard] {label}: fused_ec_update launched "
                                     f"{kl['fused_ec_update']} times, not {TRAIN_STEPS * n_leaves}")
            syncs = TRAIN_STEPS // SHARD_SYNC
            want = {"run": {"all_reduce": 0, "all_gather": 0},
                    "raw": {"all_reduce": syncs, "all_gather": 0},
                    "int8": {"all_reduce": 0, "all_gather": syncs}}[label]
            if {op: c["calls"] for op, c in counts.items()} != want:
                raise AssertionError(f"[shard] {label}: collectives {counts}, want {want}")
            per_sync = sum(c["bytes"] for c in counts.values()) / syncs if label != "run" else 0
            leaf_sizes = [x[0].numel() for x in tree_leaves(res.params)]
            expect = (4 * n_params if label == "raw"
                      else sum(packed_nbytes(n) for n in leaf_sizes) if label == "int8" else 0)
            if per_sync != expect:
                raise AssertionError(f"[shard] {label}: {per_sync} bytes a sync, not {expect}")
            checks = ""
            if label == "run":
                saved = {name: _host(tree_leaves, t) for name, t in trees.items()}
            elif label == "raw":
                same = {name: all(torch.equal(a, b.cuda()) for a, b in
                                  zip(tree_leaves(t), saved[name])) for name, t in trees.items()}
                checks = f"; == run bitwise: {same}"
                if not all(same.values()):
                    raise AssertionError(f"[shard] raw run_sharded differs from run: {same}")
                saved["raw_center"] = _host(tree_leaves, res.state.center)
                saved["raw_mth"] = _host(tree_leaves, res.state.mean_theta_stale)
            else:
                same_chains = all(torch.equal(a, b.cuda()) for a, b in
                                  zip(tree_leaves(res.params), saved["params"]))
                gap_mth = _scale_gap(torch, tree_leaves(res.state.mean_theta_stale),
                                     saved["raw_mth"])
                gap_c = _scale_gap(torch, tree_leaves(res.state.center), saved["raw_center"])
                c_abs = max((a - b.cuda()).abs().max().item() for a, b in
                            zip(tree_leaves(res.state.center), saved["raw_center"]))
                out["gap_mth"], out["gap_center"], out["center_abs"] = gap_mth, gap_c, c_abs
                checks = (f"; chains == raw run's bitwise: {same_chains}; exchanged mean vs raw "
                          f"{gap_mth:.6f} of scale/2, center {gap_c:.3e} of scale/2 (max abs "
                          f"{c_abs:.3e})")
                if not (same_chains and gap_mth <= 1 + SHARD_SCALE_SLACK
                        and gap_c <= 1 + SHARD_SCALE_SLACK):
                    raise AssertionError(f"[shard] the int8 run left the codec's bound{checks}")
            wire = sync_wire_bytes(n_params, compressed=label == "int8")
            nll = f"; nll {float(res.metrics['nll_per_token']):.4f}" if res.metrics else ""
            sync_ms = None
            if label != "run":  # one more exchange of the final chains, timed alone
                sync_ms = time_ms(torch, lambda: exchange(res, mesh, label == "int8"), reps=3,
                                  warmup=1)
                checks += f"; one exchange {sync_ms:.2f} ms"
            log(f"[shard] {label}: qwen3-0.6b K={SHARD_K}, s {SHARD_SYNC}, {TRAIN_STEPS} steps in "
                f"{wall:.2f} s, steady (steps 2-8) {steady:.3f} s/step ([train] {train['wall']:.2f} "
                f"s, steady {train['steady']:.3f} s/step); "
                f"peak {peak / 2**30:.2f} GiB ([train] {train['peak'] / 2**30:.2f}); "
                f"collectives {counts} ({per_sync / 1e9:.4f} GB a sync; sync_wire_bytes "
                f"{wire / 1e9:.4f} GB); fused_ec_update {kl['fused_ec_update']}{nll}{checks} "
                f"[{card}]")
            out[label] = dict(wall=wall, steady=steady, peak=peak, counts=counts, sync_ms=sync_ms,
                              launches=kl["fused_ec_update"], bytes_per_sync=per_sync, wire=wire)
            del samp, params, state, ex, res, trees
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
        saved.clear()
    return out


def exchange(res, mesh, compressed):
    """One s-periodic exchange of a sharded run's final chains into its
    ``mean_theta_stale``, as the sampler makes it: one all-reduce, or with
    ``compressed`` one packed int8 all-gather (timed by [shard])."""
    from repro_torch.core.tree_util import pmean_into
    from repro_torch.distributed import bind_axis, mesh_axis
    from repro_torch.distributed.compression import compressed_mean_into
    from repro_torch.models import tree_leaves

    leaves = tree_leaves(res.params)
    mths = tree_leaves(res.state.mean_theta_stale)
    local_mean = lambda i: leaves[i].float().mean(dim=0)
    with bind_axis("chain", mesh_axis(mesh, "chain")) as ax:
        if compressed:
            compressed_mean_into(mths, local_mean, ax)
        else:
            pmean_into(mths, local_mean, "chain")


def shard2_run(torch, alpha, compress, mesh=None):
    """[shard-2rank]'s run: SMOKE qwen3-0.6b, K = 4, fused EC-SGHMC in
    Philox mode at s 2 for 8 steps on cuda:0, through ``run_sharded`` on
    ``mesh`` (this rank's chains) or, without one, through ``run``.
    Returns the chains, the state trees, the collectives and the launches
    on the host."""
    from repro_torch import configs, core
    from repro_torch.core import rng
    from repro_torch.data import chain_batches, synthetic_token_stream
    from repro_torch.distributed import (collective_counts, int8_codec, local_chains,
                                         reset_collective_counts)
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import get_model, tree_leaves
    from repro_torch.run import ChainExecutor
    from repro_torch.train import make_train_step

    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    model = get_model(cfg)
    samp = core.ec_sghmc(step_size=SHARD2_STEP_SIZE, alpha=alpha, friction=1.0,
                         center_friction=1.0, sync_every=SHARD2_SYNC, fused=True,
                         state_dtype=cfg.param_dtype,
                         compression=int8_codec() if compress else None,
                         chain_axis=None if mesh is None else "chain")
    params = stacked_members(torch, cfg, model, SHARD_K, "cuda", seed0=400)
    state = samp.init(params)
    stream = synthetic_token_stream(cfg.vocab_size, seed=5, device="cuda")
    ex = ChainExecutor(step_fn=make_train_step(cfg, model, samp, 1000),
                       batch_fn=lambda t: chain_batches(stream, t, SHARD_K, 2, 16),
                       key_mode="fold", chunk_steps=SHARD2_STEPS)
    reset_launches()
    reset_collective_counts()
    if mesh is None:
        res = ex.run(params, state, num_steps=SHARD2_STEPS, key=rng.key(3))
    else:
        res = ex.run_sharded(local_chains(params, mesh, SHARD_K),
                             local_chains(state, mesh, SHARD_K), num_steps=SHARD2_STEPS,
                             key=rng.key(3), mesh=mesh)
    trees = {"params": res.params, **{n: getattr(res.state, n) for n in STATE_TREES}}
    return dict(trees={n: _host(tree_leaves, t) for n, t in trees.items()},
                counts=collective_counts(), launches=launches["fused_ec_update"],
                n_leaves=len(tree_leaves(res.params)))


SHARD2_CASES = ((0.0, False), (1.0, False), (1.0, True))  # (alpha, int8 exchange)


def shard2_rank(rank, world):
    """[shard-2rank]'s rank function, in a spawned process of a gloo group
    on cuda:0: every case of SHARD2_CASES."""
    import torch

    from repro_torch.launch.mesh import make_chain_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    mesh = make_chain_mesh(world)
    return {case: shard2_run(torch, *case, mesh=mesh) for case in SHARD2_CASES}


def phase_shard_2rank(torch, card):
    """Two processes on cuda:0 in one gloo group (its collectives staged
    through the host), each holding 2 of the K = 4 chains of
    ``shard2_run``: at alpha 0 each rank's chains equal the matching chains
    of the single-process ``run`` bit for bit (the kernel's chain_offset on
    the card); at alpha 1 within SHARD2_ATOL; the replicated center trees
    bit-identical on both ranks; one collective per sync, raw and int8.  A
    rank's failure fails the phase."""
    from repro_torch.launch.mesh import spawn_local

    torch.use_deterministic_algorithms(True)
    try:
        whole = {case: shard2_run(torch, *case) for case in SHARD2_CASES[:2]}
    finally:
        torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    ranks = spawn_local(shard2_rank, 2, backend="gloo", timeout_s=300)
    spawn_s = time.perf_counter() - t0
    syncs = SHARD2_STEPS // SHARD2_SYNC
    kl = SHARD_K // 2
    out = {"spawn_s": spawn_s}
    for case in SHARD2_CASES:
        alpha, comp = case
        label = f"alpha {alpha:g}{' int8' if comp else ''}"
        r0, r1 = ranks[0][case], ranks[1][case]
        center_same = all(all(torch.equal(a, b) for a, b in zip(r0["trees"][n], r1["trees"][n]))
                          for n in STATE_TREES[1:])
        op = "all_gather" if comp else "all_reduce"
        calls = [{o: c["calls"] for o, c in r["counts"].items()} for r in (r0, r1)]
        want = {"all_reduce": 0, "all_gather": 0, op: syncs}
        gap = center_gap = None  # chains, center trees against the single-process run
        if case in whole:
            gap = max((a - b[rank * kl:(rank + 1) * kl]).abs().max().item()
                      for rank, r in enumerate((r0, r1)) for n in ("params", "momentum")
                      for a, b in zip(r["trees"][n], whole[case]["trees"][n]))
            # the mean over 2 ranks of 2-chain means rounds unlike the mean of 4
            center_gap = max((a - b).abs().max().item() for n in STATE_TREES[1:]
                             for a, b in zip(r0["trees"][n], whole[case]["trees"][n]))
        fmt = lambda x: "-" if x is None else f"{x:.3e}"
        log(f"[shard-2rank] {label}: SMOKE qwen3-0.6b K={SHARD_K} over 2 gloo ranks on one card, "
            f"s {SHARD2_SYNC}, {SHARD2_STEPS} steps; vs the single-process run: chains max "
            f"|diff| {fmt(gap)}, center trees {fmt(center_gap)}; center trees bit-identical on "
            f"both ranks: {center_same}; collectives per rank {calls}; fused_ec_update "
            f"{r0['launches']} + {r1['launches']}")
        if not center_same or any(c != want for c in calls):
            raise AssertionError(f"[shard-2rank] {label}: replicated center or collectives wrong")
        if any(r["launches"] != SHARD2_STEPS * r["n_leaves"] for r in (r0, r1)):
            raise AssertionError(f"[shard-2rank] {label}: fused_ec_update launched "
                                 f"{r0['launches']} + {r1['launches']} times, not "
                                 f"{SHARD2_STEPS * r0['n_leaves']} on each rank")
        if (alpha == 0.0 and gap != 0.0) or (gap is not None
                                             and max(gap, center_gap) > SHARD2_ATOL):
            raise AssertionError(f"[shard-2rank] {label}: chains {gap}, center {center_gap} "
                                 "from the single-process run")
        out[label] = dict(gap=gap, center_gap=center_gap, calls=calls,
                          launches=r0["launches"] + r1["launches"])
    log(f"[shard-2rank] the two ranks took {spawn_s:.1f} s, spawn and imports included")
    return out


def phase_park(torch, card):
    """[slice]'s paged qwen3-0.6b engine at full width (K = 4) with
    ``compress_parked=True``: admit a 128-token prompt, park its slot and
    restore it.  The restored KV is within the codec's bound of the
    original (half a block scale, plus one bf16 rounding); a second park
    and restore is bit-exact; parked bytes against raw bytes, park and
    restore ms (host clock around a synchronised call)."""
    from repro_torch import configs
    from repro_torch.distributed import int8_codec
    from repro_torch.models import get_model, tree_leaves
    from repro_torch.serve.engine import ServeEngine, synthetic_trace

    cfg = configs.get_config("qwen3-0.6b").replace(use_flash_kernel=True)
    model = get_model(cfg)
    members = stacked_members(torch, cfg, model, SHARD_K, "cuda", seed0=0)
    eng = ServeEngine(cfg, model, members, paged=True, num_slots=8, max_seq=128 + 32,
                      compress_parked=True, device="cuda")
    pool = eng.pool
    req = next(r for r in synthetic_trace(16, vocab_size=cfg.vocab_size, prompt_lens=(64, 128),
                                          max_new=32, seed=0) if r.prompt.size == 128)
    slot = pool.acquire()
    eng._admit(req, slot, pool.admit_blocks(slot, req.prompt, req.max_new))

    def pages(s):
        row = pool.alloc.tables[s]
        idx = torch.tensor(row[row != 0], dtype=torch.long, device="cuda")
        return [leaf.index_select(leaf.ndim - 4, idx).clone() for leaf in tree_leaves(pool.caches)]

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t)

    orig = pages(slot)
    parked, park_ms = timed(pool.park, slot)
    slot, restore_ms = timed(pool.restore, parked, max_new=req.max_new)
    once = pages(slot)
    raw_bytes = sum(x.numel() * x.element_size() for x in orig)
    parked_bytes = sum(x["q"].numel() + 4 * x["scale"].numel() if isinstance(x, dict)
                       else x.numel() * x.element_size() for x in parked.leaves)
    codec, worst = int8_codec(), 0.0
    for o, r in zip(orig, once):
        enc = codec.encode(o)
        diff = torch.nn.functional.pad((r.float() - o.float()).reshape(-1),
                                       (0, enc["q"].numel() - o.numel()))
        half = 0.5 * enc["scale"].expand(-1, enc["q"].shape[1]).reshape(-1)
        mag = torch.nn.functional.pad(r.float().abs().reshape(-1), (0, diff.numel() - o.numel()))
        worst = max(worst, (diff.abs() / (half + PARK_SLACK * mag).clamp(min=1e-30)).max().item())
    parked2, park2_ms = timed(pool.park, slot)
    slot, restore2_ms = timed(pool.restore, parked2, max_new=req.max_new)
    twice = pages(slot)
    exact = all(torch.equal(a, b) for a, b in zip(once, twice))
    log(f"[park] paged qwen3-0.6b K={SHARD_K}, a {req.prompt.size}-token slot "
        f"({parked.num_pages} pages, {once[0].dtype}): parked {parked_bytes} bytes of "
        f"{raw_bytes} ({parked_bytes / raw_bytes:.4f}); park {park_ms:.3f} ms, restore "
        f"{restore_ms:.3f} ms (again: {park2_ms:.3f} / {restore2_ms:.3f} ms); restored vs "
        f"original {worst:.4f} of the bound (scale/2 + 2^-8 |x|); second pass bit-exact "
        f"{exact} [{card}]")
    if worst > 1 + SHARD_SCALE_SLACK or not exact:
        raise AssertionError("[park] compressed parking left the codec's bound or moved again")
    del eng, members, pool, orig, once, twice, parked, parked2
    gc.collect()
    torch.cuda.empty_cache()
    return dict(raw_bytes=raw_bytes, parked_bytes=parked_bytes, park_ms=park_ms,
                restore_ms=restore_ms, park2_ms=park2_ms, restore2_ms=restore2_ms, worst=worst)


# ---------------------------------------------------------------------------
# serving across ranks
# ---------------------------------------------------------------------------

MESH_REQUESTS = 8  # [slice]'s prompt lengths (64, 128), the 8 arriving together
MESH_NEW = 8
# (c) cuts qwen3-0.6b's depth to 4 of 28 layers: each rank holds the whole
# K=4 EC-SGHMC carry (~29 GB at full depth, plus staged candidates), and two
# such ranks do not fit one 80 GB card beside their engines
MESH_REFRESH_LAYERS = 4
MESH_REFRESH_NEW = 16  # ~16 ticks: 32 sampler steps, 2 proposals at chunk 16


def mesh_trace(vocab, max_new=MESH_NEW):
    from repro_torch.serve.engine import synthetic_trace

    return synthetic_trace(MESH_REQUESTS, vocab_size=vocab, prompt_lens=(64, 128),
                           max_new=max_new, mean_interarrival=1e-3, seed=0)


def _count_delta(a, b):
    return {op: {k: b[op][k] - a[op][k] for k in ("calls", "bytes")} for op in a}


def mesh_serve(torch, cfg, model, members, trace, mesh=None, paged=False, record=True,
               refresher=None, refresh_every=0):
    """One ``ServeEngine.run`` over ``trace`` (8 slots, on ``mesh`` where
    given) with every launch count and the collective counter set to 0 just
    before it.  Returns the report, the launches, per admit and tick (and
    between them) the collectives, the registry version at each tick, and
    the host seconds of the tick's gathers (between synchronizes: the tick
    waits for its emissions on the host anyway)."""
    from repro_torch.distributed import collective_counts, reset_collective_counts
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serve.engine import ServeEngine

    max_new = max(r.max_new for r in trace)
    eng = ServeEngine(cfg, model, members, num_slots=8, max_seq=128 + max_new,
                      record_logprobs=record, paged=paged, mesh=mesh, refresher=refresher,
                      refresh_every=refresh_every, device="cuda")
    log, versions, gather_s, last = [], [], [0.0], [None]

    def wrap(kind, fn):
        def call(*args, **kw):
            before = collective_counts()
            log.append(("between", _count_delta(last[0], before)))
            if kind == "tick":
                versions.append(eng.registry.version)
            out = fn(*args, **kw)
            last[0] = collective_counts()
            log.append((kind, _count_delta(before, last[0])))
            return out
        return call

    def timed_gather(fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            gather_s[0] += time.perf_counter() - t0
            return out
        return call

    if mesh is not None:
        eng._gather_members = timed_gather(eng._gather_members)
        eng._gather_slots = timed_gather(eng._gather_slots)
    eng._decode = wrap("tick", eng._decode)
    eng._admit = wrap("admit", eng._admit)
    torch.cuda.synchronize()
    reset_launches()
    reset_collective_counts()
    last[0] = collective_counts()
    rep = eng.run(trace)
    torch.cuda.synchronize()
    log.append(("between", _count_delta(last[0], collective_counts())))
    counts = dict(launches)
    check_report(rep, trace, cfg.vocab_size, "serve-mesh")
    return dict(rep=rep, launches=counts, log=log, versions=versions, gather_s=gather_s[0],
                k_local=eng._k_local)


def check_collectives(run, admit, tick, between, label):
    """Every admit, tick and the host work between them issued exactly the
    collectives given (``between`` None: not checked)."""
    want = {"admit": admit, "tick": tick, "between": between}
    none = {"calls": 0, "bytes": 0}
    for kind, delta in run["log"]:
        if want[kind] is None:
            continue
        exp = {"all_reduce": none, "all_gather": none, **want[kind]}
        if delta != exp:
            raise AssertionError(f"[serve-mesh] {label}: a {kind} issued {delta}, expected {exp}")


def gathers(k, s, V, slot_cols=None):
    """The all-gathers of an admit and a tick: the member gather of the f32
    (K_local, V) / (K_local, S_local, V) logits, and (``slot_cols``) the
    slot gather of S_local rows of that many int32 columns."""
    admit = {"all_gather": {"calls": 1, "bytes": 4 * k * V}}
    calls, nbytes = 1, 4 * k * s * V
    if slot_cols is not None:
        calls, nbytes = 2, nbytes + 4 * s * slot_cols
    return admit, {"all_gather": {"calls": calls, "bytes": nbytes}}


def mesh_row(run, label, card):
    rep = run["rep"]
    ticks = max(rep.decode_steps, 1)
    pct = rep.latency_percentiles()
    log(f"[serve-mesh] {label}: {rep.total_tokens} tokens, {rep.decode_steps} ticks, "
        f"{rep.tokens_per_s:.2f} tok/s, latency p50 {pct['latency_p50_s']:.3f} s p99 "
        f"{pct['latency_p99_s']:.3f} s, wall {rep.wall_s:.2f} s; gathers "
        f"{1e3 * run['gather_s'] / ticks:.2f} ms per tick (host, synchronized); launches "
        f"{run['launches']} [{card}]")
    return dict(tokens_per_s=rep.tokens_per_s, ticks=rep.decode_steps, wall_s=rep.wall_s,
                gather_ms_per_tick=1e3 * run["gather_s"] / ticks, launches=run["launches"],
                **pct)


def serve_mesh_rank(rank, world):
    """[serve-mesh]'s two gloo ranks on cuda:0, mesh (2, 1): (b) full-width
    qwen3-0.6b K = 4, greedy, each rank serving its two members; (c) the
    same at ``MESH_REFRESH_LAYERS`` layers under overlapped refresh by
    fused EC-SGHMC chains (each rank's scheduler over the whole K = 4
    carry).  Returns tokens, launches, collectives and versions."""
    import torch

    from repro_torch import configs, core
    from repro_torch.core import rng as rnglib
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models import get_model, tree_leaves, tree_map
    from repro_torch.serve.engine import RefreshScheduler, ServeEngine, SnapshotRegistry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_engine_mesh(2, 1)
    out = {}
    cfg = configs.get_config("qwen3-0.6b").replace(use_flash_kernel=True)
    model = get_model(cfg)
    members = stacked_members(torch, cfg, model, 4, "cuda")
    ServeEngine(cfg, model, members, num_slots=8, max_seq=130, mesh=mesh,
                device="cuda").run(warmup_trace(cfg.vocab_size))
    torch.cuda.reset_peak_memory_stats()
    run = mesh_serve(torch, cfg, model, members, mesh_trace(cfg.vocab_size), mesh=mesh,
                     record=False)
    del members
    gc.collect()
    torch.cuda.empty_cache()
    rep = run.pop("rep")
    out["b"] = dict(run, tokens={r.rid: r.tokens.tolist() for r in rep.results},
                    decode_steps=rep.decode_steps, tokens_per_s=rep.tokens_per_s,
                    wall_s=rep.wall_s, pct=rep.latency_percentiles(),
                    peak=torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg.replace(num_layers=MESH_REFRESH_LAYERS)
    model = get_model(cfg)
    specs = model.param_specs(cfg)
    key = rnglib.key(0)
    reg = SnapshotRegistry(stacked_members(torch, cfg, model, 4, "cuda"))
    center = serve_launch._init(specs, key, "cuda")
    start = tree_map(lambda x: x[None].expand((4,) + tuple(x.shape)).contiguous(), center)
    samp = core.ec_sghmc(step_size=EC_REFRESH_STEP, alpha=1.0, friction=1.0,
                         center_friction=1.0, sync_every=4, fused=True,
                         state_dtype=cfg.param_dtype)
    ref = RefreshScheduler(reg, samp, serve_launch._prior_grad(center), start,
                           key=rnglib.fold_in(key, 2), chunk_steps=16, total_steps=64,
                           sync_every=4)
    del center, start
    run = mesh_serve(torch, cfg, model, reg, mesh_trace(cfg.vocab_size, MESH_REFRESH_NEW),
                     mesh=mesh, record=False, refresher=ref, refresh_every=REFRESH_EVERY)
    rep = run.pop("rep")
    out["c"] = dict(run, tokens={r.rid: r.tokens.tolist() for r in rep.results},
                    decode_steps=rep.decode_steps, refresher=rep.refresher,
                    version=reg.version, n_leaves=len(tree_leaves(reg.members)),
                    spare=ref.device, peak=torch.cuda.max_memory_allocated())
    return out


def phase_serve_mesh(torch, card):
    """The sharded engine: (a) full-width qwen3-0.6b K = 4 through
    ``ServeEngine(mesh=make_engine_mesh(1, 1))`` on a one-rank NCCL group,
    dense and paged, against the unsharded engine in this call: tokens and
    logp bit for bit, the same launches, exact collectives per admit and
    tick and none between; (b) and (c) on two gloo ranks spawned on cuda:0
    (``serve_mesh_rank``): the unsharded tokens, flash 28 times per local
    member per admit and bma_select once per tick on each rank; under
    overlapped refresh, one registry version on both ranks at every tick
    and at least one promotion."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import initialize_distributed, make_engine_mesh, spawn_local
    from repro_torch.models import get_model
    from repro_torch.serve.engine import ServeEngine

    cfg = configs.get_config("qwen3-0.6b").replace(use_flash_kernel=True)
    model = get_model(cfg)
    V, L = cfg.vocab_size, cfg.num_layers
    members = stacked_members(torch, cfg, model, 4, "cuda")
    trace = mesh_trace(V)
    ServeEngine(cfg, model, members, num_slots=8, max_seq=130,
                device="cuda").run(warmup_trace(V))
    runs, rows, out = {}, {}, {}
    rdzv = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    initialize_distributed(backend="nccl", init_method=f"file://{rdzv}/rdzv", world_size=1,
                           rank=0)
    try:
        mesh = make_engine_mesh(1, 1)
        log(f"[serve-mesh] one-rank {dist.get_backend()} process group, mesh {mesh}")
        # NCCL makes each group's communicator at its first collective (~0.5 s)
        ServeEngine(cfg, model, members, num_slots=8, max_seq=130, mesh=mesh,
                    device="cuda").run(warmup_trace(V))
        # whole, mesh, mesh, whole: the order of a two-version comparison
        for label, m, paged in (("unsharded dense", None, False),
                                ("nccl (1, 1) dense", mesh, False),
                                ("nccl (1, 1) paged", mesh, True),
                                ("unsharded paged", None, True)):
            runs[label] = mesh_serve(torch, cfg, model, members, trace, mesh=m, paged=paged)
            rows[label] = mesh_row(runs[label], label, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    for mode in ("dense", "paged"):
        whole, sharded = runs[f"unsharded {mode}"], runs[f"nccl (1, 1) {mode}"]
        same = all(np.array_equal(a.tokens, b.tokens) and np.array_equal(a.logprobs, b.logprobs)
                   for a, b in zip(whole["rep"].results, sharded["rep"].results))
        admit, tick = gathers(4, 8, V, None if mode == "paged" else 4 + V)
        check_collectives(sharded, admit, tick, {}, f"nccl {mode}")
        log(f"[serve-mesh] nccl (1, 1) {mode} vs unsharded: tokens and logp bitwise equal "
            f"{same}; launches {sharded['launches']} vs {whole['launches']}; per admit "
            f"{admit}, per tick {tick}, none between: exact")
        if not same or sharded["launches"] != whole["launches"]:
            raise AssertionError(f"[serve-mesh] nccl {mode}: the mesh engine differs from the "
                                 "unsharded one")
    want_tokens = {r.rid: r.tokens.tolist() for r in runs["unsharded dense"]["rep"].results}
    out.update(rows=rows, launches={k: v["launches"] for k, v in runs.items()})
    del members, runs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_local(serve_mesh_rank, 2, backend="gloo", timeout_s=420)
    spawn_s = time.perf_counter() - t0
    admit, tick = gathers(2, 8, V, 4)
    for r, rk in enumerate(ranks):
        b = rk["b"]
        check_collectives(b, admit, tick, {}, f"gloo rank {r}")
        admits = sum(1 for kind, _ in b["log"] if kind == "admit")
        want = {"flash_attention": L * 2 * admits, "paged_attention": 0,
                "bma_select": b["decode_steps"]}
        got = {n: b["launches"][n] for n in SERVING_KERNELS}
        log(f"[serve-mesh] gloo rank {r} of (2, 1), members {2 * r}-{2 * r + 1}: "
            f"{b['decode_steps']} ticks, {b['tokens_per_s']:.2f} tok/s, wall {b['wall_s']:.2f} s, "
            f"gathers {1e3 * b['gather_s'] / max(b['decode_steps'], 1):.2f} ms per tick (host, "
            f"staged through the host); tokens equal to the unsharded run "
            f"{b['tokens'] == want_tokens}; launches {got}, expected {want}; peak "
            f"{gib(b['peak'])} (the whole K=4 stack drawn, two members kept) [{card}]")
        if b["tokens"] != want_tokens or got != want:
            raise AssertionError(f"[serve-mesh] gloo rank {r}: tokens or launches differ")
    c0, c1 = ranks[0]["c"], ranks[1]["c"]
    for r, c in enumerate((c0, c1)):
        rf = c["refresher"]
        want_ec = c["n_leaves"] * rf["steps_done"]
        log(f"[serve-mesh] refresh, gloo rank {r}: qwen3-0.6b widths at {MESH_REFRESH_LAYERS} "
            f"layers, {c['decode_steps']} ticks, versions by tick {c['versions']}, final "
            f"{c['version']}; promotions {rf['promotions']}, {rf['steps_done']} sampler steps in "
            f"{rf['micro_chunks']} micro-chunks, deferred flips {rf['flips_deferred']}, stalled "
            f"{rf['decode_steps_stalled']}; fused_ec_update {c['launches']['fused_ec_update']} "
            f"(expected {want_ec}); spare device {c['spare']}; peak {gib(c['peak'])} [{card}]")
        if c["launches"]["fused_ec_update"] != want_ec or want_ec <= 0:
            raise AssertionError(f"[serve-mesh] refresh rank {r}: fused launches")
    if c0["versions"] != c1["versions"] or c0["version"] != c1["version"] or c0["version"] < 1 \
            or c0["tokens"] != c1["tokens"]:
        raise AssertionError("[serve-mesh] the ranks' registries or tokens disagree under refresh")
    log(f"[serve-mesh] two gloo ranks on one card took {spawn_s:.1f} s, spawn, imports and "
        "drawing included; their times say nothing of NVLink")
    out.update(spawn_s=spawn_s, gloo={r: {k: v for k, v in rk["b"].items() if k != "log"}
                                      for r, rk in enumerate(ranks)},
               refresh={r: {k: v for k, v in rk["c"].items() if k != "log"}
                        for r, rk in enumerate(ranks)})
    return out


# [dryrun]: (a) full-width cells on the 256-rank fake world; (b) cells one
# card holds, predicted on a one-rank fake world and then run for real on a
# one-rank NCCL mesh: (arch, shape, (seq, global batch) that replace the
# shape's, chains, config overrides).  The fake processes, each job's cells:
DRYRUN_FULL = (("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "decode_32k"),
               ("recurrentgemma-2b", "train_4k"), ("recurrentgemma-2b", "decode_32k"))
DRYRUN_JOBS = {"full-qwen3-train": DRYRUN_FULL[:1], "full-hybrid-train": DRYRUN_FULL[2:3],
               "full-decode": DRYRUN_FULL[1::2], "predict-train": (0, 2),
               "predict-decode": (1, 3)}
DRYRUN_CARD = (
    ("qwen3-0.6b", "train_4k", (64, 8), 2, {}),
    ("qwen3-0.6b", "decode_32k", (8192, 16), None, {}),
    ("recurrentgemma-2b", "train_4k", (64, 8), 2, {"num_layers": 3}),  # [train-hybrid]'s cut
    ("recurrentgemma-2b", "decode_32k", (4096, 32), None, {}),
)
DRYRUN_RTOL = 0.10  # predicted peak vs measured max_memory_allocated


def _dryrun_card_cell(spec):
    """Build one (b) cell: the shape narrowed, the mesh of one rank."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.specs import build_cell

    arch, shape, (seq, batch), k, overrides = spec
    kind = configs.SHAPES[shape].kind
    configs.SHAPES[shape] = configs.ShapeCell(shape, kind, seq, batch)
    mesh = (mesh_lib.make_train_mesh(1, size=1) if kind == "train"
            else mesh_lib.make_production_mesh(size=1))
    return build_cell(arch, shape, mesh, num_chains=k, overrides=overrides)


def dryrun_child(job: str, out_path: str) -> None:
    """A [dryrun] process with a fake world, running DRYRUN_JOBS[job]: the
    full-width cells on 256 ranks (records written under
    build/chip_smoke/dryrun/), or the DRYRUN_CARD cells (by index) on one.
    Writes its records, and its seconds from start, to ``out_path``."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    import torch  # noqa: F401

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    out = {"_s": {"import": time.perf_counter() - t0}}
    if job.startswith("predict"):
        dryrun.start_fake_world(1)
        for i in DRYRUN_JOBS[job]:
            spec = DRYRUN_CARD[i]
            out[f"{spec[0]}/{spec[1]}"] = dryrun.trace_cell(_dryrun_card_cell(spec))
    else:
        dryrun.start_fake_world(256)
        for arch, shape in DRYRUN_JOBS[job]:
            out[f"{arch}/{shape}"] = dryrun.run_cell(arch, shape, False, OUT / "dryrun")
    out["_s"]["total"] = time.perf_counter() - t0
    out["_launches"] = dict(ops.launches)
    pathlib.Path(out_path).write_text(json.dumps(out, default=str))


def dryrun_measure_rank(rank, world):
    """The DRYRUN_CARD cells for real on a one-rank NCCL mesh (spawned, so
    the process holds no fake group): zero-filled arguments in the cells'
    layouts, then ``Cell.fn`` once, with ``max_memory_allocated`` read
    around it."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops

    out = {}
    for spec in DRYRUN_CARD:
        cell = _dryrun_card_cell(spec)
        args = shd.empty_tree(cell.args, cell.in_shardings, cell.mesh, "cuda", zeros=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launches()
        t0 = time.perf_counter()
        with implicit_replication():
            res = cell.fn(*args)
        torch.cuda.synchronize()
        out[f"{spec[0]}/{spec[1]}"] = {
            "measured_peak": torch.cuda.max_memory_allocated(), "args_allocated": base,
            "run_s": time.perf_counter() - t0, "launches": dict(ops.launches),
            "finite": bool(all(torch.isfinite(t.full_tensor() if shd.is_dtensor(t) else t).all()
                               for t in _leaves(res) if t.is_floating_point()))}
        del args, res, cell
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    from repro_torch.models.common import map_tensors

    out = []
    map_tensors(lambda t: out.append(t), tree)
    return out


def phase_dryrun_ops(torch, ops, ref):
    """(c) Each kernel's torch.library form on the card: called directly on
    card tensors against its plain version (the wrappers call these forms
    on the card), and under FakeTensorMode with card-device fake tensors,
    where it gives the real call's output shapes and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator(device="cuda").manual_seed(31)
    dev = "cuda"
    rn = lambda *s, dt=torch.float32: torch.randn(*s, generator=g, device=dev).to(dt)  # noqa: E731
    a = torch.rand(2, 96, 256, generator=g, device=dev)
    x = rn(2, 96, 256)
    h = ref.rglru_scan(a, x, None)
    dh = rn(2, 96, 256)
    q, k, v = rn(1, 4, 128, 64), rn(1, 2, 128, 64), rn(1, 2, 128, 64)
    kp, vp = rn(9, 16, 2, 64), rn(9, 16, 2, 64)
    qd = rn(3, 2, 2, 64)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [1, 3, 5, 7]], dtype=torch.int32,
                          device=dev)
    ctx = torch.tensor([40, 63, 17], dtype=torch.int32, device=dev)
    logits = rn(3, 4, 5000)
    th, p, gr = rn(2, 3000), rn(2, 3000), rn(2, 3000)
    ct, minv = rn(3000), torch.rand(2, 3000, generator=g, device=dev) + 0.5
    b1, b2 = (torch.randint(-2**31, 2**31 - 1, (6000,), generator=g, device=dev,
                            dtype=torch.int32) for _ in range(2))
    sc = [float(v_) for v_ in ref.ec_scalars(1e-3, 1.0, 1.0, 1.0, 0.05)]
    psc = [float(v_) for v_ in ref.precond_scalars(1e-3, 1.0, 1.0, 0.05)]
    T = torch.ops.repro_torch
    calls = {
        "rglru_scan": (lambda: T.rglru_scan(a, x, None), lambda: ref.rglru_scan(a, x, None)),
        "rglru_scan_bwd": (lambda: T.rglru_scan_bwd(a, h, dh, None)[:2],
                           lambda: ref.rglru_scan_bwd(a, h, dh, None)[:2]),
        "flash_attention": (lambda: T.flash_attention(q, k, v, True, None, None, 0.125),
                            lambda: ref.attention(q, k, v, causal=True, window=None,
                                                  softcap=None, scale=0.125)),
        "paged_attention": (lambda: T.paged_attention(qd, kp, vp, tables, ctx, 0.125, None, None),
                            lambda: ref.paged_attention(qd, kp, vp, tables, ctx, scale=0.125,
                                                        window=None, softcap=None)),
        "bma_select": (lambda: T.bma_select(logits, None, "probs", 0.0, 0),
                       lambda: ref.bma_select(logits, None, mode="probs", temperature=0.0,
                                              top_k=0)),
        "fused_ec_update": (
            lambda: (T.fused_ec_update(th, p, gr, ct, b1, b2, p_ec := p.clone(), 2, 3000, 0, 0,
                                       0, 0, sc, True, 0), p_ec),
            lambda: ref.fused_ec_update(th, p, gr, ct, b1.view(2, 3000), b2.view(2, 3000),
                                        scalars=tuple(sc), stochastic_round=True)),
        "fused_precond_ec_update": (
            lambda: (T.fused_precond_ec_update(th, p, gr, ct, minv, b1, b2, p_pc := p.clone(), 2,
                                               3000, 0, 0, 0, 0, psc, True), p_pc),
            lambda: ref.fused_precond_ec_update(th, p, gr, ct, minv, b1.view(2, 3000),
                                                b2.view(2, 3000), scalars=tuple(psc),
                                                stochastic_round=True)),
    }
    if set(calls) != set(ops.OPS):
        raise AssertionError(f"[dryrun] the forms checked {sorted(calls)} are not {ops.OPS}")
    rows = {}
    for name, (op, plain) in calls.items():
        got, want = op(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((gg.float() - ww.float()).abs().max()) for gg, ww in zip(got, want)
                  if ww.is_floating_point())
        tol = FLASH_ATOL if "attention" in name else BMA_LOGP_ATOL if name == "bma_select" else 0.0
        if not err <= tol or (name == "bma_select" and not torch.equal(got[0], want[0])):
            raise AssertionError(f"[dryrun] {name}'s torch.library form: max|op - plain| = "
                                 f"{err} > {tol}")
        before = dict(ops.launches)
        with FakeTensorMode(allow_non_fake_inputs=True) as fm:
            fake = op()
        fake = fake if isinstance(fake, tuple) else (fake,)
        if ops.launches != before or [tuple(t.shape) for t in fake] != [
                tuple(t.shape) for t in got] or [t.dtype for t in fake] != [t.dtype for t in got]:
            raise AssertionError(f"[dryrun] {name}'s fake form: shapes {[t.shape for t in fake]}"
                                 f" vs {[t.shape for t in got]}, launches {ops.launches} vs {before}")
        del fm
        rows[name] = err
        log(f"[dryrun] {name}: torch.library form vs plain max_abs_err={err:.3e} (atol {tol}); "
            f"under FakeTensorMode the output shapes, no launch")
    return rows


def phase_dryrun(torch, card):
    """[dryrun]: (a) qwen3-0.6b and recurrentgemma-2b at full width on
    train_4k and decode_32k, traced on the 256-rank fake world by
    ``launch.dryrun.run_cell``; (b) the DRYRUN_CARD cells predicted on a
    one-rank fake world and run for real on a one-rank NCCL mesh (a
    spawned rank), all at once (DRYRUN_JOBS' processes beside the rank),
    each predicted peak held within DRYRUN_RTOL of the measured
    ``max_memory_allocated``; (c) each kernel's torch.library form on the
    card (``phase_dryrun_ops``).  The fake group is process-global, hence
    the processes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import spawn_local

    t0 = time.perf_counter()
    ops_rows = phase_dryrun_ops(torch, ops, ref)
    ops_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    (OUT / "dryrun").mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jobs = list(DRYRUN_JOBS)
    procs = {job: subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dryrun_child({job!r}, "
         f"{str(OUT / 'dryrun' / (job + '.json'))!r})"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for job in jobs}
    try:
        t1 = time.perf_counter()
        measured = spawn_local(dryrun_measure_rank, 1, backend="nccl", timeout_s=400)[0]
        measure_s = time.perf_counter() - t1
        for job, p in procs.items():
            text, _ = p.communicate(timeout=400)
            (OUT / "dryrun" / f"{job}.log").write_text(text)
            if p.returncode != 0:
                raise AssertionError(f"[dryrun] {job} failed:\n{text[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {job: json.loads((OUT / "dryrun" / f"{job}.json").read_text()) for job in jobs}
    log(f"[dryrun] seconds: (c) {ops_s:.1f}, the real runs' rank {measure_s:.1f}, the fake "
        f"processes " + ", ".join(f"{j} {r['_s']['total']:.1f} (import {r['_s']['import']:.1f})"
                                   for j, r in res.items()))
    if any(any(r["_launches"].values()) for r in res.values()):
        raise AssertionError(f"[dryrun] a kernel launched under the dry run: {res}")
    full = {}
    predicted = {}
    for job, r in res.items():
        cells = {k: v for k, v in r.items() if not k.startswith("_")}
        if job.startswith("predict"):
            predicted.update(cells)
            continue
        for key, rec in cells.items():
            ma = rec["memory_analysis"]
            log(f"[dryrun] (a) {key} on {rec['devices']} ranks {rec['mesh']}: per device "
                f"arguments {ma['argument_size_in_bytes'] / 1e9:.3f} GB, peak "
                f"{rec['peak_bytes'] / 1e9:.3f} GB (fits 80 GB: {rec['fits']}), collectives "
                f"{rec['collective_bytes_per_device'] / 1e9:.3f} GB {rec['collectives']}, "
                f"flops {rec['cost_analysis']['flops']:.4e}; traced in {rec['compile_s']} s "
                f"(built and placed in {rec['lower_s']} s) (a prediction for {card})")
            full[key] = rec
    pairs = {}
    for key, pred in predicted.items():
        m = measured[key]
        gap = (pred["peak_bytes"] - m["measured_peak"]) / m["measured_peak"]
        pairs[key] = {"predicted_peak": pred["peak_bytes"], **m, "gap": gap,
                      "predicted_args": pred["memory_analysis"]["argument_size_in_bytes"],
                      "trace_s": pred["compile_s"]}
        log(f"[dryrun] (b) {key}: predicted peak {pred['peak_bytes'] / 2**30:.3f} GiB "
            f"(arguments {pred['memory_analysis']['argument_size_in_bytes'] / 2**30:.3f}), "
            f"measured max_memory_allocated {m['measured_peak'] / 2**30:.3f} GiB (arguments "
            f"{m['args_allocated'] / 2**30:.3f}), gap {gap * 100:+.2f}% (limit "
            f"{DRYRUN_RTOL * 100:.0f}%); run {m['run_s']:.2f} s, launches "
            f"{ {k: v for k, v in m['launches'].items() if v} }")
        if not (pred["peak_bytes"] >= 10e9 and abs(gap) <= DRYRUN_RTOL and m["finite"]):
            raise AssertionError(f"[dryrun] {key}: predicted {pred['peak_bytes']} vs measured "
                                 f"{m['measured_peak']} (gap {gap:+.3f}), finite {m['finite']}")
    if len(full) != len(DRYRUN_FULL) or len(pairs) != len(DRYRUN_CARD):
        raise AssertionError(f"[dryrun] records of {sorted(full)} and {sorted(pairs)}")
    return {"full": full, "card": pairs, "ops": ops_rows,
            "seconds": {"ops": ops_s, "measure": measure_s,
                        **{j: r["_s"] for j, r in res.items()}}}


def main() -> int:
    # set before the first CUDA allocation: [refresh-ec] holds ~68 GiB of
    # live stacks on an 80 GB card, and without expandable segments the
    # splits of 1-2.5 GB blocks strand enough reserved memory to fail it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # set before the first CUDA call: cuBLAS's deterministic workspace, which
    # torch.use_deterministic_algorithms(True) needs ([smoke-train], [shard],
    # [shard-2rank], whose spawned ranks inherit it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    logs = {n: _build.nvcc_log(n) for n in _build.SOURCES
            if _build.library_path(n).with_suffix(".log").exists()}
    summary, ptxas = build_report(logs, {n: _build.library_path(n) for n in _build.SOURCES})
    (OUT / "build_log.txt").write_text(summary + "\n\n" + "\n".join(
        f"=== {n} ===\n{t}" for n, t in logs.items()))
    log(f"[build] {len(_build.SOURCES)} kernels built in {secs:.2f} s into {_build.BUILD_DIR}")
    log(summary)
    for lib in ("flash_attention", "paged_attention"):
        if lib not in ptxas:
            raise AssertionError(f"[build] no nvcc log beside {lib}'s library")
        spills = [f["fn"] for f in ptxas[lib]["functions"] if f["spill"]]
        if spills:
            raise AssertionError(f"[build] ptxas reports spills in {lib}: {spills}")
    if not ptxas["flash_attention"]["hmma"]:
        raise AssertionError("[build] no HMMA instruction in flash_attention's SASS")

    from repro_torch import configs

    phase_s = {"build": secs}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name}: {phase_s[name]:.1f} s")
        return out

    qwen = configs.get_config("qwen3-0.6b")
    flash = timed("flash", phase_flash, torch, ops, ref, F)
    flash256 = timed("flash256", phase_flash, torch, ops, ref, F, Hq=10, Hkv=1, d=256,
                     cases=FLASH256_CASES, label="flash256", seed=17)
    paged = timed("paged", phase_paged, torch, ops, ref)
    bma = timed("bma", phase_bma, torch, ops, ref)
    bma256k = timed("bma256k", phase_bma, torch, ops, ref, V=256000, label="bma256k", seed=18)
    flash_family = timed("flash-family", lambda: [
        r for i, (B, Hq, Hkv, d, cases) in enumerate(FLASH_FAMILY_CASES)
        for r in phase_flash(torch, ops, ref, F, B=B, Hq=Hq, Hkv=Hkv, d=d, cases=cases,
                             seed=19 + i)])
    paged_moe = timed("paged-moe", lambda: [
        r for i, (Hkv, G, softcap, cases) in enumerate(PAGED_MOE_CASES)
        for r in phase_paged(torch, ops, ref, Hkv=Hkv, G=G, softcap=softcap, cases=cases,
                             seed=22 + i)])
    bma_family = timed("bma-family", lambda: [
        r for i, V in enumerate(BMA_FAMILY_VOCABS)
        for r in phase_bma(torch, ops, ref, V=V, K=BMA_FAMILY_K.get(V, 4), seed=24 + i,
                           cases=BMA_ROWS[:1])])
    rglru = timed("rglru", phase_rglru, torch, ops, ref)
    fused = timed("fused_ec", phase_fused_ec, torch, ops, ref, qwen)
    fused["paper"] = timed("fused_ec-paper", phase_fused_ec_small, torch, ops, ref)
    precond = timed("fused_precond", phase_fused_precond, torch, ops, ref, qwen)
    timed("philox", phase_philox, torch, ops, ref, qwen)
    codec = timed("codec", phase_codec, torch, qwen)
    timed("stationary", phase_stationary, torch)
    stationary_async = timed("stationary-async", phase_stationary_async, torch)
    timed("stationary-precond", phase_stationary_precond, torch)
    timed("smoke-engine", phase_smoke_engine, torch)
    timed("smoke-train", phase_smoke_train, torch)
    counts, per_tick = timed("slice", phase_slice, torch, card)
    log(f"[slice] launches per decode tick: {per_tick} (flash: once per layer per member per admit)")
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train = timed("train", phase_train, torch, card)
    counts["fused_ec_update"] = train_counts["fused_ec_update"]
    adaptive_counts, train_adaptive = timed("train-adaptive", phase_train, torch, card,
                                            adaptive=True)
    counts["fused_precond_ec_update"] = adaptive_counts["fused_precond_ec_update"]
    hybrid_train_counts, train_hybrid = timed("train-hybrid", phase_train_hybrid, torch, card)
    counts["rglru_scan_bwd"] = hybrid_train_counts["rglru_scan_bwd"]
    hybrid_counts, hybrid = timed("slice-hybrid", phase_slice_hybrid, torch, card)
    counts["rglru_scan"] = hybrid_counts["rglru_scan"]
    dense_counts, slice_dense = timed("slice-dense", phase_slice_dense, torch, card)
    moe_counts, slice_moe = timed("slice-moe", phase_slice_moe, torch, card)
    xlstm_counts, slice_xlstm = timed("slice-xlstm", phase_slice_xlstm, torch, card)
    vlm_counts, slice_vlm = timed("slice-vlm", phase_slice_vlm, torch, card)
    audio_counts, slice_audio = timed("slice-audio", phase_slice_audio, torch, card)
    serve_launch = timed("serve-launch", phase_serve_launch, torch, card)
    setup = timed("refresh-setup", refresh_setup, torch, card)
    refresh = timed("refresh", phase_refresh, torch, card, setup)
    refresh["ec"] = timed("refresh-ec", phase_refresh_ec, torch, card, setup, refresh["over_tps"])
    del setup
    ckpt = timed("ckpt", phase_ckpt, torch, card)
    launch_train = timed("launch-train", phase_launch_train, torch, card)
    sweep = timed("sweep", phase_sweep, torch)
    smoke_paper = timed("smoke-paper", phase_smoke_paper, torch)
    mlp_counts, paper_mlp = timed("paper-mlp", phase_paper_mlp, torch, card)
    resnet_counts, paper_resnet = timed("paper-resnet", phase_paper_resnet, torch, card)
    shard = timed("shard", phase_shard, torch, card, train)
    shard_2rank = timed("shard-2rank", phase_shard_2rank, torch, card)
    park = timed("park", phase_park, torch, card)
    serve_mesh = timed("serve-mesh", phase_serve_mesh, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun = timed("dryrun", phase_dryrun, torch, card)

    f128 = next(r for r in flash if r["S"] == 128 and r["softcap"] is None)
    bg = next(r for r in bma if r["mode"] == "probs" and r["T"] == 0.0)
    entries = [
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:30", f128),
        ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:37", paged[0]),
        ("bma_select", "src/repro_torch/kernels/csrc/bma_select.cu",
         "src/repro/kernels/bma_select.py:42", bg),
        ("fused_ec_update", "src/repro_torch/kernels/csrc/fused_ecsghmc.cu",
         "src/repro/kernels/fused_ecsghmc.py:54", fused),
        ("fused_precond_ec_update", "src/repro_torch/kernels/csrc/fused_ecsghmc.cu",
         "src/repro/kernels/fused_ecsghmc.py:156", precond),
        ("rglru_scan", "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:38",
         next(r for r in rglru if r["shape"] == (1, 128, 2560))),
        # no Pallas kernel: the reference's gradient of the scan is XLA's
        # autodiff of the block's jax.lax.associative_scan
        ("rglru_scan_bwd", "src/repro_torch/kernels/csrc/rglru.cu",
         "src/repro/models/recurrent.py:73",
         next(r for r in rglru if r["label"] == "backward train path" and not r["h0"])),
    ]
    kernels = [
        {"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": counts[n],
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for n, src, rep, r in entries
    ]
    # the serving kernels' launches on each path's greedy run, each counted from 0
    for i, name in enumerate(SERVING_KERNELS):
        kernels[i]["launches_by_path"] = {
            "slice": counts[name],
            **({"slice-hybrid": hybrid_counts[name]} if name in hybrid_counts else {}),
            **{f"slice-dense/{a}": c[name] for a, c in dense_counts.items() if name in c},
            **{f"slice-moe/{a}": c[name] for a, c in moe_counts.items()},
            "slice-xlstm": xlstm_counts[name],
            **{f"slice-vlm/{p}": c[name] for p, c in vlm_counts.items()},
            "slice-audio": audio_counts[name],
            **{f"serve-mesh/{label}": c[name] for label, c in serve_mesh["launches"].items()
               if label.startswith("nccl")},
            **{f"serve-mesh/gloo rank {r}": g["launches"][name]
               for r, g in serve_mesh["gloo"].items()}}
    kernels[5]["launches_by_path"] = {"slice-hybrid": hybrid_counts["rglru_scan"],
                                      "train-hybrid": hybrid_train_counts["rglru_scan"]}
    kernels[6]["launches_by_path"] = {"train-hybrid": hybrid_train_counts["rglru_scan_bwd"]}
    # the fused kernel's launches on each of its paths, each counted from 0
    kernels[3]["launches_by_path"] = {
        "train": train_counts["fused_ec_update"],
        "train-hybrid": hybrid_train_counts["fused_ec_update"],
        "refresh-ec": refresh["ec"]["launches"]["fused_ec_update"], "sweep": sweep["launches"],
        **{f"paper-mlp/{j}": n for j, n in mlp_counts.items() if n},
        **{f"paper-resnet/{j}": n for j, n in resnet_counts.items() if n},
        "shard": shard["raw"]["launches"], "shard-int8": shard["int8"]["launches"],
        "shard-2rank": shard_2rank["alpha 1"]["launches"],
        **{f"serve-mesh/refresh rank {r}": c["launches"]["fused_ec_update"]
           for r, c in serve_mesh["refresh"].items()}}
    (OUT / "result.json").write_text(json.dumps({"card": card, "kernels": kernels,
                                                  "flash": flash, "flash256": flash256,
                                                  "paged": paged, "ptxas": ptxas,
                                                  "bma": bma, "bma256k": bma256k,
                                                  "flash_family": flash_family,
                                                  "paged_moe": paged_moe,
                                                  "bma_family": bma_family,
                                                  "slice_dense": slice_dense,
                                                  "slice_moe": slice_moe,
                                                  "slice_xlstm": slice_xlstm,
                                                  "slice_vlm": slice_vlm,
                                                  "slice_audio": slice_audio,
                                                  "rglru": rglru,
                                                  "fused_ec": fused, "fused_precond": precond,
                                                  "hybrid": hybrid, "train": train,
                                                  "train_adaptive": train_adaptive,
                                                  "train_hybrid": train_hybrid,
                                                  "serve_launch": serve_launch,
                                                  "refresh": refresh, "ckpt": ckpt,
                                                  "launch_train": launch_train,
                                                  "stationary_async": stationary_async,
                                                  "sweep": sweep, "smoke_paper": smoke_paper,
                                                  "paper_mlp": paper_mlp,
                                                  "paper_resnet": paper_resnet,
                                                  "codec": codec, "shard": shard,
                                                  "shard_2rank": shard_2rank, "park": park,
                                                  "serve_mesh": serve_mesh,
                                                  "dryrun": dryrun,
                                                  "phase_s": phase_s},
                                                 indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
