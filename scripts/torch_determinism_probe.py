#!/usr/bin/env python3
"""Is the port's training forward/backward reproducible on the card, and
what does ``torch.use_deterministic_algorithms(True)`` change?

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_determinism_probe.py

At qwen3-0.6b's full width, K = 4 chains, batch 4 x 64 per chain (the
``[train]`` configuration of ``chip_smoke.py``), with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the first CUDA call:

1. ``make_grad_fn`` three times on the same parameters and batch, with the
   flag off and then on (fresh parameters from the same seed for each):
   the step-1 nll, and whether the gradients repeat bit for bit;
2. chain 0's forward with grad enabled (leaves that require grad), with
   the flag off, on, and off again, under a dispatch mode that sums every
   floating-point op's output: the first op whose output differs;
3. one chain's forward and backward under ``torch.profiler``, flag off and
   on: device time and the top kernels.

It prints its findings; it asserts nothing.
"""
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import chain_batches, synthetic_token_stream  # noqa: E402
from repro_torch.models import get_model, tree_leaves, tree_map  # noqa: E402
from repro_torch.models.common import tree_unflatten  # noqa: E402
from repro_torch.train.step import make_grad_fn  # noqa: E402

K = 4


class OpSums(TorchDispatchMode):
    """Records (op, input shapes, f64 sum of the output) of every op whose
    output is a floating-point tensor."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            self.log.append((str(func), shapes, out.detach().double().sum().item()))
        return out


def grad_reps(cfg, model, batch, det, reps=3):
    params = cs.stacked_members(torch, cfg, model, K, "cuda", seed0=300)
    gf = make_grad_fn(cfg, model, cs.TRAIN_N_DATA)
    torch.use_deterministic_algorithms(det)
    try:
        outs = []
        for _ in range(reps):
            g, m = gf(params, batch)
            outs.append(([x.detach().cpu() for x in tree_leaves(g)], float(m["nll_per_token"])))
            del g
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(all(torch.equal(a, b) for a, b in zip(outs[0][0], o[0])) and o[1] == outs[0][1]
               for o in outs[1:])
    print(f"[grad] flag {'on ' if det else 'off'}: step-1 nll {[o[1] for o in outs]}; "
          f"gradients and nll repeat bitwise over {reps} reps: {same}", flush=True)
    del params
    torch.cuda.empty_cache()


def op_trace(cfg, model, p0, b0, det):
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p0)]
    torch.use_deterministic_algorithms(det)
    try:
        rec = OpSums()
        with rec:
            s, c = model.train_nll(cfg, tree_unflatten(p0, leaves), b0)
        nll = (s / c).item()
    finally:
        torch.use_deterministic_algorithms(False)
    return nll, rec.log


def profiled(cfg, model, params, batch, det):
    gf = make_grad_fn(cfg, model, cs.TRAIN_N_DATA)
    one = tree_map(lambda x: x[:1], batch)
    torch.use_deterministic_algorithms(det)
    try:
        gf(params, one)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gf(params, one)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    ev = cs.device_kernels(prof)
    total = sum(e.self_device_time_total for e in ev)
    print(f"[profile] flag {'on ' if det else 'off'}: one chain's forward and backward, device "
          f"{total / 1e3:.1f} ms over {sum(e.count for e in ev)} kernels", flush=True)
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:100]}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    cfg = configs.get_config("qwen3-0.6b")
    model = get_model(cfg)
    stream = synthetic_token_stream(cfg.vocab_size, seed=0, device="cuda")
    batch = chain_batches(stream, 0, K, 4, 64)
    for det in (False, True):
        grad_reps(cfg, model, batch, det)
    params = cs.stacked_members(torch, cfg, model, 1, "cuda", seed0=300)
    p0, b0 = tree_map(lambda x: x[0], params), tree_map(lambda x: x[0], batch)
    runs = [op_trace(cfg, model, p0, b0, det) for det in (False, True, False)]
    print(f"[ops] chain 0's forward with grad: nll flag off/on/off {[r[0] for r in runs]}; "
          f"{len(runs[0][1])} ops; off == off again: {runs[0][1] == runs[2][1]}", flush=True)
    diff = next((i for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1])) if a != b), None)
    if diff is None:
        print("[ops] no op's output differs between flag off and on", flush=True)
    else:
        for i in range(max(0, diff - 2), min(len(runs[0][1]), diff + 3)):
            a, b = runs[0][1][i], runs[1][1][i]
            print(f"[ops] {'->' if i == diff else '  '} #{i} {a[0]} {a[1]}: off {a[2]!r} on {b[2]!r}",
                  flush=True)
    for det in (False, True):
        profiled(cfg, model, params, batch, det)
    return 0


if __name__ == "__main__":
    sys.exit(main())
