#!/usr/bin/env python3
"""How far are the port's f32 SMOKE runs from f64 runs of the same
inputs?  A measure of how much f32 rounding a SMOKE model amplifies,
which sets how closely two f32 runs (the card and the CPU) can agree in
``chip_smoke.py``'s SMOKE checks.

Run from the repository root, on the CPU:

    PYTHONPATH=src python3 scripts/torch_f64_distance.py [arch ...]

For each arch's SMOKE config (every arch by default):

* training: K = 4 members drawn as ``chip_smoke.py``'s SMOKE training
  check draws them (``stacked_members``, seed0 200) and the family's batch
  of step 0 from ``launch.train.build_batch_fn`` (2 x 16 tokens per chain,
  seed 5: frame or patch embeddings included); each chain's ``train_nll``
  gradient.  Printed: the worst leaf's max|g32 - g64| / max|g64| over the
  K chains;
* serving (the decoder-only families): the dense ``ServeEngine`` on
  ``chip_smoke.phase_smoke_engine``'s members (seed0 100) and trace, with
  the plain attention path (the kernels' plain versions take f32 or bf16
  only).  Printed: the largest |logp32 - logp64|
  over the requests' recorded log-prob rows, and whether the tokens agree.

The f64 runs cast the params, the batch's float inputs and the config's
dtypes to f64, and make ``Tensor.float()`` (the forward's f32 upcasts)
and the recurrent states f64 while they run.  It asserts nothing.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.train import build_batch_fn  # noqa: E402
from repro_torch.models import get_model, tree_leaves  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import tree_unflatten  # noqa: E402

K = 4


def grads(cfg, model, members, batch, dtype):
    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    out = []
    for k in range(K):
        leaves = [x[k].to(dtype).clone().requires_grad_(True) for x in tree_leaves(members)]
        b = {key: (v[k].to(dtype) if v.is_floating_point() else v[k]) for key, v in batch.items()}
        s, _ = model.train_nll(cfg, tree_unflatten(members, leaves), b)
        out.append(torch.autograd.grad(s, leaves))
    return out


class F64:
    """``Tensor.float()`` and the recurrent layers' state inits give f64
    while active."""

    def __enter__(self):
        self.saved = (torch.Tensor.float, dict(T._STATE_INIT),
                      {n: getattr(R, n) for n in ("mlstm_init_state", "slstm_init_state")})
        torch.Tensor.float = lambda x, *a, **kw: x.to(torch.float64)
        for name, fn in self.saved[2].items():
            wrapped = (lambda f: lambda *a, **kw: {k: v.double() for k, v in f(*a, **kw).items()})(fn)
            setattr(R, name, wrapped)
            T._STATE_INIT[name.split("_")[0]] = wrapped

    def __exit__(self, *exc):
        torch.Tensor.float = self.saved[0]
        T._STATE_INIT.update(self.saved[1])
        for name, fn in self.saved[2].items():
            setattr(R, name, fn)


def distance(arch):
    cfg = configs.get_config(arch, smoke=True)
    model = get_model(cfg)
    members = chip_smoke.stacked_members(torch, cfg, model, K, "cpu", seed0=200)
    batch = build_batch_fn(cfg, K, 2, 16, seed=5, device="cpu")(0)
    g32 = grads(cfg, model, members, batch, torch.float32)
    with F64():
        g64 = grads(cfg, model, members, batch, torch.float64)
    worst = 0.0
    for a, b in ((a, b) for c32, c64 in zip(g32, g64) for a, b in zip(c32, c64)):
        worst = max(worst, float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    return worst


def engine_logprobs(cfg, model, members, trace, dtype):
    from repro_torch.models import tree_map
    from repro_torch.serve.engine import ServeEngine

    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    members = tree_map(lambda x: x.to(dtype), members)
    rep = ServeEngine(cfg, model, members, num_slots=4, max_seq=24, record_logprobs=True,
                      device="cpu").run(trace)
    return rep.results


def engine_distance(arch):
    from repro_torch.serve.engine import synthetic_trace

    cfg = configs.get_config(arch, smoke=True)
    model = get_model(cfg)
    members = chip_smoke.stacked_members(torch, cfg, model, 4, "cpu", seed0=100)
    trace = synthetic_trace(6, vocab_size=cfg.vocab_size, prompt_lens=(16, 8), max_new=6, seed=3)
    r32 = engine_logprobs(cfg, model, members, trace, torch.float32)
    with F64():
        r64 = engine_logprobs(cfg, model, members, trace, torch.float64)
    same = all((a.tokens == b.tokens).all() for a, b in zip(r32, r64))
    return max(float(abs(a.logprobs - b.logprobs).max()) for a, b in zip(r32, r64)), same


def main(argv):
    for arch in argv or configs.ARCH_IDS:
        line = f"{arch}: training, worst leaf max|g32 - g64| / max|g64| = {distance(arch):.3e}"
        if configs.get_config(arch, smoke=True).family != "audio":
            d, same = engine_distance(arch)
            line += f"; serving, max|logp32 - logp64| = {d:.3e}, tokens equal {same}"
        print(line, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
