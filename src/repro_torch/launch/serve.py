"""Serving launcher of the port.

Two paths:

* single-stream decoding, and ``ensemble_decode``, the whole-batch
  Bayesian-model-averaging loop over the members (kept as the simple
  reference implementation);
* ``--engine``: the continuous-batching posterior-predictive engine
  (``repro_torch.serve.engine``) — request-level scheduling over a fixed
  slot axis, cache pooling, BMA over K ensemble members, and
  (``--refresh-every``) live snapshot refresh from a background
  coupled-sampler run, overlapped on a side CUDA stream
  (``--refresh-mode overlapped``, the default) or inline (``sync``).

Runs on the card unless ``--device cpu`` is given; on the card the prefill
goes through the flash attention kernel.  The audio family (whisper) runs
the first path only, with random frame embeddings for its stubbed
frontend; the engine, like the reference's, takes token prompts only.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \\
      --device cpu --batch 4 --prompt-len 16 --gen 8 --ensemble 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \\
      --device cpu --engine --slots 4 --requests 12 --ensemble 2 --refresh-every 8
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch import core
from repro_torch import obs
from repro_torch.core import rng as rnglib
from repro_torch.models import get_model, init_params
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve.engine import (
    ChainRefresher,
    RefreshScheduler,
    ServeEngine,
    SnapshotRegistry,
    synthetic_trace,
)
from repro_torch.serve.loop import (
    collect_ensemble,
    ensemble_diagnostics,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.serve.sampling import SamplingParams

log = obs.get_logger("serve")

# prior-bootstrap ensemble: members are thinned SGLD draws from
# N(params_init, PRIOR_SCALE^2 I) — a posterior stand-in when no sampled
# checkpoint is supplied; the spread matches the init scale so BMA is
# exercised with realistic dispersion.
PRIOR_SCALE = 0.02
_PREC = 1.0 / PRIOR_SCALE**2
_EPS = 0.2 / _PREC  # eps*lam = 0.2: stable, mixes in ~5 steps


def _prior_grad(center):
    """grad of the bootstrap prior N(center, PRIOR_SCALE^2 I); broadcasting
    makes it work for unstacked and (K,...)-stacked params."""
    return lambda p: tree_map(lambda x, x0: _PREC * (x - x0), p, center)


def _init(specs, key, device):
    return init_params(specs, rnglib.generator(key, device), device)


def _bootstrap_ensemble(specs, key, num: int, device="cuda"):
    """``num`` members as thinned SGLD draws of ONE chain around the prior
    center drawn from ``key``."""
    center = _init(specs, key, device)
    start = tree_map(lambda x: x + 0.0, center)  # the rollout advances it in place
    members, res = collect_ensemble(
        core.sgld(step_size=_EPS), _prior_grad(center), start,
        num_samples=num, key=rnglib.fold_in(key, 1), thin=16,
    )
    return members, res


def _live_refresher(specs, key, registry: SnapshotRegistry, chunk_steps: int = 16,
                    mode: str = "overlapped", device="cuda"):
    """Background chain-stacked SGLD over the same bootstrap prior — the
    live run whose chunk-boundary chain stack refreshes the registry.
    ``mode='overlapped'`` (default) builds the ``RefreshScheduler`` (side
    CUDA stream); ``'sync'`` the inline ``ChainRefresher``."""
    center = _init(specs, key, device)
    k = registry.num_members
    start = tree_map(lambda x: x[None].expand((k,) + tuple(x.shape)).contiguous(), center)
    cls = RefreshScheduler if mode == "overlapped" else ChainRefresher
    return cls(
        registry,
        core.sgld(step_size=_EPS),
        _prior_grad(center),
        start,
        key=rnglib.fold_in(key, 2),
        chunk_steps=chunk_steps,
    )


@torch.no_grad()
def ensemble_decode(cfg, model, params_stack, batch, max_seq: int, num_tokens: int):
    """Greedy decode of the mean predictive probs over the chain/ensemble
    axis of params, one member after the other."""
    k = int(tree_leaves(params_stack)[0].shape[0])
    members = [tree_map(lambda a: a[i], params_stack) for i in range(k)]

    def mean_probs(logits_list):
        total = sum(torch.softmax(lg.float(), -1) for lg in logits_list)
        return total / k

    caches, logits = [], []
    for p in members:
        lg, c = model.prefill(cfg, p, batch, max_seq)
        logits.append(lg)
        caches.append(c)
    tok = torch.argmax(mean_probs(logits)[:, -1], -1).to(torch.int32)[:, None]
    out = [tok]
    for _ in range(num_tokens - 1):
        logits = []
        for i, p in enumerate(members):
            lg, caches[i] = model.decode_step(cfg, p, caches[i], tok)
            logits.append(lg)
        tok = torch.argmax(mean_probs(logits)[:, -1], -1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def _config(args):
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if torch.device(args.device).type == "cuda":
        cfg = cfg.replace(use_flash_kernel=True)  # the prefill's kernel on the card
    return cfg


def _run_engine(args, cfg, model):
    if cfg.family == "audio":
        raise ValueError("the engine takes token prompts only: serve the audio family "
                         "without --engine")
    specs = model.param_specs(cfg)
    key = rnglib.key(args.seed)
    k = max(args.ensemble, 1)
    if k > 1:
        members, res = _bootstrap_ensemble(specs, key, k, args.device)
        log.info(f"ensemble: K={k} collected at {res.steps_per_s:.0f} steps/s")
        del res
    else:
        members = tree_map(lambda x: x[None], _init(specs, key, args.device))
    registry = SnapshotRegistry(members)
    del members
    refresher = None
    if args.refresh_every and k > 1:
        refresher = _live_refresher(specs, key, registry, mode=args.refresh_mode,
                                    device=args.device)
    max_seq = args.prompt_len + args.gen + 1
    engine = ServeEngine(
        cfg, model, registry,
        num_slots=args.slots, max_seq=max_seq,
        sampling=SamplingParams(args.temperature, args.top_k),
        bma=args.bma, eos_id=args.eos, seed=args.seed,
        refresher=refresher, refresh_every=args.refresh_every,
        device=args.device,
    )
    trace = synthetic_trace(
        args.requests,
        vocab_size=cfg.vocab_size,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        max_new=args.gen,
        mean_interarrival=args.interarrival,
        seed=args.seed,
    )
    report = engine.run(trace)
    pct = report.latency_percentiles()
    log.info(
        f"served {len(report.results)} requests / {report.total_tokens} tokens "
        f"in {report.wall_s:.2f}s ({report.tokens_per_s:.1f} tok/s, "
        f"slots={args.slots}, K={k}, decode_calls={report.trace_counts.get('decode')})"
    )
    log.info(
        f"latency p50={pct['latency_p50_s'] * 1e3:.1f}ms p99={pct['latency_p99_s'] * 1e3:.1f}ms  "
        f"first-token p50={pct['first_token_p50_s'] * 1e3:.1f}ms "
        f"p99={pct['first_token_p99_s'] * 1e3:.1f}ms"
    )
    if refresher is not None:
        rf = report.refresher
        log.info(f"snapshots: {report.registry['version']} promoted, "
                 f"{report.registry['rejected']} rejected, {rf['steps_done']} sampler steps")
        if "pump_wall_s" in rf:  # overlapped scheduler observability
            log.info(
                f"overlap: {rf['micro_chunks']} micro-chunks of {rf['micro_steps']} steps "
                f"on {rf['device'] or 'the serving device (side stream)'}, "
                f"pump {rf['pump_wall_s']:.3f}s, "
                f"per-refresh {rf['per_refresh_wall_s'] * 1e3:.1f}ms, "
                f"stalled {rf['decode_steps_stalled']} ticks ({rf['stall_wall_s']:.3f}s), "
                f"deferred {rf['flips_deferred']} flips"
            )
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--ensemble", type=int, default=1, help="posterior samples to average")
    ap.add_argument("--seed", type=int, default=0)
    # engine path
    ap.add_argument("--engine", action="store_true", help="continuous-batching engine")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--interarrival", type=float, default=2.0,
                    help="mean decode-steps between arrivals")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--bma", choices=("probs", "logprobs"), default="probs")
    ap.add_argument("--eos", type=int, default=None)
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="decode-step cadence of live snapshot refresh (0 = frozen members)")
    ap.add_argument("--refresh-mode", choices=("overlapped", "sync"), default="overlapped",
                    help="overlapped: micro-chunks on a side CUDA stream (decode never waits); "
                         "sync: inline ChainRefresher")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Perfetto trace.json of the run to PATH")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    tracer, trace_path = obs.configure(args.trace)
    cfg = _config(args)
    model = get_model(cfg)
    if args.engine:
        report = _run_engine(args, cfg, model)
        if trace_path:
            tracer.export(trace_path)
            log.info(f"trace written to {trace_path} ({len(tracer)} events)")
        return report
    max_seq = args.prompt_len + args.gen + 1
    key = rnglib.key(args.seed)
    gen = rnglib.generator(key, args.device)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                     generator=gen, device=args.device, dtype=torch.int32)}
    if cfg.family == "audio":  # the stubbed frontend's frame embeddings
        batch["frame_embeds"] = 0.02 * torch.randn((args.batch, cfg.enc_seq, cfg.d_model),
                                                   generator=gen, device=args.device)

    t0 = time.time()
    if args.ensemble > 1:
        # one sampler run, thinned trace = the ensemble
        params, res = _bootstrap_ensemble(model.param_specs(cfg), key, args.ensemble, args.device)
        health = ensemble_diagnostics(params)
        log.info(
            f"ensemble: K={health['num_chains']} spread={health['chain_spread']:.3e} "
            f"rel={health['rel_spread']:.3e} "
            f"(collected at {res.steps_per_s:.0f} steps/s)"
            + (" [COLLAPSED — BMA is a no-op]" if health["collapsed"] else "")
        )
        del res
        toks = ensemble_decode(cfg, model, params, batch, max_seq, args.gen)
    else:
        params = _init(model.param_specs(cfg), key, args.device)
        prefill = make_prefill_step(cfg, model, max_seq)
        step = make_decode_step(cfg, model)
        with torch.no_grad():
            tok, cache = prefill(params, batch)
            out = [tok]
            for _ in range(args.gen - 1):
                tok, cache = step(params, cache, tok)
                out.append(tok)
        toks = torch.cat(out, dim=1)
    toks = toks.cpu()
    dt = time.time() - t0
    log.info(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
             f"({args.batch * args.gen / dt:.1f} tok/s, ensemble={args.ensemble})")
    log.info(str(toks))
    if trace_path:
        tracer.export(trace_path)
        log.info(f"trace written to {trace_path} ({len(tracer)} events)")
    return toks


if __name__ == "__main__":
    main()
