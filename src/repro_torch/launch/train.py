"""Training launcher of the port: EC-SGHMC posterior sampling over a ported
arch (``train.loop`` over ``run.ChainExecutor``), with checkpoints,
auto-resume and a simulated preemption.

Runs on the card unless ``--device cpu`` is given.  The audio family's
batches carry frame embeddings, the vlm family's patch embeddings in
front of shorter text, both from seeded generators.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
      --device cpu --steps 100 --chains 4 --sync-every 4 --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch import obs
from repro_torch.core import ec_sghmc, rng as rnglib, sghmc, tree_broadcast_axis0
from repro_torch.data import synthetic_token_stream
from repro_torch.data.pipeline import chain_batches
from repro_torch.launch.specs import vlm_patches
from repro_torch.models import get_model, init_params
from repro_torch.models.common import tree_map
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.step import make_train_step

log = obs.get_logger("train")


def _embeds(seed: int, step: int, shape, dtype, device):
    """0.02 * N(0, 1) of ``shape`` in ``dtype``, from a generator seeded by
    (seed, step): the stubbed frontend's frame or patch embeddings."""
    gen = rnglib.generator(rnglib.fold_in(rnglib.key(seed), step), device)
    return (0.02 * torch.randn(shape, generator=gen, device=device)).to(dtype)


def build_batch_fn(cfg, num_chains: int, per_chain: int, seq_len: int, seed: int = 0,
                   device="cuda"):
    """step -> the chains' batch: tokens and labels (K, B, seq_len), plus
    frame_embeds (K, B, enc_seq, D) for the audio family, or patch_embeds
    (K, B, P, D) before text cut to seq_len - P for the vlm family (P =
    ``vlm_patches(seq_len)``), as the reference builds them."""
    sampler = synthetic_token_stream(cfg.vocab_size, seed, device=device)
    lead = (num_chains, per_chain)

    def fn(step: int):
        batch = chain_batches(sampler, step, num_chains, per_chain, seq_len)
        if cfg.family == "audio":
            batch["frame_embeds"] = _embeds(seed + 7, step, lead + (cfg.enc_seq, cfg.d_model),
                                            cfg.compute_dtype, device)
        if cfg.family == "vlm":
            n_patch = vlm_patches(seq_len)
            n_text = seq_len - n_patch
            batch["tokens"] = batch["tokens"][..., :n_text]
            batch["labels"] = batch["labels"][..., :n_text]
            batch["patch_embeds"] = _embeds(seed + 8, step, lead + (n_patch, cfg.d_model),
                                            cfg.compute_dtype, device)
        return batch

    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4, help="per-chain batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--step-size", type=float, default=1e-6)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--n-data", type=float, default=100_000,
                    help="corpus size for the N/|B| potential scale")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Perfetto trace.json of the run to PATH")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    tracer, trace_path = obs.configure(args.trace)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    model = get_model(cfg)
    batch_fn = build_batch_fn(cfg, args.chains, args.batch, args.seq, args.seed, args.device)
    if args.chains > 1:
        sampler = ec_sghmc(
            step_size=args.step_size, alpha=args.alpha, sync_every=args.sync_every,
            state_dtype=cfg.param_dtype,
        )
    else:
        sampler = sghmc(step_size=args.step_size, state_dtype=cfg.param_dtype)

    train_step = make_train_step(cfg, model, sampler, n_data=int(args.n_data))
    gen = rnglib.generator(rnglib.key(args.seed), args.device)
    params1 = init_params(model.param_specs(cfg), gen, args.device)
    # the chains are advanced in place: materialise the broadcast
    params = tree_map(lambda x: x.contiguous(), tree_broadcast_axis0(params1, args.chains))
    del params1
    state = sampler.init(params)

    loop_cfg = LoopConfig(
        num_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        preempt_at=args.preempt_at,
        seed=args.seed,
    )
    params, state, history = run(
        train_step, params, state, batch_fn, loop_cfg,
        num_chains=args.chains, alpha=args.alpha, sampler=sampler,
    )
    if history:
        log.info(f"final nll/token: {history[-1]['nll_per_token']:.4f}")
    if trace_path:
        tracer.export(trace_path)
        log.info(f"trace written to {trace_path} ({len(tracer)} events)")
    return history


if __name__ == "__main__":
    main()
