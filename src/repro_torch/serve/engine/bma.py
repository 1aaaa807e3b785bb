"""Bayesian model averaging across the ensemble-member axis.

The K coupled chains' *product* is a posterior-predictive:
p(y|x) = (1/K) Σ_k p(y|x, θ_k).  ``mixture_logprobs`` reduces per-member
logits (K, ..., V) to the mixture's log-probs in f32:

* ``"probs"``     — log((1/K) Σ_k softmax(logits_k)), the arithmetic mixture;
* ``"logprobs"``  — softmax((1/K) Σ_k log softmax), the renormalised
  geometric mixture.

``reference_bma_decode`` is the sequential per-member oracle: a plain loop
over members, each with its own cache, combined step by step with the same
mixture + selection helpers.
"""
from __future__ import annotations

import math

import torch

from repro_torch.serve.sampling import GREEDY, SamplingParams, mask_after_eos, select_tokens

BMA_MODES = ("probs", "logprobs")


def mixture_logprobs(logits, mode: str = "probs"):
    """(K, ..., V) per-member logits -> (..., V) mixture log-probs (f32)."""
    if mode not in BMA_MODES:
        raise ValueError(f"mode must be one of {BMA_MODES}, got {mode!r}")
    lp = torch.log_softmax(logits.float(), dim=-1)
    if mode == "probs":
        return torch.logsumexp(lp, dim=0) - math.log(lp.shape[0])
    return torch.log_softmax(torch.mean(lp, dim=0), dim=-1)


def fused_mixture_select(logits, generator=None, *, mode: str = "probs",
                         sampling: SamplingParams = GREEDY, gumbel=None):
    """One-kernel mixture + selection: (K, S, V) per-member logits ->
    (tokens (S,), mixture logprobs (S, V)), through the bma_select kernel,
    which reproduces ``mixture_logprobs`` + ``select_tokens``; the Gumbel
    draw is taken outside the kernel from ``generator`` (or is ``gumbel``)."""
    from repro_torch.kernels import fused_bma_select

    if mode not in BMA_MODES:
        raise ValueError(f"mode must be one of {BMA_MODES}, got {mode!r}")
    return fused_bma_select(
        logits.contiguous(), generator, mode=mode,
        temperature=float(sampling.temperature), top_k=int(sampling.top_k), gumbel=gumbel,
    )


def reference_bma_decode(
    cfg,
    model,
    member_list,
    batch,
    max_seq: int,
    num_tokens: int,
    *,
    mode: str = "probs",
    sampling: SamplingParams = GREEDY,
    generator=None,
    eos_id: int | None = None,
    pad_id: int = 0,
):
    """Sequential per-member reference: K separate prefill/decode streams,
    mixed per step.  Returns (tokens (B, num_tokens), logprob trace
    (num_tokens, B, V)) — tokens post-EOS masked like the engine's."""
    logits_k, caches = [], []
    for p in member_list:
        logits, cache = model.prefill(cfg, p, batch, max_seq)
        logits_k.append(logits[:, -1])
        caches.append(cache)
    logp = mixture_logprobs(torch.stack(logits_k), mode)  # (B, V)
    tok = select_tokens(logp, generator, sampling)[:, None]
    out, trace = [tok], [logp]
    for _ in range(num_tokens - 1):
        logits_k = []
        for j, p in enumerate(member_list):
            logits, caches[j] = model.decode_step(cfg, p, caches[j], tok)
            logits_k.append(logits[:, -1])
        logp = mixture_logprobs(torch.stack(logits_k), mode)
        tok = select_tokens(logp, generator, sampling)[:, None]
        out.append(tok)
        trace.append(logp)
    seq = torch.cat(out, dim=1)
    if eos_id is not None:
        seq = mask_after_eos(seq, eos_id, pad_id)
    return seq, torch.stack(trace)
