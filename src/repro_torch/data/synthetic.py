"""Synthetic token data: the reference's zipf(1.1) unigram plus
local-bigram law, drawn from ``torch.Generator``s.  Stateless in the step,
so a run can resume from a step index without replaying."""
from __future__ import annotations

import math

import torch

from repro_torch.core import rng as rnglib


def synthetic_token_stream(vocab_size: int, seed: int = 0, device="cuda"):
    """Deterministic token sampler: ``sample(step, shape) -> int32 tokens``
    on ``device``.  Each token is drawn from zipf(1.1) over the vocabulary
    (rank r has probability ∝ r^-1.1); then, with probability 0.3, it is
    replaced by ``(previous token * 31 + 7) % vocab_size`` (the previous
    token along the last axis, cyclically), as ``repro.data.synthetic``
    does."""
    base = rnglib.key(seed)
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32, device=device)
    probs = torch.softmax(-1.1 * torch.log(ranks), dim=0)

    def sample(step: int, shape):
        key = rnglib.fold_in(base, step)
        gen = rnglib.generator(key, device)
        toks = torch.multinomial(probs, math.prod(shape), replacement=True, generator=gen)
        toks = toks.view(shape)
        shifted = torch.roll(toks, 1, dims=-1)
        mix = torch.rand(shape, generator=rnglib.generator(rnglib.fold_in(key, 1), device),
                         device=device) < 0.3
        return torch.where(mix, (shifted * 31 + 7) % vocab_size, toks).to(torch.int32)

    return sample


def token_batch(sampler, step: int, batch_shape, seq_len: int):
    """LM batch dict: inputs + next-token labels."""
    toks = sampler(step, tuple(batch_shape) + (seq_len + 1,))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
