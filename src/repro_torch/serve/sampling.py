"""Token selection shared by the engine's paths.

``select_tokens(logits, generator, sampling)`` maps ``(..., V)`` logits (or
mixture log-probs — selection is shift-invariant per row) to int32 token
ids.  ``temperature == 0`` is greedy argmax and needs no generator; any
positive temperature is argmax(logits / T + Gumbel), optionally restricted
to the top-k, with the Gumbel noise drawn by :func:`gumbel_noise` from the
caller's ``torch.Generator``.  The fused kernel path draws the identical
tensor the same way, so fused and unfused tokens are bit-equal.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SamplingParams(NamedTuple):
    """Selection policy.  ``temperature=0`` ⇒ greedy (generator unused);
    ``top_k=0`` ⇒ full-vocabulary support."""

    temperature: float = 0.0
    top_k: int = 0


GREEDY = SamplingParams()


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draw -log(-log(u)), u uniform in [tiny, 1), f32."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _top_k_mask(logits, k: int):
    """-inf everything below the k-th largest logit per row (ties at the
    k-th value kept)."""
    k = min(int(k), logits.shape[-1])
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, float("-inf"), logits)


def select_tokens(logits, generator: torch.Generator | None = None,
                  sampling: SamplingParams = GREEDY, gumbel=None):
    """``logits (..., V)`` -> int32 tokens ``(...)``.

    Greedy (``temperature == 0``) is exact argmax (first maximum).
    Otherwise logits are scaled by ``1/temperature``, optionally top-k
    masked, and sampled as argmax(scaled + Gumbel) with one (..., V) draw
    from ``generator``, or with the draw ``gumbel`` given (the rows of a
    larger draw, for a rank that selects some of the slots)."""
    from repro_torch.models.spmd import replicate_dims

    logits = replicate_dims(logits, [-1])  # a DTensor's vocabulary whole on every rank
    if sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None and gumbel is None:
        raise ValueError("temperature > 0 sampling needs a generator")
    scaled = logits.float() / float(sampling.temperature)
    if sampling.top_k:
        scaled = _top_k_mask(scaled, sampling.top_k)
    if gumbel is None:
        gumbel = gumbel_noise(scaled.shape, generator, scaled.device)
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


def mask_after_eos(tokens, eos_id: int, pad_id: int = 0):
    """Replace every token strictly after the first ``eos_id`` per row with
    ``pad_id`` (the EOS itself is kept).  tokens: (B, T) int."""
    hit = (tokens == eos_id).to(torch.int32)
    prior_hits = torch.cumsum(hit, dim=-1) - hit
    return torch.where(prior_hits > 0, torch.full_like(tokens, pad_id), tokens)
