"""Synthetic datasets, drawn from ``torch.Generator``s (no downloads).

* ``synthetic_token_stream``: the reference's zipf(1.1) unigram plus
  local-bigram token law, stateless in the step, so a run can resume from
  a step index without replaying.
* ``synthetic_mnist`` / ``synthetic_cifar10``: teacher-labelled
  classification data with the shapes and sizes of the paper's datasets.
  Inputs are class-conditioned Gaussian mixtures; a fixed random teacher
  network defines p(y|x).  The law is the reference's; the numbers differ
  from ``jax.random``'s, so parity tests carry the reference's arrays over
  through numpy.
"""
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


def teacher_logits(x, gen: torch.Generator, hidden: int = 64, num_classes: int = 10,
                   temp: float = 2.0):
    """The teacher's logits tanh(x W1) W2 * temp, W1 ~ N(0, 1/d), W2 ~ N(0,
    1/hidden), with the weights drawn from ``gen``."""
    d = x.shape[-1]
    w1 = torch.randn((d, hidden), generator=gen, device=x.device) / math.sqrt(d)
    w2 = torch.randn((hidden, num_classes), generator=gen, device=x.device) / math.sqrt(hidden)
    return torch.tanh(x @ w1) @ w2 * temp


def categorical(logits, gen: torch.Generator):
    """One draw per row from softmax(logits) by the Gumbel-max trick (the
    reference's ``jax.random.categorical``), as int32."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def _teacher_labels(x, seed: int, **kw):
    gen = rnglib.generator(rnglib.key(seed), x.device)
    return categorical(teacher_logits(x, gen, **kw), gen)


def _mixture(n: int, shape, center_loc: float, center_scale: float, noise: float, seed: int,
             device):
    """x = centers[comp] + noise N(0, 1): 10 Gaussian centres
    center_loc + center_scale N(0, 1), each example's centre uniform."""
    gen = rnglib.generator(rnglib.key(seed), device)
    centers = center_loc + center_scale * torch.randn((10,) + shape, generator=gen, device=device)
    comp = torch.randint(0, 10, (n,), generator=gen, device=device)
    return centers[comp] + noise * torch.randn((n,) + shape, generator=gen, device=device)


def synthetic_mnist(n: int = 60_000, seed: int = 0, device="cuda"):
    """(x, y): x (n, 784) f32 in [0, 1]-ish, y (n,) int32 in [0, 10).
    MNIST-shaped."""
    x = _mixture(n, (784,), 0.5, 0.2, 0.15, seed, device)
    return x, _teacher_labels(x, seed + 1)


def synthetic_cifar10(n: int = 50_000, seed: int = 0, device="cuda"):
    """(x, y): x (n, 32, 32, 3) f32, y (n,) int32.  CIFAR-shaped; the
    teacher sees every fourth input value."""
    x = _mixture(n, (32, 32, 3), 0.0, 0.1, 0.25, seed, device)
    return x, _teacher_labels(x.reshape(n, -1)[:, ::4], seed + 1)
