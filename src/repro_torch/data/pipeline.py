"""Chain-stacked LM batches.  Batch t is a pure function of (seed, t), so
restart and resume need only the step counter; per the paper, every chain
draws its own minibatch."""
from __future__ import annotations

from typing import Callable


def chain_batches(sampler: Callable, step: int, num_chains: int, per_chain: int, seq_len: int):
    """LM batches with a leading chain axis, from a synthetic token sampler:
    tokens and labels (num_chains, per_chain, seq_len)."""
    toks = sampler(step, (num_chains, per_chain, seq_len + 1))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
