"""Data pipeline: chain-stacked LM batches, the sharded loader of the
paper's classification experiments, and ``place``, which cuts a rank's
chains out of a global batch.  Batch t is a pure function of (seed, t), so
restart and resume need only the step counter; per the paper, every chain
(or worker) draws its own minibatch."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def chain_batches(sampler: Callable, step: int, num_chains: int, per_chain: int, seq_len: int):
    """LM batches with a leading chain axis, from a synthetic token sampler:
    tokens and labels (num_chains, per_chain, seq_len)."""
    toks = sampler(step, (num_chains, per_chain, seq_len + 1))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


class ShardedLoader:
    """Classification datasets (the paper's experiments): (x, y) -> per-chain
    minibatches by stateless sampling with replacement.  The indices come
    from numpy's ``default_rng((seed, step))``, as in the reference, so the
    batches are the reference's, index for index.  The dataset lives on
    ``device`` (numpy arrays are copied there once; tensors are moved), and
    batches are gathered there."""

    def __init__(self, x, y, batch_size: int, num_chains: int = 1, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        put = lambda a: (a.to(self.device) if isinstance(a, torch.Tensor)
                         else torch.tensor(np.asarray(a), device=self.device))
        self.x, self.y = put(x), put(y)
        self.n = int(self.x.shape[0])
        self.bs = batch_size
        self.k = num_chains
        self.seed = seed

    def indices(self, step: int) -> np.ndarray:
        """The (K, B) example indices of batch ``step``."""
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, self.n, size=(self.k, self.bs))

    def batch(self, step: int):
        """{"x": (K, B, ...), "y": (K, B)} for chain-stacked steps, or
        unstacked when num_chains == 1."""
        idx = torch.from_numpy(self.indices(step))
        if self.device.type == "cuda":  # from pinned memory: the copy does not wait for the card
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        bx, by = self.x[idx], self.y[idx]
        if self.k == 1:
            bx, by = bx[0], by[0]
        return {"x": bx, "y": by}


def place(batch, mesh, *, num_chains: int, axis: str = "chain", device=None):
    """This rank's part of a global batch for a run whose chains are split
    over the ``axis`` dimension of ``mesh``: every tensor with a leading
    chain axis of ``num_chains`` cut to the rank's chains (the reference
    device_puts the batch against its chain sharding), moved to ``device``
    when one is given."""
    from repro_torch.distributed import sharding
    from repro_torch.models.common import map_tensors

    local = sharding.local_chains(batch, mesh, num_chains, axis)
    if device is None:
        return local
    return map_tensors(lambda x: x.to(device, non_blocking=True), local)
