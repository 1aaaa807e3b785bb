"""The port's paged admission contract: ``BlockAllocator.can_admit``
reserves the pages of ``prompt + max_new - 1`` positions, the engine's
budget (the first token comes out of the prefill, and ``ServeEngine``
decodes ``max_new - 1`` more), so an admitted request never exhausts the
pool mid-decode.

A seeded property test drives that budget over 3000 random interleavings
of admits, decode writes and releases, in the ranges of the reference's
``tests/test_paged_cache.py::TestAllocatorProperties``, checking every
invariant after each operation.  The reference's hypothesis test drives
``max_new`` writes, one more than the budget: its falsifying example
passes here under the budget and exhausts the pool under ``max_new``
writes, which pins the off-by-one in that test, not in the gate.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.serve.engine import BlockAllocator

LENS = (1, 2, 5, 8)
MAX_NEWS = (1, 3, 6)
MAX_SEQ = 16


def _interleave(a: BlockAllocator, ops, writes_per_request):
    """ops: ints; even -> try admit, odd -> a decode write or a release.
    ``writes_per_request(max_new)`` is the number of decode writes an
    admitted request may make.  Returns (admits, decode writes)."""
    live: dict[int, int] = {}
    admits = writes = 0
    for k, op in enumerate(ops):
        if op % 2 == 0:
            slot = next((s for s in range(a.num_slots) if s not in live), None)
            plen, mn = LENS[k % len(LENS)], MAX_NEWS[k % len(MAX_NEWS)]
            if slot is not None and a.can_admit(np.arange(plen), mn):
                a.admit(slot, np.arange(plen, dtype=np.int32), mn)
                live[slot] = writes_per_request(mn)
                admits += 1
        elif live:
            slot = sorted(live)[op % len(live)]
            if live[slot] > 0 and op % 3:
                a.ensure_decode_block(slot)
                a.advance(slot)
                live[slot] -= 1
                writes += 1
            else:
                a.release(slot)
                del live[slot]
        a.check()
    for slot in list(live):
        a.release(slot)
    a.check()
    assert a.free_blocks == a.num_blocks - 1  # everything returned
    return admits, writes


def _engine_budget(max_new):
    return max_new - 1


def test_seeded_interleavings_within_the_engine_budget():
    rng = np.random.default_rng(2024)
    admitted = writes = 0
    for trial in range(3000):
        a = BlockAllocator(num_blocks=int(rng.integers(3, 25)), block_size=int(rng.integers(1, 6)),
                           max_seq=MAX_SEQ, num_slots=int(rng.integers(1, 6)),
                           prefix_sharing=bool(rng.integers(0, 2)))
        ops = rng.integers(0, 100, size=int(rng.integers(1, 61))).tolist()
        n_admits, n_writes = _interleave(a, ops, _engine_budget)
        admitted += n_admits
        writes += n_writes
    assert admitted > 3000 and writes > 3000  # the trials admitted and decoded


FALSIFYING = dict(ops=[0, 0, 1, 1, 1], num_blocks=3, block_size=4, num_slots=2, sharing=False)


def _falsifying_allocator():
    ex = FALSIFYING
    return BlockAllocator(num_blocks=ex["num_blocks"], block_size=ex["block_size"],
                          max_seq=MAX_SEQ, num_slots=ex["num_slots"],
                          prefix_sharing=ex["sharing"])


def test_reference_falsifying_example_holds_within_the_budget():
    _interleave(_falsifying_allocator(), FALSIFYING["ops"], _engine_budget)


def test_one_write_past_the_budget_can_exhaust_the_pool():
    """The reference test's drive (``max_new`` writes) on its falsifying
    example: the gate reserved one position fewer, as the engine needs."""
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        _interleave(_falsifying_allocator(), FALSIFYING["ops"], lambda mn: mn)
