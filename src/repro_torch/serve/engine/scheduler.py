"""Request model + admission bookkeeping for the continuous-batching engine.

The scheduler's clock is the DECODE STEP: one tick = one execution of the
engine's single compiled decode program over the fixed slot axis.  Requests
carry an ``arrival_step`` on that clock (synthetic traces; a network server
would map wall-clock arrivals onto ticks the same way).  Admission policy is
plain FCFS: at every tick, pending requests whose arrival has passed are
prefilled into free slots, newest slots join the in-flight batch mid-decode,
and finished slots are recycled — all without changing any traced shape.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Request:
    """One generation request: ``prompt`` (1-D int32 token ids), up to
    ``max_new`` generated tokens (EOS may end it earlier), visible to the
    scheduler from ``arrival_step`` onward."""

    rid: int
    prompt: np.ndarray
    max_new: int
    arrival_step: int = 0

    def __post_init__(self):
        object.__setattr__(self, "prompt", np.asarray(self.prompt, np.int32).reshape(-1))
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")


@dataclass
class RequestResult:
    """Per-request outcome + latency breakdown (seconds are wall-clock from
    the moment the request became schedulable, i.e. queueing included)."""

    rid: int
    prompt_len: int
    tokens: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    admitted_step: int = -1
    finished_step: int = -1
    first_token_s: float = float("nan")
    latency_s: float = float("nan")
    hit_eos: bool = False
    truncated: bool = False  # run() hit max_steps with this request in flight
    logprobs: np.ndarray | None = None  # (num_tokens, V), engine opt-in

    @property
    def num_tokens(self) -> int:
        return int(self.tokens.size)


class FCFSQueue:
    """Arrival-ordered pending queue; ``admissible(step)`` pops the next
    request visible at ``step`` (or None)."""

    def __init__(self, requests):
        self._q = deque(sorted(requests, key=lambda r: (r.arrival_step, r.rid)))

    def __len__(self) -> int:
        return len(self._q)

    def next_arrival(self) -> int | None:
        return self._q[0].arrival_step if self._q else None

    def visible(self, step: int):
        """Requests already schedulable at ``step`` (arrival passed), in
        admission order — still queued, possibly waiting for a slot."""
        return [r for r in self._q if r.arrival_step <= step]

    def admissible(self, step: int):
        if self._q and self._q[0].arrival_step <= step:
            return self._q.popleft()
        return None

    def peek(self, step: int):
        """Head-of-line request visible at ``step`` WITHOUT popping — the
        paged engine inspects it against the block pool's ``can_admit``
        before committing (FCFS means a head that does not fit blocks the
        line; it is admitted once completions free enough pages)."""
        if self._q and self._q[0].arrival_step <= step:
            return self._q[0]
        return None

    def pop(self):
        """Pop the head unconditionally (pairs with a prior ``peek``)."""
        return self._q.popleft()


def synthetic_trace(
    num_requests: int,
    *,
    vocab_size: int,
    prompt_lens=(8, 16),
    max_new: int = 16,
    mean_interarrival: float = 2.0,
    seed: int = 0,
    prompt_pool: int = 0,
) -> list:
    """Poisson open-loop request trace: exponential inter-arrival times
    (mean ``mean_interarrival`` decode steps — the offered-load knob)
    accumulated in continuous time and floored onto the tick clock, so
    sub-tick means (< 1) genuinely produce multiple arrivals per tick.
    Prompt lengths cycle through ``prompt_lens``; token ids are random.

    ``prompt_pool > 0`` draws prompts from a fixed pool of that many
    distinct prompts instead of fresh ones per request — the knob that
    exercises (and benchmarks) paged prefix sharing: a pool of P prompts
    gives an expected steady-state prefix hit rate of 1 - P/num_requests."""
    if mean_interarrival <= 0:
        raise ValueError("mean_interarrival must be > 0")
    rng = np.random.default_rng(seed)
    pool = [
        rng.integers(
            0, vocab_size, size=int(prompt_lens[i % len(prompt_lens)])
        ).astype(np.int32)
        for i in range(prompt_pool)
    ]
    reqs, t = [], 0.0
    for rid in range(num_requests):
        if pool:
            prompt = pool[rid % len(pool)]
        else:
            L = int(prompt_lens[rid % len(prompt_lens)])
            prompt = rng.integers(0, vocab_size, size=L).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=max_new, arrival_step=int(t)))
        t += rng.exponential(mean_interarrival)
    return reqs
