"""Snapshot registry: the serving engine's source of ensemble members,
refreshed live from a background coupled-sampler run.

Elastic coupling absorbs a stale or perturbed center into the
center-noise covariance of Eq. 6, so serving from members that lag the
live chains by up to one executor chunk, and swapping them mid-flight, is
a controlled perturbation of the same kind.

Promotion is GATED: a candidate stack must pass the ensemble-spread check
(``repro_torch.diagnostics.ensemble_spread_device``) — a collapsed ensemble
(spread below ``min_rel_spread``) silently degrades Bayesian model
averaging to one model's predictions, and the registry is where that must
be caught, before the stack ever serves.  Stale members keep serving until
a candidate passes.  Two surfaces:

* ``propose(candidate)`` — gate and swap at once (one host round trip);
* ``stage(candidate)`` + ``flip_staged()`` — the overlapped path: ``stage``
  queues the spread reduction and an asynchronous copy of its three
  scalars into pinned host memory, then records a CUDA event on the
  current stream; ``staged_ready`` queries that event, so it never syncs.
  ``flip_staged`` reads the verdict (waiting on the event only when it has
  not completed: a forced flip), makes the current (serving) stream wait
  on the event before anything there reads the candidate, and marks every
  promoted leaf with ``record_stream`` so the caching allocator cannot hand
  its blocks to the side stream while queued decode kernels still read
  them.  On the CPU a staged verdict is always ready.

``ChainRefresher`` drives the background run synchronously through
``ChainExecutor.stream``: each ``refresh()`` advances the sampler one
chunk and proposes the live chain stack.  Bound to an engine (``bind``),
it amortizes that chunk over ``pump(step)`` calls, one micro-chunk at a
time, on the serving thread and stream.  The overlapped variant (side
CUDA stream, lazy gate, deferred flips) is
``repro_torch.serve.engine.refresh.RefreshScheduler``.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from repro_torch.diagnostics import ensemble_spread_device
from repro_torch.models.common import tree_leaves
from repro_torch.obs import trace as obs_trace
from repro_torch.run import ChainExecutor


def _micro_split(chunk_steps: int, refresh_every: int) -> int:
    """Largest divisor of ``chunk_steps`` not exceeding
    ``ceil(chunk_steps / refresh_every)`` — the micro-chunk size that spreads
    one chunk over a ``refresh_every``-tick cadence window while keeping
    chunk boundaries (and hence proposal steps) exactly where they were."""
    micro = max(1, -(-chunk_steps // max(refresh_every, 1)))
    while chunk_steps % micro:
        micro -= 1
    return micro


def _targets_only(grad_fn):
    """``grad_fn(targets)`` as the executor's ``grad_fn(targets, batch)``.
    It closes over ``grad_fn`` alone: a closure over the refresher would be
    a reference cycle (refresher -> stream -> executor -> closure) that
    keeps the chain carry on the card until the cycle collector runs."""
    return lambda targets, _batch: grad_fn(targets)


class SnapshotRegistry:
    """Holds the currently-serving (K, ...)-stacked ensemble; ``propose``
    swaps it iff the candidate passes the spread gate, and the
    ``stage``/``flip_staged`` pair does the same with the verdict's host
    fetch deferred."""

    def __init__(self, members, *, min_rel_spread: float = 1e-6, validate: bool = False):
        self.min_rel_spread = float(min_rel_spread)
        self.members = members
        self.num_members = int(tree_leaves(members)[0].shape[0])
        self.version = 0
        self.promoted = 0
        self.rejected = 0
        self.staged_total = 0
        self.last_health: dict | None = None
        self._staged: tuple[Any, dict, Any] | None = None
        if validate:
            health = self._fetch_health(ensemble_spread_device(members))
            self.last_health = health
            if health["collapsed"]:
                raise ValueError(
                    f"initial ensemble is collapsed (rel_spread={health['rel_spread']:.3e})"
                )

    # -- gate ---------------------------------------------------------------

    def health_device(self, candidate) -> dict:
        """The spread reduction of ``candidate`` as 0-d tensors on its
        device, queued on the current stream (no host sync)."""
        return ensemble_spread_device(candidate)

    def _fetch_health(self, health_dev: dict) -> dict:
        health = {k: float(v) for k, v in health_dev.items()}
        health["num_chains"] = self.num_members
        health["collapsed"] = bool(health["rel_spread"] < self.min_rel_spread)
        return health

    def _check_k(self, candidate) -> None:
        k = int(tree_leaves(candidate)[0].shape[0])
        if k != self.num_members:
            raise ValueError(f"candidate has K={k}, registry serves K={self.num_members}")

    # -- synchronous promotion ----------------------------------------------

    def propose(self, candidate) -> bool:
        """Gate + swap.  Returns True iff ``candidate`` was promoted; on
        rejection the previous members keep serving unchanged."""
        self.stage(candidate)
        with obs_trace.get().span("refresh.flip", cat="refresh", sync=True):
            return self.flip_staged()

    # -- overlapped promotion (stage now, flip later) ------------------------

    @property
    def staged(self):
        """The parked (candidate, health, ready event) triple, or None."""
        return self._staged

    def stage(self, candidate, health=None) -> None:
        """Park ``candidate`` and queue its spread verdict on the current
        stream; replaces any previously staged candidate.  On CUDA the three
        scalars are copied asynchronously into pinned host memory and an
        event is recorded after the copy.  Nothing here waits on the
        device."""
        self._check_k(candidate)
        if health is None:
            health = self.health_device(candidate)
        ready = None
        dev = next(iter(health.values())).device
        if dev.type == "cuda":
            names = list(health)
            host = torch.empty(len(names), dtype=torch.float32, pin_memory=True)
            host.copy_(torch.stack([health[n].float() for n in names]), non_blocking=True)
            health = dict(zip(names, host.unbind()))
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        self._staged = (candidate, health, ready)
        self.staged_total += 1
        obs_trace.get().instant("refresh.stage", cat="refresh", staged=self.staged_total)

    def staged_ready(self) -> bool:
        """True iff a candidate is staged and its verdict has been computed,
        i.e. a flip would not block the host on the device."""
        if self._staged is None:
            return False
        ready = self._staged[2]
        return ready is None or ready.query()

    def staged_passes(self, wait: bool = False) -> bool | None:
        """The staged candidate's verdict (True: it passes the spread gate)
        once its event has completed, else None; ``wait`` waits for the
        event first.  None with nothing staged."""
        if self._staged is None:
            return None
        _, health, ready = self._staged
        if ready is not None:
            if wait:
                ready.synchronize()
            elif not ready.query():
                return None
        return not self._fetch_health(health)["collapsed"]

    def flip_staged(self, place=None, passing: bool | None = None) -> bool:
        """Read the staged verdict (blocking on its event only if it has not
        completed) and promote or reject.  Promotion rebinds ``members``:
        the current stream first waits on the candidate's event and every
        leaf is marked as used by it.  ``place`` (optional) maps the
        candidate into its serving placement at promotion time.
        ``passing`` (optional) overrides the verdict: the one the ranks of a
        mesh agreed on."""
        if self._staged is None:
            return False
        candidate, health_dev, ready = self._staged
        self._staged = None
        if ready is not None:
            ready.synchronize()  # returns at once when staged_ready()
        health = self._fetch_health(health_dev)
        if passing is not None:
            health["collapsed"] = not passing
        self.last_health = health
        if health["collapsed"]:
            self.rejected += 1
            return False
        leaves = tree_leaves(candidate)
        if ready is not None:
            serving = torch.cuda.current_stream(leaves[0].device)
            serving.wait_event(ready)
            for leaf in leaves:
                leaf.record_stream(serving)
        self.members = candidate if place is None else place(candidate)
        self.version += 1
        self.promoted += 1
        return True

    def stats(self) -> dict:
        return {
            "version": self.version,
            "promoted": self.promoted,
            "rejected": self.rejected,
            "staged_total": self.staged_total,
            "staged_pending": self._staged is not None,
            "num_members": self.num_members,
            "last_health": self.last_health,
        }


class ChainRefresher:
    """Cooperative background sampler feeding a :class:`SnapshotRegistry`.

    ``params`` must be the (K, ...)-stacked chain state of a chain-parallel
    sampler whose live stack IS the candidate ensemble; it is consumed (the
    sampler advances it in place).  Each ``refresh()`` advances exactly one
    executor chunk (``chunk_steps`` sampler steps) and proposes a copy of
    the resulting stack; after ``total_steps`` the run is exhausted and
    ``refresh()`` returns False forever.  ``members_of`` maps the raw chain
    stack to the served parameter stack (default: identity).

    Bound to a :class:`ServeEngine` (``bind``; the engine does this at
    construction), the engine pumps it EVERY decode tick and the chunk is
    advanced in micro-chunks of ``chunk_steps / refresh_every`` sampler
    steps — bit-identical dynamics, same proposal cadence, but the cost is
    spread evenly across ticks.  Everything runs on the caller's thread and
    current stream: every proposal waits for the sampler."""

    def __init__(
        self,
        registry: SnapshotRegistry,
        sampler,
        grad_fn,
        params,
        *,
        key,
        state=None,
        chunk_steps: int = 64,
        total_steps: int = 1 << 30,
        members_of=None,
    ):
        self.registry = registry
        self.members_of = members_of or (lambda p: p)
        self._sampler = sampler
        self._grad_fn = grad_fn
        self._params = params
        self._state = sampler.init(params) if state is None else state
        self._key = key
        self._total_steps = int(total_steps)
        self._stream = None
        self.chunk_steps = int(chunk_steps)
        self.micro_steps = int(chunk_steps)  # bind() shrinks this
        self._credit = 0.0
        self._rate = 1.0  # micro-chunks accrued per pump; bind() sets
        self.steps_done = 0
        self.refreshes = 0
        self.micro_chunks = 0
        self.refresh_wall_s = 0.0
        self.exhausted = False

    # -- engine binding ------------------------------------------------------

    def bind(self, engine) -> None:
        """Called by ``ServeEngine.__init__``: amortize each chunk over the
        engine's ``refresh_every``-tick cadence window."""
        cadence = max(int(getattr(engine, "refresh_every", 0)), 1)
        if self._stream is None:  # already-started streams keep their chunking
            self.micro_steps = _micro_split(self.chunk_steps, cadence)
        self._rate = (self.chunk_steps // self.micro_steps) / cadence

    def _ensure_stream(self):
        if self._stream is None:
            ex = ChainExecutor(
                sampler=self._sampler,
                grad_fn=_targets_only(self._grad_fn),
                chunk_steps=self.micro_steps,
                key_mode="fold",
            )
            self._stream = ex.stream(
                self._params,
                self._state,
                num_steps=self._total_steps,
                key=self._key,
                snapshot_every=self.chunk_steps // self.micro_steps,
            )
            self._params = self._state = None  # consumed by the stream
        return self._stream

    # -- advancement ---------------------------------------------------------

    def _advance_micro(self) -> tuple[bool, bool]:
        """Advance one micro-chunk; returns (hit a proposal boundary,
        promoted)."""
        t0 = time.perf_counter()
        with obs_trace.get().span("refresh.micro_chunk", cat="refresh",
                                  from_step=self.steps_done, sync=True):
            try:
                snap = next(self._ensure_stream())
            except StopIteration:
                self.exhausted = True
                return False, False
        self.micro_chunks += 1
        self.steps_done = snap.step
        promoted = False
        boundary = snap.params is not None
        if boundary:
            self.refreshes += 1
            promoted = self.registry.propose(self.members_of(snap.params))
        self.refresh_wall_s += time.perf_counter() - t0
        return boundary, promoted

    def refresh(self) -> bool:
        """Advance one full chunk, propose the live stack.  Returns True iff
        a new snapshot was promoted."""
        while not self.exhausted:
            boundary, promoted = self._advance_micro()
            if boundary:
                return promoted
        return False

    def pump(self, step: int) -> bool:
        """Amortized advancement: accrue ``rate`` micro-chunks of credit and
        run whole ones; proposals still land exactly at chunk boundaries.
        Returns True iff a promotion happened this call."""
        del step  # pacing is credit-based, robust to per-run step resets
        if self.exhausted:
            return False
        self._credit += self._rate
        promoted = False
        while self._credit >= 1.0 and not self.exhausted:
            self._credit -= 1.0
            _, p = self._advance_micro()
            promoted |= p
        return promoted

    def stats(self) -> dict:
        return {
            "refreshes": self.refreshes,
            "micro_chunks": self.micro_chunks,
            "micro_steps": self.micro_steps,
            "steps_done": self.steps_done,
            "refresh_wall_s": round(self.refresh_wall_s, 4),
            "decode_steps_stalled": self.micro_chunks,  # every micro-chunk rides the decode thread
            "exhausted": self.exhausted,
        }
