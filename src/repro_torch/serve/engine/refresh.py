"""Overlapped snapshot refresh: the background sampler runs on a side CUDA
stream and decode never waits for it, except at a forced flip.

``ChainRefresher`` (registry.py) runs each micro-chunk on the serving
stream and fetches every verdict at once, so the decode tick pays for the
sampler.  Elastic coupling absorbs a stale or perturbed center into the
center-noise covariance of Eq. 6, so the sampler and the decode stream
need no ordering between promotions: they only have to agree at the flip.
``RefreshScheduler`` uses that with four mechanisms:

1. **Micro-chunks on a side stream, with backpressure.**  The background
   ``ChainExecutor.stream`` chunk is split into micro-chunks paced against
   decode ticks (``chunk_steps / refresh_every`` sampler steps per tick,
   credit-paced).  Each micro-chunk, its boundary copy and the gate
   reduction are launched under ``torch.cuda.stream(side)``; the launches
   return at once, so the pump never waits for the sampler.  A micro-chunk
   is launched only when the previous one's probe (a CUDA event,
   ``event.query()``) says it has retired; unspent credit banks, capped at
   two chunks, so a slow sampler backs up on its own stream, never in the
   launch queue.  With ``key_mode='fold'`` the split is bit-identical to
   the unsplit chunk.
2. **Lazy gate.**  At a chunk boundary the candidate's spread verdict is
   queued on the side stream and staged with its event
   (``SnapshotRegistry.stage``); it is read at the flip, and only once the
   event has completed (``flips_deferred`` counts the ticks it had not).
3. **Pointer-flip promotion.**  The flip makes the serving stream wait on
   the candidate's event, marks its leaves as used by the serving stream
   (``record_stream``), places it through ``ServeEngine._place_members``
   and rebinds the registry's members.  A forced flip (too many deferrals,
   or the last candidate after exhaustion) waits on the host and is
   counted in ``decode_steps_stalled`` / ``stall_wall_s``.
4. **A spare device.**  With more than one card, ``device="auto"`` moves
   the background run's carry to the last card, so the sampler runs off
   the serving card entirely; on one card it shares the card through the
   side stream.  Under an engine mesh the spare card is the last local
   card that no rank of the mesh serves on, else none.

Under a mesh each rank binds its own scheduler over the full K-chain
carry (the reference's one scheduler, replicated) and the engine keeps
the rank's block of each promoted stack.  Readiness is per rank: an
event's ``query`` answers differently on two ranks, which could then
promote at different ticks and serve different members.  So a pump with
something to decide (a staged candidate, or credit for a micro-chunk)
agrees on (verdict ready, verdict passing, side stream idle) by ONE
MIN all-reduce of three int32 flags over every rank, on a gloo group
(host values, no wait on a device stream), and launches at most one
micro-chunk; a forced flip agrees on the verdict by one more.  Every rank
then flips, defers and launches at the same ticks.

The port's carry is written in place, where the reference's is immutable,
so the stream copies the chain stack at every proposal boundary; the
candidate it stages is that copy, never the live stack.

``bind`` prepares the run before any request is in flight.  Eager PyTorch
has nothing to compile and a copy of a full-width carry would cost tens of
GB, so it loads the kernel library the sampler may launch (the fused
Eq. 6 update), runs the gate reduction once on the live params (read
only), and touches the pinned host buffer the verdicts land in.  It
advances no step and stages nothing.
"""
from __future__ import annotations

import contextlib
import time
import weakref

import torch

from repro_torch.distributed import collectives
from repro_torch.models.common import tree_leaves
from repro_torch.obs import trace as obs_trace
from repro_torch.run import ChainExecutor

from .registry import SnapshotRegistry, _micro_split, _targets_only


def _tensors(tree):
    """The tensors of a tree of dicts, tuples and NamedTuples (params, or a
    sampler state whose ``step`` is a host int)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tensors(v)


def _move(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _move(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_move(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _spare_device(used, count: int) -> int | None:
    """The last of ``count`` local CUDA device indices not in ``used``, or
    None when every one is used."""
    used = set(used)
    spare = [i for i in range(count) if i not in used]
    return spare[-1] if spare else None


def _pick_device(engine, request):
    """Placement policy for the background run.  ``request``: a device,
    ``None`` (leave the carry where it is), or ``"auto"``: under an engine
    mesh, the last local CUDA device that no rank of the mesh serves on
    (the ranks' devices gathered on the host), else None; without a mesh,
    with more than one CUDA device, the last one; otherwise None."""
    if request != "auto":
        return None if request is None else torch.device(request)
    dev = getattr(engine, "device", None)
    kind = dev.type if dev is not None else ("cuda" if torch.cuda.is_available() else "cpu")
    if kind != "cuda":
        return None
    n = torch.cuda.device_count()
    host = getattr(engine, "host", None)
    if host is not None:
        mine = torch.tensor([torch.cuda.current_device() if dev.index is None else dev.index])
        spare = _spare_device(collectives.all_gather(mine, host).flatten().tolist(), n)
        return None if spare is None else torch.device("cuda", spare)
    return torch.device("cuda", n - 1) if n > 1 else None


class RefreshScheduler:
    """Overlapped drop-in for :class:`~.registry.ChainRefresher`.

    Same constructor surface (registry, sampler, grad_fn, stacked params,
    fold key) plus placement/pacing knobs; the engine binds it at
    construction and calls ``pump(step)`` every decode tick.  A pump does
    at most three things, none of which waits on the device: flip a staged
    candidate whose verdict is ready, accrue micro-chunk credit, and launch
    whole credits' worth of micro-chunks on the side stream (staging a
    candidate at each chunk boundary).  The only way the host ever waits on
    the sampler is a *forced* flip (``max_flip_deferrals`` exceeded, or
    draining the last candidate after exhaustion).
    """

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
        micro_steps: int | None = None,
        total_steps: int = 1 << 30,
        members_of=None,
        device="auto",
        max_flip_deferrals: int | None = None,
        sync_every: int | None = None,
    ):
        self.registry = registry
        self.members_of = members_of or (lambda p: p)
        self._sampler = sampler
        self._grad_fn = grad_fn
        self._params = params
        self._state = sampler.init(params) if state is None else state
        self._key = key
        self._total_steps = int(total_steps)
        self.chunk_steps = int(chunk_steps)
        self._explicit_micro = micro_steps is not None
        self.micro_steps = int(micro_steps) if micro_steps else self.chunk_steps
        if self.chunk_steps % self.micro_steps:
            raise ValueError("micro_steps must divide chunk_steps")
        self._device_req = device
        self.device = None
        self._max_flip_deferrals = max_flip_deferrals
        # the sampler's sync cadence (EC s): `sampler.sync_collective` trace
        # instants are reconstructed from it at micro-chunk launch
        self.sync_every = int(sync_every) if sync_every else None
        self._engine = None  # a weak reference: the engine holds the scheduler
        self._host = None  # every rank of the engine's mesh (agreement), or None
        self._side = None  # the side stream; None on the CPU
        self._stream = None
        self._credit = 0.0
        self._rate = 1.0  # micro-chunks per pump; bind() paces to the cadence
        self._deferrals = 0
        self._probe = None  # last micro's ChunkSnapshot.probe (readiness gate)
        self._cycle_t0: float | None = None
        self.steps_done = 0
        self.micro_chunks = 0
        self.backpressure_ticks = 0
        self.proposals = 0
        self.refreshes = 0  # flips resolved (promoted or rejected)
        self.promotions = 0
        self.flips_deferred = 0
        self.decode_steps_stalled = 0
        self.stall_wall_s = 0.0
        self.pump_wall_s = 0.0
        self.refresh_walls: list[float] = []
        self.exhausted = False

    # -- engine binding / preparation ------------------------------------------

    def bind(self, engine) -> None:
        """Attach to a ``ServeEngine``: pace micro-chunks to its
        ``refresh_every`` cadence, move the background carry to a spare
        device when there is one, make the side stream and prepare the run
        (see the module docstring).  Advances no step."""
        if self._stream is not None:
            raise RuntimeError("bind() must precede the first pump/refresh")
        self._engine = weakref.ref(engine)
        self._host = getattr(engine, "host", None)
        cadence = max(int(getattr(engine, "refresh_every", 0)), 1)
        if not self._explicit_micro:
            self.micro_steps = _micro_split(self.chunk_steps, cadence)
        self._rate = (self.chunk_steps // self.micro_steps) / cadence
        self.device = _pick_device(engine, self._device_req)
        if self.device is not None:
            self._params = _move(self._params, self.device)
            self._state = _move(self._state, self.device)
        self._prepare()

    def _carry_device(self):
        return tree_leaves(self._params)[0].device

    def _prepare(self) -> None:
        dev = self._carry_device()
        if dev.type == "cuda":
            from repro_torch.kernels import _build

            _build.library("fused_ecsghmc")
            self._side = torch.cuda.Stream(device=dev)
            # the carry was written on the caller's stream; from now on the
            # side stream writes it, and frees of its blocks wait for it
            self._side.wait_stream(torch.cuda.current_stream(dev))
            for leaf in _tensors((self._params, self._state)):
                leaf.record_stream(self._side)
            torch.empty(4, dtype=torch.float32, pin_memory=True)
        with self._on_side():
            self.registry.health_device(self.members_of(self._params))

    def _on_side(self):
        return torch.cuda.stream(self._side) if self._side is not None else contextlib.nullcontext()

    def _place(self, tree):
        engine = self._engine() if self._engine is not None else None
        return engine._place_members(tree) if engine is not None else tree

    def _ensure_stream(self):
        if self._stream is None:
            if self._side is None and self._carry_device().type == "cuda":
                self._prepare()  # never bound to an engine
            ex = ChainExecutor(
                sampler=self._sampler,
                grad_fn=_targets_only(self._grad_fn),
                chunk_steps=self.micro_steps,
                key_mode="fold",
            )
            # copies at proposal boundaries (copy_snapshots=True): the next
            # micro-chunk writes the live stack in place, which would change a
            # promoted stack under the decode that reads it
            self._stream = ex.stream(
                self._params,
                self._state,
                num_steps=self._total_steps,
                key=self._key,
                snapshot_every=self.chunk_steps // self.micro_steps,
                copy_snapshots=True,
            )
            self._params = self._state = None  # consumed by the stream
        return self._stream

    # -- overlapped advancement ----------------------------------------------

    def _dispatch_micro(self) -> None:
        """Launch one micro-chunk on the side stream; at a chunk boundary,
        stage the copied candidate with its queued verdict.  Nothing here
        waits on the device."""
        if self._cycle_t0 is None:
            self._cycle_t0 = time.perf_counter()
        tr = obs_trace.get()
        prev_step = self.steps_done
        stream = self._ensure_stream()
        with self._on_side(), tr.span("refresh.micro_chunk", cat="refresh", from_step=prev_step):
            try:
                snap = next(stream)
            except StopIteration:
                self.exhausted = True
                return
            if snap.params is not None:
                self.registry.stage(self.members_of(snap.params))
                self.proposals += 1
        self.micro_chunks += 1
        self.steps_done = snap.step
        self._probe = snap.probe
        if tr.enabled and self.sync_every:
            # reconstructed, not observed: every sync boundary the launched
            # micro covered, at known step indices
            s = self.sync_every
            first = (prev_step // s + 1) * s  # next multiple of s after prev
            for step in range(first, snap.step + 1, s):
                tr.instant("sampler.sync_collective", cat="sampler", step=step)

    def _sampler_idle(self) -> bool:
        """True when the last launched micro-chunk has retired (its probe
        event has completed): keeps the side stream's queue at one
        micro-chunk, so a slow sampler cannot pile up work."""
        return self._probe is None or self._probe.query()

    def _agree(self, credit: float):
        """Under a mesh, with a staged candidate or ``credit`` for a
        micro-chunk: (verdict ready, verdict passing, side stream idle) as
        every rank agrees, by one MIN all-reduce; otherwise None."""
        if self._host is None:
            return None
        if self.registry.staged is None and (self.exhausted or credit < 1.0):
            return None
        passes = self.registry.staged_passes()
        flags = torch.tensor([passes is not None, bool(passes), self._sampler_idle()],
                             dtype=torch.int32)
        collectives.all_reduce_min(flags, self._host)
        return tuple(bool(f) for f in flags.tolist())

    def _agree_passing(self) -> bool:
        """The staged verdict every rank of the mesh agrees on, each rank
        waiting for its own first (a forced flip)."""
        flag = torch.tensor([int(bool(self.registry.staged_passes(wait=True)))],
                            dtype=torch.int32)
        return bool(collectives.all_reduce_min(flag, self._host).item())

    def _maybe_flip(self, *, force: bool, agreed=None) -> bool:
        """Resolve the staged candidate if its verdict is ready (or we are
        forced to wait for it); returns True iff promoted.  ``agreed``: the
        mesh's (ready, passing, idle) flags from ``_agree``."""
        if self.registry.staged is None:
            return False
        ready = self.registry.staged_ready() if agreed is None else agreed[0]
        may_defer = self._max_flip_deferrals is None or self._deferrals < self._max_flip_deferrals
        if not ready and not force and may_defer:
            self._deferrals += 1
            self.flips_deferred += 1
            obs_trace.get().instant(
                "refresh.flip_deferred", cat="refresh", deferrals=self._deferrals
            )
            return False
        t0 = time.perf_counter()
        # waits on the host only when not ready (the forced flip)
        with obs_trace.get().span("refresh.flip", cat="refresh",
                                  forced=force, verdict_ready=ready):
            passing = None
            if self._host is not None:  # every rank promotes or rejects alike
                passing = agreed[1] if agreed is not None and ready else self._agree_passing()
            promoted = self.registry.flip_staged(place=self._place, passing=passing)
        if not ready:
            self.stall_wall_s += time.perf_counter() - t0
            self.decode_steps_stalled += 1
        self._deferrals = 0
        self.refreshes += 1
        if self._cycle_t0 is not None:
            self.refresh_walls.append(time.perf_counter() - self._cycle_t0)
            self._cycle_t0 = None
        if promoted:
            self.promotions += 1
            engine = self._engine() if self._engine is not None else None
            if engine is not None:
                # placed at the flip: _members() must not place it again
                engine.mark_members_placed()
        return promoted

    def pump(self, step: int) -> bool:
        """One decode tick's worth of refresh work.  Returns True iff a
        promotion flipped in this call."""
        del step  # pacing is credit-based, robust to per-run step resets
        t0 = time.perf_counter()
        credit = self._credit
        if not self.exhausted:
            micros_per_chunk = self.chunk_steps // self.micro_steps
            credit = min(credit + self._rate, 2.0 * micros_per_chunk)
        agreed = self._agree(credit)
        promoted = self._maybe_flip(force=False, agreed=agreed)
        if not self.exhausted:
            self._credit = credit
            idle = self._sampler_idle() if agreed is None else agreed[2]
            if self._credit >= 1.0 and not idle:
                self.backpressure_ticks += 1
                obs_trace.get().instant(
                    "refresh.backpressure", cat="refresh", credit=self._credit
                )
            while self._credit >= 1.0 and not self.exhausted and idle:
                self._credit -= 1.0
                self._dispatch_micro()
                # under a mesh the agreed flag covers one launch
                idle = agreed is None and self._sampler_idle()
        if self.exhausted and self.registry.staged is not None:
            # nothing further will be staged — don't strand the last candidate
            promoted = self._maybe_flip(force=True) or promoted
        self.pump_wall_s += time.perf_counter() - t0
        return promoted

    def refresh(self) -> bool:
        """Synchronous parity surface (``ChainRefresher`` semantics):
        advance to the next proposal boundary and resolve it, waiting for
        the verdict.  Returns True iff promoted; False once exhausted."""
        while not self.exhausted and self.registry.staged is None:
            self._dispatch_micro()
        return self._maybe_flip(force=True)

    def stats(self) -> dict:
        walls = self.refresh_walls
        return {
            "refreshes": self.refreshes,
            "proposals": self.proposals,
            "promotions": self.promotions,
            "rejections": self.refreshes - self.promotions,
            "micro_chunks": self.micro_chunks,
            "micro_steps": self.micro_steps,
            "steps_done": self.steps_done,
            "backpressure_ticks": self.backpressure_ticks,
            "flips_deferred": self.flips_deferred,
            "decode_steps_stalled": self.decode_steps_stalled,
            "stall_wall_s": round(self.stall_wall_s, 4),
            "pump_wall_s": round(self.pump_wall_s, 4),
            "refresh_wall_s": round(sum(walls), 4),
            "per_refresh_wall_s": round(sum(walls) / len(walls), 4) if walls else 0.0,
            "device": str(self.device) if self.device is not None else None,
            "exhausted": self.exhausted,
        }
