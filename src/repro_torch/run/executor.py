"""Chain executor of the port: whole sampling runs in chunks of steps.

The reference compiles each chunk as one donated ``lax.scan`` program; the
port runs the same step loop in plain Python, eagerly, and keeps its
contract:

* the step is ``Sampler.{grad_targets, update}`` (gradients evaluated
  where ``grad_targets`` points) or a raw ``step_fn``;
* streaming diagnostics ride the carry: Welford moments
  (``diagnostics.moments``) and batch-means ESS (``diagnostics.streaming``)
  accumulate on the device with no host sync;
* traces are THINNED: every ``thin``-th state is kept (copied, since the
  step updates params in place);
* the host callback ``on_chunk`` runs only at CHUNK boundaries, which is
  where ``train/loop.py`` logs and stops; chunking is invisible to the
  dynamics;
* the adaptation configuration: a ``sampler_factory(hyper)`` builds the
  sampler from an UNSWEPT ``hyper`` dict once per chunk, and
  ``adapt_fn(step_end, carry, hyper)`` may replace ``hyper`` at each chunk
  boundary (``ess_feedback_adapter`` closes the FeedbackESS loop there);
* a SWEEP axis (``sweep=True``, or a ``hyper`` dict of length-S tensors):
  params, state and keys carry a leading axis of S independent runs (seeds,
  or a hyperparameter grid that ``sampler_factory`` builds one sampler per
  run from).  The reference vmaps the runs into one program; the port runs
  them one after another within each chunk, over per-run views of the
  stacked tensors, so the in-place updates land in the stack and a swept
  run equals its per-member runs bit for bit.

Key modes (``key_mode``), as in the reference, over ``core.rng`` keys:

* ``"keys"``  — the caller passes one key per step;
* ``"fold"``  — the step's key is ``fold_in(base_key, absolute_step)``
  (resume-safe: the noise depends on the absolute step, not the chunking);
* ``"carry"`` — a key rides the carry and is split once per step.

The carry is CONSUMED: samplers and ``apply_updates`` update tensors in
place, so the params and state passed to ``run`` or ``stream`` are the
ones advanced.  ``stream`` is the chunk-boundary snapshot hook of the
serving refresher: because the carry is written in place, its snapshots
are copies (the reference may hand out its immutable carry itself), and
its readiness probe is a CUDA event, not a device scalar.
Not ported yet (``NotImplementedError``): ``run_sharded``/``lower_sharded``
(multi-GPU).  Capturing a chunk as a CUDA graph is later performance work.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import rng as rnglib
from repro_torch.core.tree_util import apply_updates, tree_leaves, tree_map
from repro_torch.obs import trace as obs_trace
from repro_torch.diagnostics import (
    BatchMeansState,
    MomentState,
    batch_ess_add,
    batch_ess_estimate,
    batch_ess_init,
    welford_add,
    welford_init,
)


class ChunkSnapshot(NamedTuple):
    """One chunk-boundary observation from ``ChainExecutor.stream``:
    ``step`` is the absolute step index at the boundary; ``params``/``state``
    are copies (or None between proposal boundaries), since the live carry
    is updated in place by the next chunk.  ``probe`` is a ``torch.cuda.Event``
    recorded on the current stream after the chunk's last launch (its
    boundary copies included): ``probe.query()`` answers "has this chunk
    retired?" without a host sync.  None on the CPU, where a chunk has
    retired when ``next()`` returns."""

    step: int
    params: Any
    state: Any
    outs: Any
    probe: Any = None


class RunResult(NamedTuple):
    """Everything a caller can ask the executor for.  ``trace``/``stats``
    are time-major stacked tensors; ``moments``/``ess`` are the in-carry
    accumulators in their final state."""

    params: Any
    state: Any
    trace: Any  # (T', ...) tree or None
    stats: Any  # (T',) per key, or None
    metrics: Any  # metrics dict of the final executed step ({} if none)
    moments: Optional[MomentState]
    ess: Optional[BatchMeansState]
    steps: int
    wall_s: float

    @property
    def steps_per_s(self) -> float:
        return self.steps / max(self.wall_s, 1e-12)


def _stack(items):
    """A list of trees (or dicts of scalars) -> one tree of stacked tensors."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *items)


def _empty(tree) -> bool:
    return isinstance(tree, dict) and not tree


def _sync(tree) -> None:
    """Wait for the device work on a tree's tensors (CUDA launches return
    before they finish), so a run's wall time measures the work."""
    dev = {x.device for x in tree_leaves(tree)}
    for d in dev:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _map_tensors(fn, tree):
    """``fn`` on every tensor of a tree of dicts, tuples and NamedTuples (a
    sampler state); other leaves (host ints, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map_tensors(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _copy(tree):
    """A copy of every tensor of a tree; host leaves are shared."""
    return _map_tensors(lambda x: x.detach().clone(), tree)


def _probe(tree):
    """An event recorded on the current stream of the tree's CUDA device,
    or None for CPU tensors."""
    leaf = tree_leaves(tree)[0]
    if not (isinstance(leaf, torch.Tensor) and leaf.is_cuda):
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(leaf.device))
    return ev


def _index(tree, i):
    """Run ``i`` of a swept tree: a view ``x[i]`` of every tensor."""
    return _map_tensors(lambda x: x[i], tree)


def _put(stacked, new, i):
    """Write run ``i``'s tree ``new`` into the swept tree ``stacked``: a
    tensor that is not already the view ``stacked[i]`` is copied into it;
    host leaves are taken from ``new``.  Returns the swept tree."""
    if isinstance(stacked, torch.Tensor):
        view = stacked[i]
        if new.data_ptr() != view.data_ptr() or new.shape != view.shape:
            view.copy_(new)
        return stacked
    if isinstance(stacked, dict):
        return {k: _put(stacked[k], new[k], i) for k in stacked}
    if isinstance(stacked, tuple):
        items = [_put(a, b, i) for a, b in zip(stacked, new)]
        return type(stacked)(*items) if hasattr(stacked, "_fields") else tuple(items)
    return new


def stack_runs(items):
    """Per-run trees -> one swept tree: tensors stacked on a new leading
    axis, host leaves that every run shares kept as they are (a sampler's
    step), others made a tensor.  A swept run's state is
    ``stack_runs([sampler.init(p) for p in per_run_params])`` (the
    reference's ``jax.vmap(sampler.init)``)."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: stack_runs([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        fields = [stack_runs(list(xs)) for xs in zip(*items)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    if all(it == first for it in items):
        return first
    return torch.as_tensor(items)


def _sequence(x) -> bool:
    return isinstance(x, (list, tuple, np.ndarray, torch.Tensor)) and np.ndim(x) >= 1


class _Sweep:
    """The S runs of a swept ``run``: checks that every tensor of params and
    state, the keys and the hyper values carry a leading axis of S, and
    hands out each run's key, keys and hyper (host scalars)."""

    def __init__(self, params, state, key, keys, hyper, key_mode):
        leaves = [x for x in tree_leaves(params) if isinstance(x, torch.Tensor)]
        if not leaves or leaves[0].ndim < 1:
            raise ValueError("a swept run needs params with a leading sweep axis")
        self.size = S = int(leaves[0].shape[0])
        for name, tree in (("params", params), ("state", state)):
            shapes = []
            _map_tensors(lambda x: shapes.append(tuple(x.shape)), tree)
            for shape in shapes:
                if not shape or shape[0] != S:
                    raise ValueError(f"every tensor of the swept {name} needs a leading axis of "
                                     f"size {S}, got shape {shape}")
        if key_mode == "keys" and len(keys) != S:
            raise ValueError(f"swept keys need one sequence per run: {len(keys)} for {S} runs")
        self.stacked_key = _sequence(key)
        if key_mode == "carry" and not self.stacked_key:
            raise ValueError("a swept carry-mode run needs one key per run")
        if self.stacked_key and len(key) != S:
            raise ValueError(f"swept keys need one per run: {len(key)} for {S} runs")
        for v in tree_leaves(hyper) if hyper else ():
            if np.ndim(v) < 1 or len(v) != S:
                raise ValueError(f"every swept hyper value needs length {S}")
        self._key, self._keys = key, keys

    def key(self, i):
        return int(self._key[i]) if self.stacked_key else self._key

    def keys(self, i):
        return None if self._keys is None else self._keys[i]

    @staticmethod
    def hyper(hyper, i):
        if hyper is None:
            return None
        at = lambda v: v[i].detach().cpu().numpy()[()] if isinstance(v, torch.Tensor) else v[i]
        return tree_map(at, hyper)


class ChainExecutor:
    """Runs sampling in chunks of at most ``chunk_steps`` steps.

    Exactly one of ``step_fn`` / ``sampler`` / ``sampler_factory`` drives
    the dynamics:

    * ``step_fn(params, state, batch, rng) -> (params, state, metrics)``;
    * ``sampler`` + ``grad_fn(targets, batch) -> grads | (grads, metrics)``;
    * ``sampler_factory(hyper) -> Sampler`` + ``grad_fn``: as above, the
      sampler built from ``run``'s ``hyper`` at the start of every chunk.

    ``batch_fn(step)`` gives each step's batch (``moments`` accumulates
    the params themselves).  With ``trace_fn``, ``chunk_steps`` and ``num_steps``
    must be multiples of ``thin``, and a trace point (plus ``stats`` and
    the step's metrics) is kept every ``thin`` steps; without it they are
    kept once per chunk (the final step's).
    """

    def __init__(
        self,
        *,
        step_fn: Callable | None = None,
        sampler=None,
        sampler_factory: Callable | None = None,
        grad_fn: Callable | None = None,
        batch_fn: Callable | None = None,
        trace_fn: Callable | None = None,
        thin: int = 1,
        moments: bool = False,
        moments_from: int = 0,
        ess_probe_fn: Callable | None = None,
        ess_batch_len: int = 64,
        collect_stats: bool = False,
        chunk_steps: int = 256,
        key_mode: str = "keys",
    ):
        if sum(x is not None for x in (step_fn, sampler, sampler_factory)) != 1:
            raise ValueError("exactly one of step_fn / sampler / sampler_factory")
        if step_fn is None and grad_fn is None:
            raise ValueError("sampler mode needs grad_fn")
        if key_mode not in ("keys", "fold", "carry"):
            raise ValueError(f"unknown key_mode {key_mode!r}")
        if thin < 1 or chunk_steps < 1:
            raise ValueError("thin and chunk_steps must be >= 1")
        if trace_fn is not None and chunk_steps % thin != 0:
            raise ValueError("chunk_steps must be a multiple of thin when tracing")
        self.step_fn = step_fn
        self.sampler = sampler
        self.sampler_factory = sampler_factory
        self.grad_fn = grad_fn
        self.batch_fn = batch_fn
        self.trace_fn = trace_fn
        self.thin = int(thin)
        self.moments = moments
        self.moments_from = int(moments_from)
        self.ess_probe_fn = ess_probe_fn
        self.ess_batch_len = int(ess_batch_len)
        self.collect_stats = collect_stats
        self.chunk_steps = int(chunk_steps)
        self.key_mode = key_mode

    def _step(self, hyper):
        """(step, stats_fn) for the chunk's ``hyper``."""
        if self.step_fn is not None:
            return self.step_fn, None
        sampler = self.sampler if self.sampler is not None else self.sampler_factory(hyper)
        grad_fn = self.grad_fn

        def step(params, state, batch, rng):
            targets = sampler.grad_targets(state, params) if sampler.grad_targets else params
            out = grad_fn(targets, batch)
            grads, metrics = out if isinstance(out, tuple) else (out, {})
            updates, new_state = sampler.update(grads, state, params, rng)
            del grads
            return apply_updates(params, updates), new_state, metrics

        return step, sampler.stats

    def run(
        self,
        params,
        state,
        *,
        num_steps: int,
        key=None,
        keys=None,
        start_step: int = 0,
        hyper=None,
        sweep: bool | None = None,
        on_chunk: Callable | None = None,
        adapt_fn: Callable | None = None,
    ) -> RunResult:
        """Advance ``num_steps`` steps from ``(params, state)``.

        ``keys``: a sequence of ``num_steps`` per-step keys (``"keys"``
        mode); ``key``: the base key for ``"fold"``/``"carry"``.
        ``start_step``: absolute index of the first step (resume; drives
        ``fold_in`` and ``batch_fn``).  ``on_chunk(step_end, params, state,
        outs)`` runs at every chunk boundary; returning False stops the run.

        ``hyper``: the dict ``sampler_factory`` builds the sampler from.
        ``sweep`` (default: implied by ``hyper``; pass ``sweep=False`` for
        an UNSWEPT hyper, the adaptation configuration) runs S independent
        runs over the leading axis of every tensor of params and state:
        ``keys`` is then S sequences of ``num_steps`` keys, ``key`` one
        shared base key or a sequence of S keys (``"fold"``; S keys in
        ``"carry"``), and every value of ``hyper`` has length S.  The trace
        and stats are (S, T', ...), the metrics, moments and ESS per run.
        A host ``batch_fn`` cannot be swept (``NotImplementedError``, as in
        the reference).  ``adapt_fn(step_end, carry, hyper) -> hyper |
        None`` runs at every chunk boundary but the last, after
        ``on_chunk``; a non-None return replaces ``hyper`` for the chunks
        after it.  ``carry`` is a dict of the run's state: ``params``,
        ``state``, ``t`` (the absolute step), ``wf`` and ``ess`` (the
        in-carry accumulators, or None).
        """
        sweep = (hyper is not None) if sweep is None else bool(sweep)
        if self.sampler_factory is not None and hyper is None:
            raise ValueError("sampler_factory mode needs hyper=")
        if self.key_mode == "keys" and keys is None:
            raise ValueError("key_mode='keys' needs keys=")
        if self.key_mode in ("fold", "carry") and key is None:
            raise ValueError(f"key_mode={self.key_mode!r} needs key=")
        if self.trace_fn is not None and num_steps % self.thin != 0:
            raise ValueError("num_steps must be a multiple of thin when tracing")
        if sweep:
            if self.batch_fn is not None:
                raise NotImplementedError("host batch_fn + sweep is unsupported")
            runs = _Sweep(params, state, key, keys, hyper, self.key_mode)
            accs = [self._acc(_index(params, i), runs.key(i)) for i in range(runs.size)]
            chunk = lambda p, st, h, **kw: self._swept_chunk(p, st, h, runs=runs, accs=accs, **kw)
            acc_view = lambda: {k: stack_runs([a[k] for a in accs]) for k in ("wf", "ess")}
        else:
            acc = self._acc(params, key)
            chunk = lambda p, st, h, **kw: self._chunk(p, st, h, key=key, keys=keys, acc=acc, **kw)
            acc_view = lambda: acc
        traces, stats, metrics = [], [], {}
        t_run, t_abs = 0, int(start_step)
        t0 = time.perf_counter()
        stopped = False
        while t_run < num_steps and not stopped:
            n = min(self.chunk_steps, num_steps - t_run)
            params, state, metrics, outs = chunk(params, state, hyper, n=n, t_run=t_run,
                                                 t_abs=t_abs)
            t_run += n
            t_abs += n
            if "trace" in outs:
                traces.append(outs["trace"])
            if "stats" in outs:
                stats.append(outs["stats"])
            if on_chunk is not None and on_chunk(t_abs, params, state, outs) is False:
                stopped = True
            if adapt_fn is not None and t_run < num_steps and not stopped:
                accs_now = acc_view()
                carry = {"params": params, "state": state, "t": t_abs, "wf": accs_now["wf"],
                         "ess": accs_now["ess"]}
                new_hyper = adapt_fn(t_abs, carry, hyper)
                if new_hyper is not None:
                    hyper = new_hyper
        _sync(params)
        wall = time.perf_counter() - t0
        axis = 1 if sweep else 0
        cat = lambda ts: tree_map(lambda *xs: torch.cat(xs, dim=axis), *ts)
        final = acc_view()
        return RunResult(
            params=params,
            state=state,
            trace=cat(traces) if traces else None,
            stats=cat(stats) if stats else None,
            metrics=metrics,
            moments=final["wf"],
            ess=final["ess"],
            steps=t_run,
            wall_s=wall,
        )

    def _acc(self, params, key):
        """The in-carry accumulators of one run, and its carried key."""
        acc = {"wf": None, "ess": None, "carry_key": key}
        if self.moments:
            acc["wf"] = welford_init(params)
        if self.ess_probe_fn is not None:
            acc["ess"] = batch_ess_init(self.ess_probe_fn(params), self.ess_batch_len)
        return acc

    def _swept_chunk(self, params, state, hyper, *, runs, accs, n, t_run, t_abs):
        """``_chunk`` for each of the S runs in turn, over views of the
        stacked params and state (a value a sampler returns as a new tensor
        is copied into the stack).  Returns the stacked (params, state,
        per-run metrics, outs with a leading S axis)."""
        results, state_in = [], state  # every run starts from the chunk's host leaves (step)
        for i in range(runs.size):
            p_i, s_i = _index(params, i), _index(state_in, i)
            p_i, s_i, metrics, outs = self._chunk(
                p_i, s_i, runs.hyper(hyper, i), n=n, t_run=t_run, t_abs=t_abs, key=runs.key(i),
                keys=runs.keys(i), acc=accs[i])
            params = _put(params, p_i, i)
            state = _put(state, s_i, i)
            results.append((metrics, outs))
        metrics = stack_runs([m for m, _ in results])
        outs = {k: stack_runs([o[k] for _, o in results]) for k in results[0][1]}
        return params, state, metrics, outs

    def _chunk(self, params, state, hyper, *, n, t_run, t_abs, key, keys, acc):
        """Advance ``n`` steps from absolute step ``t_abs`` (``t_run`` into
        the run); ``acc`` holds the in-carry accumulators and the carried key
        and is updated.  Returns (params, state, last metrics, outs)."""
        step, stats_fn = self._step(hyper)
        every = self.thin if self.trace_fn is not None else n
        outs = {"metrics": []}
        if self.trace_fn is not None:
            outs["trace"] = []
        if self.collect_stats and stats_fn is not None:
            outs["stats"] = []
        metrics = {}
        for i in range(n):
            if self.key_mode == "keys":
                rng = keys[t_run + i]
            elif self.key_mode == "fold":
                rng = rnglib.fold_in(key, t_abs + i)
            else:
                acc["carry_key"], rng = rnglib.split(acc["carry_key"])
            batch = self.batch_fn(t_abs + i) if self.batch_fn is not None else None
            params, state, metrics = step(params, state, batch, rng)
            if t_abs + i >= self.moments_from:
                if acc["wf"] is not None:
                    acc["wf"] = welford_add(acc["wf"], params)
                if acc["ess"] is not None:
                    acc["ess"] = batch_ess_add(acc["ess"], self.ess_probe_fn(params))
            if (i + 1) % every == 0:
                outs["metrics"].append(metrics)
                if "trace" in outs:
                    outs["trace"].append(_copy(self.trace_fn(params)))
                if "stats" in outs:
                    outs["stats"].append(stats_fn(state, params))
        outs = {k: _stack(v) if v and not _empty(v[0]) else {} for k, v in outs.items()}
        return params, state, metrics, outs

    def stream(
        self,
        params,
        state,
        *,
        num_steps: int,
        key=None,
        keys=None,
        start_step: int = 0,
        copy_snapshots: bool = True,
        snapshot_every: int = 1,
    ):
        """Chunk-boundary snapshot hook: a generator that advances the run
        one chunk at a time and yields a :class:`ChunkSnapshot` at every
        boundary, the surface the serving refresher draws members from.

        Nothing is accumulated across chunks: the caller owns each boundary.
        ``snapshot_every=k`` is the micro-chunk hook: every boundary yields,
        but params/state are copied only at every k-th boundary and at the
        final one (the proposal boundaries); the yields between carry
        ``params=state=None``.  With ``key_mode='fold'`` splitting a chunk
        into micro-chunks is bit-identical to the unsplit run.

        ``copy_snapshots=False`` yields the live carry itself.  The next
        chunk then writes the yielded tensors in place, so such a snapshot
        is valid only until ``next()`` is called again.

        Nothing here syncs the host: every launch, copy and the probe's
        event are queued on the current stream, so a caller may drive the
        generator under a side ``torch.cuda.stream``."""
        if self.key_mode == "keys" and keys is None:
            raise ValueError("key_mode='keys' needs keys=")
        if self.key_mode in ("fold", "carry") and key is None:
            raise ValueError(f"key_mode={self.key_mode!r} needs key=")
        if self.trace_fn is not None and num_steps % self.thin != 0:
            raise ValueError("num_steps must be a multiple of thin when tracing")
        if self.sampler_factory is not None:
            raise ValueError("stream does not support sampler_factory mode")
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        copy = _copy if copy_snapshots else (lambda tr: tr)
        acc = {"wf": None, "ess": None, "carry_key": key}
        t_run, t_abs, boundary = 0, int(start_step), 0
        while t_run < num_steps:
            n = min(self.chunk_steps, num_steps - t_run)
            with obs_trace.get().span("executor.chunk", cat="executor", step=t_abs, n=n,
                                      stream=True):
                params, state, _, outs = self._chunk(
                    params, state, None, n=n, t_run=t_run, t_abs=t_abs, key=key, keys=keys,
                    acc=acc)
            t_run += n
            t_abs += n
            boundary += 1
            # built in the yield: a copy held in a local of this frame would
            # stay alive through the next chunk, after the caller dropped it
            if boundary % snapshot_every == 0 or t_run >= num_steps:
                yield ChunkSnapshot(t_abs, copy(params), copy(state), outs, _probe(params))
            else:
                yield ChunkSnapshot(t_abs, None, None, outs, _probe(params))

    def run_sharded(self, *args, **kwargs):
        raise NotImplementedError("run_sharded waits for multi-GPU chains in the port")

    def lower_sharded(self, *args, **kwargs):
        raise NotImplementedError("lower_sharded waits for multi-GPU chains in the port")


def ess_feedback_adapter(controller, hyper_key: str = "step_size"):
    """Bridge a ``core.FeedbackESS`` controller to the executor's
    ``adapt_fn`` hook: at each chunk boundary, turn the in-carry
    batch-means ESS into an ESS-per-step rate, feed it to
    ``controller.update``, and hand the controller's new value back as
    ``hyper[hyper_key]`` (a ``numpy.float32``).  Needs an executor with
    ``ess_probe_fn`` and a ``sampler_factory`` that reads
    ``hyper[hyper_key]``."""

    def adapt(step_end, carry, hyper):
        es = carry.get("ess")
        if es is None:
            raise ValueError("ess_feedback_adapter requires an executor with ess_probe_fn")
        count = float(es.count)
        if count < 2.0 * float(es.batch_len):
            return None  # need >= 2 complete batches for a defensible estimate
        ess = batch_ess_estimate(es).cpu().numpy()
        controller.update(float(np.mean(ess)) / max(count, 1.0), step=step_end)
        new_hyper = dict(hyper or {})
        new_hyper[hyper_key] = np.float32(controller.value)
        return new_hyper

    return adapt


def rollout(
    sampler,
    grad_fn,
    params,
    *,
    num_steps: int,
    keys=None,
    key=None,
    state=None,
    trace: bool = True,
    thin: int = 1,
    moments: bool = True,
    moments_from: int = 0,
    chunk_steps: int = 4096,
    key_mode: str = "keys",
    sweep: bool = False,
    **kw,
) -> RunResult:
    """One-call executor run for sampler-over-potential workloads (the
    stationary battery, toy benchmarks, ensemble collection).
    ``grad_fn(theta)`` takes only the gradient targets.  With ``sweep`` the
    params carry a leading axis of S runs, and each run's state is its own
    ``sampler.init`` (stacked)."""
    if chunk_steps % thin != 0:
        chunk_steps = thin * max(chunk_steps // thin, 1)
    ex = ChainExecutor(
        sampler=sampler,
        grad_fn=lambda targets, _batch: grad_fn(targets),
        trace_fn=(lambda p: p) if trace else None,
        thin=thin,
        moments=moments,
        moments_from=moments_from,
        chunk_steps=chunk_steps,
        key_mode=key_mode,
        **kw,
    )
    if state is None:
        state = (stack_runs([sampler.init(_index(params, i))
                              for i in range(int(tree_leaves(params)[0].shape[0]))])
                 if sweep else sampler.init(params))
    return ex.run(params, state, num_steps=num_steps, keys=keys, key=key, sweep=sweep)
