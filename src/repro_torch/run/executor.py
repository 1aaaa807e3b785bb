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
  dynamics.

Key modes (``key_mode``), as in the reference, over ``core.rng`` keys:

* ``"keys"``  — the caller passes one key per step;
* ``"fold"``  — the step's key is ``fold_in(base_key, absolute_step)``
  (resume-safe: the noise depends on the absolute step, not the chunking);
* ``"carry"`` — a key rides the carry and is split once per step.

The carry is CONSUMED: samplers and ``apply_updates`` update tensors in
place, so the params and state passed to ``run`` are the ones advanced.
Not ported yet (``NotImplementedError``): ``sampler_factory``/``hyper``
sweeps and ``adapt_fn`` (with the adaptive tier), ``stream`` (with the
serving refresher), ``run_sharded``/``lower_sharded`` (multi-GPU) and
``ess_feedback_adapter``.  Capturing a chunk as a CUDA graph is later
performance work.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import rng as rnglib
from repro_torch.core.tree_util import apply_updates, tree_leaves, tree_map
from repro_torch.diagnostics import (
    BatchMeansState,
    MomentState,
    batch_ess_add,
    batch_ess_init,
    welford_add,
    welford_init,
)


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


def _copy(tree):
    return tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, tree)


class ChainExecutor:
    """Runs sampling in chunks of at most ``chunk_steps`` steps.

    Exactly one of ``step_fn`` / ``sampler`` drives the dynamics:

    * ``step_fn(params, state, batch, rng) -> (params, state, metrics)``;
    * ``sampler`` + ``grad_fn(targets, batch) -> grads | (grads, metrics)``.

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
        if sampler_factory is not None:
            raise NotImplementedError("sampler_factory (hyperparameter sweeps) is not ported yet")
        if (step_fn is None) == (sampler is None):
            raise ValueError("exactly one of step_fn / sampler")
        if sampler is not None and grad_fn is None:
            raise ValueError("sampler mode needs grad_fn")
        if key_mode not in ("keys", "fold", "carry"):
            raise ValueError(f"unknown key_mode {key_mode!r}")
        if thin < 1 or chunk_steps < 1:
            raise ValueError("thin and chunk_steps must be >= 1")
        if trace_fn is not None and chunk_steps % thin != 0:
            raise ValueError("chunk_steps must be a multiple of thin when tracing")
        self.step_fn = step_fn
        self.sampler = sampler
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

    def _step(self):
        """(step, stats_fn)."""
        if self.step_fn is not None:
            return self.step_fn, None
        sampler, grad_fn = self.sampler, self.grad_fn

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
        """
        if hyper is not None or sweep:
            raise NotImplementedError("hyper / sweep runs are not ported yet")
        if adapt_fn is not None:
            raise NotImplementedError("adapt_fn waits for the adaptive tier in the port")
        if self.key_mode == "keys" and keys is None:
            raise ValueError("key_mode='keys' needs keys=")
        if self.key_mode in ("fold", "carry") and key is None:
            raise ValueError(f"key_mode={self.key_mode!r} needs key=")
        if self.trace_fn is not None and num_steps % self.thin != 0:
            raise ValueError("num_steps must be a multiple of thin when tracing")
        step, stats_fn = self._step()
        wf = ess = None
        if self.moments:
            wf = welford_init(params)
        if self.ess_probe_fn is not None:
            ess = batch_ess_init(self.ess_probe_fn(params), self.ess_batch_len)
        carry_key = key
        traces, stats, metrics = [], [], {}
        t_run, t_abs = 0, int(start_step)
        t0 = time.perf_counter()
        while t_run < num_steps:
            n = min(self.chunk_steps, num_steps - t_run)
            every = self.thin if self.trace_fn is not None else n
            outs = {"metrics": []}
            if self.trace_fn is not None:
                outs["trace"] = []
            if self.collect_stats and stats_fn is not None:
                outs["stats"] = []
            for i in range(n):
                if self.key_mode == "keys":
                    rng = keys[t_run + i]
                elif self.key_mode == "fold":
                    rng = rnglib.fold_in(key, t_abs + i)
                else:
                    carry_key, rng = rnglib.split(carry_key)
                batch = self.batch_fn(t_abs + i) if self.batch_fn is not None else None
                params, state, metrics = step(params, state, batch, rng)
                if t_abs + i >= self.moments_from:
                    if wf is not None:
                        wf = welford_add(wf, params)
                    if ess is not None:
                        ess = batch_ess_add(ess, self.ess_probe_fn(params))
                if (i + 1) % every == 0:
                    outs["metrics"].append(metrics)
                    if "trace" in outs:
                        outs["trace"].append(_copy(self.trace_fn(params)))
                    if "stats" in outs:
                        outs["stats"].append(stats_fn(state, params))
            outs = {k: _stack(v) if v and not _empty(v[0]) else {} for k, v in outs.items()}
            t_run += n
            t_abs += n
            if "trace" in outs:
                traces.append(outs["trace"])
            if "stats" in outs:
                stats.append(outs["stats"])
            if on_chunk is not None and on_chunk(t_abs, params, state, outs) is False:
                break
        _sync(params)
        wall = time.perf_counter() - t0
        cat = lambda ts: tree_map(lambda *xs: torch.cat(xs), *ts)
        return RunResult(
            params=params,
            state=state,
            trace=cat(traces) if traces else None,
            stats=cat(stats) if stats else None,
            metrics=metrics,
            moments=wf,
            ess=ess,
            steps=t_run,
            wall_s=wall,
        )

    def stream(self, *args, **kwargs):
        raise NotImplementedError("ChainExecutor.stream waits for the serving refresher in the port")

    def run_sharded(self, *args, **kwargs):
        raise NotImplementedError("run_sharded waits for multi-GPU chains in the port")

    def lower_sharded(self, *args, **kwargs):
        raise NotImplementedError("lower_sharded waits for multi-GPU chains in the port")


def ess_feedback_adapter(controller, hyper_key: str = "step_size"):
    raise NotImplementedError("ess_feedback_adapter waits for the adaptive tier in the port")


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
    stationary battery, ensemble collection).  ``grad_fn(theta)`` takes
    only the gradient targets."""
    if sweep:
        raise NotImplementedError("sweep runs are not ported yet")
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
        state = sampler.init(params)
    return ex.run(params, state, num_steps=num_steps, keys=keys, key=key)
