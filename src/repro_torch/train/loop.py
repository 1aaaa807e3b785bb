"""The training loop: sampler-driven posterior sampling with fault
tolerance (atomic checkpoints, auto-resume, simulated preemption) and
elastic chain scaling.

The executor (``run.ChainExecutor``, key mode ``"fold"``) advances chunks
of steps; the host acts only at chunk boundaries.  The chunk length is the
GCD of every host-event cadence (checkpoint, logging, simulated
preemption), so each event lands exactly on a boundary.  The step's key is
folded from the absolute step index, so a resumed run draws the noise the
uninterrupted run would have drawn.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core import rng as rnglib
from repro_torch.obs import get_logger
from repro_torch.run import ChainExecutor

from . import checkpoint as ckpt_lib

log = get_logger("loop")


@dataclass
class LoopConfig:
    num_steps: int = 200
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    preempt_at: Optional[int] = None  # simulate a kill after this step
    seed: int = 0
    max_chunk: int = 1024  # upper bound on steps per chunk


class Preempted(RuntimeError):
    pass


def _chunk_steps(cfg: LoopConfig) -> int:
    """Largest chunk whose boundaries hit every host-event step exactly."""
    g = 0
    if cfg.ckpt_dir:
        g = math.gcd(g, cfg.ckpt_every)
    if cfg.log_every:
        g = math.gcd(g, cfg.log_every)
    if cfg.preempt_at is not None:
        g = math.gcd(g, cfg.preempt_at)
    if g == 0:
        return max(min(cfg.num_steps or cfg.max_chunk, cfg.max_chunk), 1)
    if g <= cfg.max_chunk:
        return g
    return max(d for d in range(1, cfg.max_chunk + 1) if g % d == 0)


def run(
    train_step: Callable,  # (params, state, batch, rng) -> (params, state, metrics)
    init_params,
    init_state,
    batch_fn: Callable,  # (step) -> batch
    cfg: LoopConfig,
    num_chains: int = 1,
    alpha: float = 1.0,
    sampler=None,  # optional: its stats hook is logged at boundaries
):
    """Returns (params, state, history).  ``history`` holds one dict per
    logging boundary: the step's metrics, the sampler's stats and the wall
    time.  Auto-resumes from ``cfg.ckpt_dir`` (elastically when the chain
    count changed); the params and state passed in are the templates of
    that restore and are otherwise advanced in place."""
    params, state = init_params, init_state
    start = 0
    if cfg.ckpt_dir:
        got = ckpt_lib.restore_elastic(
            cfg.ckpt_dir, params, state, num_chains=num_chains, alpha=alpha, seed=cfg.seed
        )
        if got is not None:
            start, params, state, extra = got
            log.info(f"resumed from step {start}" + (" (elastic)" if extra.get("elastic_resample") else ""))
    executor = ChainExecutor(step_fn=train_step, batch_fn=batch_fn, key_mode="fold",
                             chunk_steps=_chunk_steps(cfg))
    stats_fn = sampler.stats if sampler is not None and sampler.stats else None
    history = []
    t0 = time.time()

    def on_chunk(step_end, params, state, outs):
        if cfg.ckpt_dir and step_end % cfg.ckpt_every == 0:
            ckpt_lib.save(cfg.ckpt_dir, step_end, params, state)
            ckpt_lib.prune(cfg.ckpt_dir, cfg.keep_ckpts)
        if cfg.log_every and step_end % cfg.log_every == 0:
            m = {k: float(v[-1]) for k, v in outs["metrics"].items()}
            if stats_fn is not None:
                m.update({k: float(v) for k, v in stats_fn(state, params).items() if k != "step"})
            m["step"] = step_end
            m["wall_s"] = round(time.time() - t0, 2)
            history.append(m)
            log.info(f"step {step_end}: " + " ".join(f"{k}={v:.5g}" for k, v in m.items()
                                                      if k != "step"))
        if cfg.preempt_at is not None and step_end == cfg.preempt_at:
            raise Preempted(f"simulated preemption at step {step_end}")

    if start < cfg.num_steps:
        result = executor.run(params, state, num_steps=cfg.num_steps - start,
                              key=rnglib.key(cfg.seed), start_step=start, on_chunk=on_chunk)
        params, state = result.params, result.state
    return params, state, history
