"""Step-size schedules.  A schedule is ``step -> epsilon``: the step is a
host int and epsilon a ``numpy.float32``, formed in float32 arithmetic as
the reference's jnp schedules form it (Python constants rounded to f32
first).  ``FeedbackESS`` is a host-side controller that is also a
schedule."""
from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def constant(value: float):
    def fn(step):
        return F32(value)

    return fn


def polynomial_decay(a: float, b: float, gamma: float):
    """epsilon_t = a * (b + t)^(-gamma), the classic SG-MCMC decay
    (Welling & Teh 2011 conditions: gamma in (0.5, 1])."""

    def fn(step):
        return F32(F32(a) * np.power(F32(b) + F32(step), F32(-gamma)))

    return fn


def cosine(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        frac = np.clip(F32(step) / F32(max(total_steps, 1)), F32(0.0), F32(1.0))
        return F32(F32(floor) + F32(0.5 * (peak - floor)) * (F32(1.0) + np.cos(F32(math.pi) * frac)))

    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def fn(step):
        t = F32(step)
        if t < warmup_steps:
            return F32(F32(peak) * t / F32(max(warmup_steps, 1)))
        frac = np.clip((t - F32(warmup_steps)) / F32(max(total_steps - warmup_steps, 1)),
                       F32(0.0), F32(1.0))
        return F32(F32(floor) + F32(0.5 * (peak - floor)) * (F32(1.0) + np.cos(F32(math.pi) * frac)))

    return fn


class FeedbackESS:
    """Feedback step-size controller driven by measured sampling efficiency:
    callable like any schedule, plus an ``update()`` hook the host calls
    between chunks.

    Control law (multiplicative integral control on the ESS rate):

        err   = clip((target − ess_rate) / target, −1, 1)
        ε  ←  clip(ε · exp(gain · err), lo·ε₀, hi·ε₀)

    ESS per step below target means the chain mixes too slowly, so ε
    grows; above target, ε shrinks back toward the small-bias regime.
    Updates stop for steps ≥ ``freeze_at`` (or after ``freeze()``), so a
    measurement window has a fixed step size.  As a schedule it returns
    the current ε for any step, as a ``numpy.float32``; ``ChainExecutor``
    passes ε through ``hyper`` instead and calls ``update()`` at chunk
    boundaries (``run.ess_feedback_adapter``)."""

    def __init__(self, init: float, target_ess_rate: float, gain: float = 0.5,
                 bounds: tuple = (0.1, 10.0), freeze_at: int | None = None):
        if not (init > 0.0 and target_ess_rate > 0.0 and gain >= 0.0):
            raise ValueError("init/target must be > 0, gain >= 0")
        self.eps0 = float(init)
        self.value = float(init)
        self.target = float(target_ess_rate)
        self.gain = float(gain)
        self.lo = float(bounds[0]) * self.eps0
        self.hi = float(bounds[1]) * self.eps0
        self.freeze_at = freeze_at
        self.frozen = False

    def __call__(self, step):
        del step  # the current value IS the schedule; the host advances it
        return F32(self.value)

    def update(self, ess_rate, step: int | None = None) -> float:
        """Feed one ESS-per-step measurement; returns the (new) ε.  No-op
        once frozen (``step >= freeze_at`` or ``freeze()`` called)."""
        if self.frozen or (
            self.freeze_at is not None and step is not None and step >= self.freeze_at
        ):
            self.frozen = True
            return self.value
        err = min(max((self.target - float(ess_rate)) / self.target, -1.0), 1.0)
        self.value = min(max(self.value * math.exp(self.gain * err), self.lo), self.hi)
        return self.value

    def freeze(self):
        self.frozen = True


def feedback_ess(init: float, target_ess_rate: float, **kw) -> FeedbackESS:
    """Factory mirroring the other schedule constructors."""
    return FeedbackESS(init, target_ess_rate, **kw)


def as_schedule(x):
    if callable(x):
        return x
    return constant(x)
