"""Step-size schedules.  A schedule is ``step -> epsilon``: the step is a
host int and epsilon a ``numpy.float32``, formed in float32 arithmetic as
the reference's jnp schedules form it (Python constants rounded to f32
first).  ``FeedbackESS`` waits for the adaptive tier."""
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


def as_schedule(x):
    if callable(x):
        return x
    return constant(x)
