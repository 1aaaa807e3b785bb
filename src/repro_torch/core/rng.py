"""Keys for the port's random streams.

A key is a 64-bit integer.  ``split`` and ``fold_in`` derive new keys with
the splitmix64 finaliser, as ``jax.random.split``/``fold_in`` derive them
from a threefry key; ``generator`` turns a key into a ``torch.Generator``
on a device, and the fused update kernel takes a key as its Philox seed.
The streams differ from JAX's: parity tests hand the reference's draws in
through the samplers' ``noise=`` argument instead.
"""
from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix(z: int) -> int:
    z = (z + _GOLDEN) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def key(seed: int) -> int:
    """The key of an integer seed."""
    return _mix(int(seed) & MASK64)


def split(k: int, num: int = 2) -> list[int]:
    """``num`` keys derived from ``k``, independent of each other."""
    return [_mix((int(k) ^ _mix(i + 1)) & MASK64) for i in range(num)]


def fold_in(k: int, data: int) -> int:
    """A key derived from ``k`` and an integer (a step or chain index)."""
    return _mix((int(k) * 0x2545F4914F6CDD1D + _mix(int(data) & MASK64)) & MASK64)


def generator(k: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from key ``k``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(k) & MASK64)
    return g
