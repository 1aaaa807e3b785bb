"""Arithmetic helpers on parameter trees: nested dicts of tensors, or a
bare tensor.  Leaves are visited in sorted-key order, the reference
pytree's flatten order.  Noise draws take an explicit ``torch.Generator``
on the leaves' device."""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

from . import rng as rnglib

__all__ = [
    "apply_updates",
    "count_params",
    "global_norm",
    "leaf_normals",
    "tree_add",
    "tree_broadcast_axis0",
    "tree_cast",
    "tree_dot",
    "tree_leaves",
    "tree_map",
    "tree_mean_axis0",
    "tree_random_normal",
    "tree_scale",
    "tree_sub",
    "tree_unflatten",
    "tree_zeros_like",
]


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_zeros_like(a, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), a)


def tree_dot(a, b):
    """Sum over leaves of the f32 inner products, a 0-d f32 tensor."""
    terms = [torch.sum(x.float() * y.float()) for x, y in zip(tree_leaves(a), tree_leaves(b))]
    if not terms:
        return torch.zeros((), dtype=torch.float32)
    return torch.sum(torch.stack(terms))


def global_norm(a):
    return torch.sqrt(tree_dot(a, a))


def tree_random_normal(generator: torch.Generator, target, dtype=None):
    """A standard normal draw per leaf of ``target`` (shape-matched), taken
    from ``generator`` leaf after leaf in flatten order."""
    return tree_unflatten(target, [
        torch.randn(x.shape, generator=generator, dtype=dtype or x.dtype, device=x.device)
        for x in tree_leaves(target)
    ])


def leaf_normals(given, key, target):
    """Standard normals shaped like ``target``'s leaves, in flatten order:
    the leaves of ``given`` when it is not None, else f32 draws from one
    generator seeded by ``key`` (``tree_random_normal``'s draws), made one
    leaf at a time so that the whole noise tree never exists."""
    if given is not None:
        yield from tree_leaves(given)
        return
    leaves = tree_leaves(target)
    gen = rnglib.generator(key, leaves[0].device)
    for x in leaves:
        yield torch.randn(x.shape, generator=gen, dtype=torch.float32, device=x.device)


def apply_updates(params, updates):
    """params + updates in the params' dtypes, written IN PLACE into the
    params' leaves (the reference returns new arrays; the values are the
    same).  Returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


def tree_mean_axis0(a):
    """Mean over the leading (chain) axis of every leaf."""
    return tree_map(lambda x: torch.mean(x, dim=0), a)


def tree_broadcast_axis0(a, k: int):
    """Every leaf broadcast to a leading axis of size k (a view)."""
    return tree_map(lambda x: x[None].expand((k,) + tuple(x.shape)), a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def count_params(a) -> int:
    return sum(int(x.numel()) for x in tree_leaves(a))
