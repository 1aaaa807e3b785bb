"""Arithmetic helpers on parameter trees: nested dicts of tensors, or a
bare tensor.  Leaves are visited in sorted-key order, the reference
pytree's flatten order.  Noise draws take an explicit ``torch.Generator``
on the leaves' device.  ``tree_mean_axis0`` and ``pmean_into`` reduce over
a bound chain axis (``distributed.collectives``) with ONE all-reduce for
all the leaves."""
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
    "pmean_into",
    "tree_random_normal",
    "tree_random_normal_per_chain",
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


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _dtensor_normal(key: int, index: int, x, dtype):
    """Standard normals laid out like the DTensor ``x``: each rank draws its
    block from a generator keyed by ``key``, the leaf ``index`` and the
    block's coordinates on the sharded mesh dims, so replicas of a block
    draw the same numbers and distinct blocks independent ones."""
    from repro_torch.distributed.sharding import as_dtensor

    k = rnglib.fold_in(key, index)
    for i, (c, p) in enumerate(zip(x.device_mesh.get_coordinate(), x.placements)):
        if p.is_shard():
            k = rnglib.fold_in(rnglib.fold_in(k, i), c)
    loc = x.to_local()
    n = torch.randn(loc.shape, generator=rnglib.generator(k, loc.device), dtype=dtype,
                    device=loc.device)
    return as_dtensor(n, x.placements, x.device_mesh, tuple(x.shape))


def tree_random_normal(generator: torch.Generator, target, dtype=None):
    """A standard normal draw per leaf of ``target`` (shape-matched), taken
    from ``generator`` leaf after leaf in flatten order (DTensor leaves:
    per block, keyed by the generator's seed)."""
    return tree_unflatten(target, [
        _dtensor_normal(generator.initial_seed(), i, x, dtype or x.dtype) if _is_dtensor(x)
        else torch.randn(x.shape, generator=generator, dtype=dtype or x.dtype, device=x.device)
        for i, x in enumerate(tree_leaves(target))
    ])


def _chain_generators(key, offset: int, k: int, device):
    """Chain i's generator, seeded by ``fold_in(key, offset + i)``."""
    return [rnglib.generator(rnglib.fold_in(key, offset + i), device) for i in range(k)]


def _per_chain_leaf(gens, x, dtype):
    """One leaf's draw, chain i's slice from ``gens[i]``."""
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    for i, gen in enumerate(gens):
        out[i].normal_(generator=gen)
    return out


def tree_random_normal_per_chain(key, target, offset: int = 0, dtype=None):
    """One independent draw per leading-axis (chain) slice of ``target``:
    chain i draws its slices of every leaf, in flatten order, from
    ``fold_in(key, offset + i)``, so the stream depends only on the GLOBAL
    chain index.  A rank holding chains ``offset .. offset + k - 1`` of a
    sharded run draws exactly those chains' noise of the unsharded run
    (offset 0), whatever the layout (DESIGN.md §7)."""
    leaves = tree_leaves(target)
    gens = _chain_generators(key, offset, int(leaves[0].shape[0]), leaves[0].device)
    return tree_unflatten(target, [_per_chain_leaf(gens, x, dtype or x.dtype) for x in leaves])


def leaf_normals(given, key, target, offset=None):
    """Standard normals shaped like ``target``'s leaves, in flatten order:
    the leaves of ``given`` when it is not None, else f32 draws from one
    generator seeded by ``key`` (``tree_random_normal``'s draws) or, with a
    chain ``offset``, ``tree_random_normal_per_chain``'s draws; made one
    leaf at a time so that the whole noise tree never exists."""
    if given is not None:
        yield from tree_leaves(given)
        return
    leaves = tree_leaves(target)
    if offset is not None:
        gens = _chain_generators(key, offset, int(leaves[0].shape[0]), leaves[0].device)
        for x in leaves:
            yield _per_chain_leaf(gens, x, torch.float32)
        return
    if _is_dtensor(leaves[0]):
        for i, x in enumerate(leaves):
            yield _dtensor_normal(key, i, x, torch.float32)
        return
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


def tree_mean_axis0(a, axis_name: str | None = None):
    """Mean over the leading (chain) axis of every leaf.  With
    ``axis_name`` the chain axis is also split over the ranks of that bound
    axis: each rank takes the mean of its local chains, and the means are
    summed over the ranks (one all-reduce for all leaves) and divided by W,
    the reference's pmean of local means.  At W = 1 that is the unsharded
    mean bit for bit."""
    leaves = tree_leaves(a)
    if axis_name is None:
        return tree_unflatten(a, [torch.mean(x, dim=0) for x in leaves])
    outs = [torch.empty(tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
            for x in leaves]
    pmean_into(outs, lambda i: torch.mean(leaves[i].float(), dim=0), axis_name)
    return tree_unflatten(a, [o.to(x.dtype) for o, x in zip(outs, leaves)])


def _flat_f32(leaves):
    """The 1-D f32 tensor of which ``leaves`` are consecutive contiguous
    views, in order, or None."""
    first = leaves[0]
    st, off = first.untyped_storage()._cdata, first.storage_offset()
    for x in leaves:
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.untyped_storage()._cdata != st or x.storage_offset() != off):
            return None
        off += x.numel()
    return torch.as_strided(first, (off - first.storage_offset(),), (1,))


def flat_f32_views(shapes, device):
    """f32 tensors of ``shapes`` that are consecutive views of one flat
    buffer: what ``pmean_into`` reduces in place, with no copy."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
    return [v.view(tuple(s)) for v, s in zip(torch.split(flat, sizes), shapes)]


def pmean_into(outs, local_mean, axis_name: str) -> None:
    """The chain mean over a bound chain axis, leaf by leaf into ``outs``:
    ``local_mean(i)`` is this rank's mean of leaf i over its local chains.
    The local means are written into one flat f32 buffer (``outs`` itself
    when its leaves are consecutive f32 views of one, as
    ``flat_f32_views`` makes them, else a scratch buffer), ONE all-reduce
    sums it over the ranks in place, and it is divided by W."""
    from repro_torch.distributed import collectives

    ax = collectives.axis(axis_name)
    flat = _flat_f32(outs)
    views = outs
    if flat is None:
        sizes = [o.numel() for o in outs]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=outs[0].device)
        views = [v.view(o.shape) for v, o in zip(torch.split(flat, sizes), outs)]
    for i, v in enumerate(views):
        v.copy_(local_mean(i))
    collectives.all_reduce_sum(flat, ax)
    flat.div_(flat.new_full((), ax.size))  # IEEE division (a Python divisor multiplies on CUDA)
    if views is not outs:
        for o, v in zip(outs, views):
            o.copy_(v)


def tree_broadcast_axis0(a, k: int):
    """Every leaf broadcast to a leading axis of size k (a view)."""
    return tree_map(lambda x: x[None].expand((k,) + tuple(x.shape)), a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def count_params(a) -> int:
    return sum(int(x.numel()) for x in tree_leaves(a))
