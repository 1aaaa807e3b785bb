"""The models on DTensors (the dry-run cells): where plain torch does not
carry over, the layout is written out, as GSPMD would partition it.

A cell lays the params out by the reference's rule tables and the
activations by their batch rows (``rows``).  Weights are all-gathered over
every axis but the tensor-parallel one when a block runs (``gathered``,
FSDP's gather; its backward reduce-scatters the gradient).  Each mixer
then runs on each rank's blocks as plain torch (GSPMD's shard_map):
attention and the MLP split their heads or hidden units over the
``model`` axis where the weights are split (Megatron's tensor
parallelism; the output is a partial sum over ``model``), every other
mixer runs on the rank's rows with its weights whole.  A recurrent or KV
state of another layout is brought to the rank's rows for the mixer and
written back (``state_rows``, ``write_back``).  Lookups on a split
vocabulary (the embedding, the gold logit of the loss) take each rank's
block and sum (``take_rows``, ``take_last``), as GSPMD partitions a
gather.  Between blocks the activation is constrained to its rows again,
which keeps DTensor's own choices, forward and backward, on layouts the
next op takes.  A mesh dim of size 1 never moves data (``_moved``).

On plain tensors every helper is the identity or the plain op, bit for
bit, and the models never reach the DTensor code.
"""
from __future__ import annotations

import torch

MODEL = "model"  # the tensor-parallel mesh axis; a weight keeps its split on it at use


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _placements(mesh, spec: dict) -> tuple:
    """Placements from ``{mesh dim: tensor dim | "partial"}``; absent mesh
    dims replicate."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for i in range(mesh.ndim):
        d = spec.get(i)
        out.append(Replicate() if d is None else Partial() if d == "partial" else Shard(d))
    return tuple(out)


def _moved(v, pl):
    """``v`` redistributed to ``pl``.  A mesh dim of size 1 never moves
    data: its block is the whole tensor whatever the placement, so the
    block is only relabelled there."""
    pl = tuple(pl)
    if pl == tuple(v.placements):
        return v
    mesh = v.device_mesh
    unit = tuple(pl[i] if mesh.size(i) == 1 else p for i, p in enumerate(v.placements))
    if unit != tuple(v.placements):
        from repro_torch.distributed.sharding import as_dtensor

        v = as_dtensor(v.to_local(), unit, mesh, tuple(v.shape))
    return v if unit == pl else v.redistribute(mesh, pl)


def model_axis(x):
    """(mesh dim of ``model`` or None when absent or of size 1, its size,
    this rank's coordinate on it)."""
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    if MODEL not in names or mesh.size(names.index(MODEL)) == 1:
        return None, 1, 0
    mi = names.index(MODEL)
    return mi, mesh.size(mi), mesh.get_coordinate()[mi]


def row_dims(x) -> dict:
    """``{mesh dim: 0}`` for the mesh dims that split ``x``'s rows (dim 0)."""
    return {i: 0 for i, p in enumerate(x.placements) if p.is_shard() and p.dim == 0}


def to_layout(v, mesh, spec: dict, partial=()):
    """This rank's block of ``v`` laid out by ``spec`` (a DTensor is
    redistributed; a plain tensor is taken as replicated).  ``partial``:
    the mesh dims along which the ranks feed the block to different work
    (their own rows, their own heads), so that its gradient is a partial
    sum over them where the block is whole (the backward all-reduce of
    data and tensor parallelism)."""
    pl = _placements(mesh, spec)
    if not is_dtensor(v):
        from repro_torch.distributed.sharding import block

        return block(v, pl, mesh)
    v = _moved(v, pl)
    pl = tuple(v.placements)
    if not any(pl[i].is_replicate() for i in partial):
        return v.to_local()
    from torch.distributed.tensor import Partial

    grad = tuple(Partial() if i in partial and p.is_replicate() else p
                 for i, p in enumerate(pl))
    return v.to_local(grad_placements=grad)


def sum_dims(like, tp: bool) -> frozenset:
    """The mesh dims of a local computation on ``like``'s rows that split
    its work: the rows' dims, and ``model`` when the heads or channels are
    split over it."""
    mi = model_axis(like)[0]
    return frozenset(row_dims(like)) | (frozenset({mi}) if tp and mi is not None else frozenset())


def wrap(local, mesh, spec: dict):
    """The DTensor whose block on this rank is ``local``, laid out by
    ``spec``."""
    from repro_torch.distributed.sharding import as_dtensor

    pl = _placements(mesh, spec)
    shape = list(local.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return as_dtensor(local, pl, mesh, tuple(shape))


def rows(x):
    """An activation laid out by its rows: dim 0 split as it is, every other
    dim whole and no partial sums (GSPMD's sharding constraint between
    blocks).  Plain tensors as they are."""
    if not is_dtensor(x):
        return x
    return _moved(x, _placements(x.device_mesh, row_dims(x)))


def gathered(tree):
    """A block's params at use: each DTensor weight all-gathered over every
    mesh axis but ``model`` (FSDP's gather before a layer runs; its backward
    reduce-scatters the gradient).  Plain tensors as they are."""
    from repro_torch.models.common import tree_map

    def one(w):
        if not is_dtensor(w):
            return w
        mesh = w.device_mesh
        spec = {i: p.dim for i, p in enumerate(w.placements)
                if p.is_shard() and mesh.mesh_dim_names[i] == MODEL}
        return _moved(w, _placements(mesh, spec))

    return tree_map(one, tree)


def whole(tree, partial=()):
    """Each DTensor of a tree whole on this rank (a local tensor;
    ``partial`` as in ``to_layout``)."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda w: to_layout(w, w.device_mesh, {}, partial) if is_dtensor(w) else w,
                    tree)


def split_on(w, dim: int) -> bool:
    """Whether the DTensor ``w`` is split over ``model`` along ``dim``."""
    mi = model_axis(w)[0]
    return mi is not None and w.placements[mi].is_shard() and w.placements[mi].dim == dim


def part(w, dim: int, lo: int, n: int, partial=()):
    """Entries ``lo .. lo + n`` of the DTensor weight ``w`` along ``dim``,
    local: its own block when ``model`` splits that dim into blocks of
    ``n`` (this rank's block is then the one asked for), else cut from the
    whole weight (``partial`` as in ``to_layout``)."""
    mi = model_axis(w)[0]
    if split_on(w, dim) and w.shape[dim] // w.device_mesh.size(mi) == n:
        return to_layout(w, w.device_mesh, {mi: dim}, partial)
    full = to_layout(w, w.device_mesh, {}, partial)
    return full if n == full.shape[dim] else full.narrow(dim, lo, n)


def heads_plan(cfg, x, kv_split: bool, q_split: bool):
    """How attention splits its heads over ``model``: (q heads, kv heads,
    first q head, first kv head, split?) on this rank.  ``kv_split``: the kv
    heads are split over ``model`` (each rank takes its kv heads and their
    query groups); else ``q_split``: the query heads are, and each rank
    takes the kv heads its queries read; else every rank takes every head."""
    _, m, r = model_axis(x)
    Hq, Hkv, G = cfg.num_heads, cfg.num_kv_heads, cfg.q_per_kv
    if m > 1 and kv_split:
        return Hq // m, Hkv // m, r * Hq // m, r * Hkv // m, True
    if m > 1 and q_split:
        hq = Hq // m
        if hq % G and G % hq:
            raise ValueError(f"{Hq} query heads over {m} ranks cut the groups of {G}")
        return hq, max(hq // G, 1), r * hq, r * hq // G, True
    return Hq, Hkv, 0, 0, False


def attn_weights(p, plan, partial=()):
    """An attention layer's weights for this rank's heads (local;
    ``partial`` as in ``to_layout``)."""
    hq, hkv, q0, k0, _ = plan
    out = {"wq": part(p["wq"], 1, q0, hq, partial), "wk": part(p["wk"], 1, k0, hkv, partial),
           "wv": part(p["wv"], 1, k0, hkv, partial), "wo": part(p["wo"], 0, q0, hq, partial)}
    for k in ("q_norm", "k_norm"):
        if k in p:
            out[k] = to_layout(p[k], p[k].device_mesh, {}, partial)
    return out


def local_rows(v, like, dim: int = 0, partial=()):
    """This rank's rows of ``v`` (its ``dim`` laid out as ``like``'s rows),
    every other dim whole (``partial`` as in ``to_layout``)."""
    return to_layout(v, like.device_mesh, {i: dim for i in row_dims(like)}, partial)


def out_rows(local, like, partial: bool):
    """A mixer's local output as a DTensor: rows as ``like``'s, a partial
    sum over ``model`` when the mixer split its weights there."""
    spec = dict(row_dims(like))
    mi = model_axis(like)[0]
    if partial and mi is not None:
        spec[mi] = "partial"
    return wrap(local, like.device_mesh, spec)


def _keep_rows(s, like, dims) -> dict:
    """The split of ``s`` kept: on the mesh dims that split ``like``'s
    rows, and on ``model`` where it splits one of the tensor dims
    ``dims``."""
    rd = row_dims(like)
    mi = model_axis(s)[0]
    return {i: p.dim for i, p in enumerate(s.placements)
            if p.is_shard() and (i in rd or (i == mi and p.dim in dims))}


def state_rows(state, like, dims=()):
    """A state tree brought to ``like``'s rows: per DTensor leaf, the mesh
    dims that split ``like``'s rows keep splitting the leaf (and ``model``
    where it splits one of the dims ``dims``), every other mesh dim is
    gathered (a copy where the layout differs).  Returns the local tree."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda s: to_layout(s, s.device_mesh, _keep_rows(s, like, dims))
                    if is_dtensor(s) else s, state)


def write_back(state, local, like, dims=()) -> None:
    """Copy a state's local tree (from ``state_rows`` with the same
    ``dims``, updated in place by a plain mixer) back into the DTensor
    state where it was a copy."""
    from repro_torch.models.common import tree_leaves

    for s, loc in zip(tree_leaves(state), tree_leaves(local)):
        if not is_dtensor(s) or s.to_local().untyped_storage()._cdata == \
                loc.untyped_storage()._cdata:
            continue
        src = wrap(loc, s.device_mesh, _keep_rows(s, like, dims))
        s.to_local().copy_(_moved(src, s.placements).to_local())


def replicate_dims(x, dims):
    """``x`` with the dims ``dims`` whole on every rank."""
    if not is_dtensor(x):
        return x
    dims = {d % x.ndim for d in dims}
    spec = {i: p.dim for i, p in enumerate(x.placements) if p.is_shard() and p.dim not in dims}
    return _moved(x, _placements(x.device_mesh, spec))


def offset(x, dim: int) -> int:
    """The global index of this rank's first entry along ``dim``."""
    coord = x.device_mesh.get_coordinate()
    off, span = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            span //= x.device_mesh.size(i)
            off += coord[i] * span
    return off


def take_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])[..., 0]``: on a DTensor whose
    last dim (the vocabulary) is split, each rank takes the entries that
    fall in its block and the results are summed (GSPMD's partitioned
    gather)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    last = x.ndim - 1
    mesh = x.device_mesh
    loc = x.to_local()
    lead = {i: p.dim for i, p in enumerate(x.placements) if p.is_shard() and p.dim != last}
    rel = to_layout(idx, mesh, lead) - offset(x, last)
    inside = (rel >= 0) & (rel < loc.shape[-1])
    g = torch.gather(loc, -1, rel.clamp(0, loc.shape[-1] - 1)[..., None])[..., 0]
    g = torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))
    spec = dict(lead)
    spec.update({i: "partial" for i, p in enumerate(x.placements)
                 if p.is_shard() and p.dim == last})
    return wrap(g, mesh, spec)


def copy_(dst, src) -> None:
    """``dst.copy_(src)`` in place, ``src`` brought to ``dst``'s layout."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    dst.to_local().copy_(_moved(src, dst.placements).to_local())


def _wrap_rows(out, like):
    """A local output tree as DTensors: a tensor laid out by ``like``'s
    rows, a 0-d one as a partial sum over them."""
    from repro_torch.models.common import map_tensors

    rd = row_dims(like)
    return map_tensors(lambda t: wrap(t, like.device_mesh, {i: "partial" for i in rd}
                                      if t.ndim == 0 else rd), out)


def rows_local(fn, like, weights, *trees, states=()):
    """``fn(weights, *trees, *states)`` on the rank's rows as plain torch:
    the weights whole, the other trees and the states on ``like``'s rows
    (the states written back afterwards).  The outputs come back laid out
    by the rows (0-d ones as partial sums over them)."""
    s_l = [state_rows(s, like) for s in states]
    out = fn(whole(weights, sum_dims(like, False)), *(state_rows(t, like) for t in trees), *s_l)
    for s, loc in zip(states, s_l):
        write_back(s, loc, like)
    return _wrap_rows(out, like)


def take_rows(table, idx):
    """``table[idx]`` for a DTensor table (V, D) and integer ``idx`` laid
    out by rows: each rank looks its rows up in its block of the table
    (the vocabulary split over ``model`` or whole), the entries outside the
    block zero, and the results are summed over ``model`` (GSPMD's
    partitioned gather); the table's gradient is a partial sum over the
    rows' mesh dims."""
    mesh = table.device_mesh
    like = idx if is_dtensor(idx) else None
    rows = row_dims(like) if like is not None else {}
    mi = model_axis(table)[0]
    split = split_on(table, 0)
    loc = to_layout(table, mesh, {mi: 0} if split else {}, frozenset(rows))
    ids = to_layout(idx, mesh, rows) if is_dtensor(idx) else idx
    rel = ids - (offset(table, 0) if split else 0)
    inside = (rel >= 0) & (rel < loc.shape[0])
    out = loc[rel.clamp(0, loc.shape[0] - 1)]
    out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    spec = dict(rows)
    if split:
        spec[mi] = "partial"
    return wrap(out, mesh, spec)
