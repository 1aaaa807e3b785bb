"""The chain-axis layout of a sampler's carry over ranks: the counterpart
of ``repro/distributed/sharding.py::chain_specs``.

The shape rule is the reference's: a tensor whose LEADING dim equals the
chain count K is split over the chain axis (rank r holds chains
``r*K/W .. (r+1)*K/W - 1``); everything else — the center state, step
counters, scalars — is replicated on every rank.  A carry whose replicated
state has a leading dim that happens to equal K needs explicit specs
(``specs=``, a tree of the axis name or None per tensor), as in the
reference.

* ``chain_specs`` — the rule as a tree (the axis name for a split tensor,
  None for a replicated one);
* ``local_chains`` — a rank's slice of a global tree (views, no copy);
* ``gather_chains`` — the global tree from every rank's slice (one
  all-gather per split tensor): what a global ``jax.Array`` is in the
  reference, for tests and checks after a run.

The serving engine's layout rule is the reference's too: ``leading_axes_specs``
grants mesh axis ``axes[i]`` to a tensor's i-th leading dim where the mesh
has that axis and its size divides the dim (else that dim replicates), and
``local_block`` cuts a rank's block of a tree by those specs.

The dry run's layouts are the reference's logical-axis rules: a *rule
table* maps logical axis names ("embed", "heads", "vocab", ...) to a mesh
axis or a tuple of them, and ``build_spec`` resolves one tensor: mesh axes
are granted in ``_PRIORITY`` order, each at most once per tensor, and a
grant that does not divide the dim evenly is dropped (that dim
replicates).  ``build_spec`` and ``tree_specs`` return the reference's
value, a per-dim entry of an axis name, a tuple of names or None, and read
only the mesh's ``{axis: size}``; ``tree_shardings`` turns those entries
into ``DTensor`` placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from collections.abc import Mapping

from repro_torch.models.common import map_tensors, tree_map

from . import collectives

# resolution priority: parameter-ish dims first, then batch, then sequence
_PRIORITY = ("chain", "expert", "kv_heads", "heads", "vocab", "mlp", "mlp2", "rnn", "embed",
             "batch", "kvseq", "seq")


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names`` and
    ``shape``), or of anything whose ``shape`` is that mapping (the
    reference's ``Mesh``)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(tuple(mesh.mesh_dim_names or ()), tuple(mesh.shape)))


def _axes_tuple(rule) -> tuple:
    if rule is None:
        return ()
    return tuple(rule) if isinstance(rule, (tuple, list)) else (rule,)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def build_spec(shape, axes, rules, mesh) -> tuple:
    """One tensor's layout: per dim, the mesh axis (or tuple of axes, in
    the rule's order) granted to its logical axis name, else None."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    sizes = _axis_sizes(mesh)
    entries: list = [None] * len(shape)
    used: set = set()
    order = sorted(range(len(axes)), key=lambda i: _PRIORITY.index(axes[i])
                   if axes[i] in _PRIORITY else len(_PRIORITY))
    for i in order:
        name = axes[i]
        if name is None or name not in rules:
            continue
        grant, size = [], 1
        for mx in _axes_tuple(rules[name]):
            if mx in used or mx not in sizes or shape[i] % (size * sizes[mx]) != 0:
                continue
            grant.append(mx)
            size *= sizes[mx]
        if grant:
            entries[i] = tuple(grant) if len(grant) > 1 else grant[0]
            used.update(grant)
    return tuple(entries)


def tree_specs(axes_tree, shapes_tree, rules, mesh):
    """``build_spec`` over matching trees of axes tuples and tensors (or
    anything with ``shape``)."""
    if _is_axes(axes_tree):
        return build_spec(tuple(shapes_tree.shape), axes_tree, rules, mesh)
    return {k: tree_specs(axes_tree[k], shapes_tree[k], rules, mesh) for k in axes_tree}


def spec_placements(spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` (one per mesh dim, in mesh order) of
    a ``build_spec`` entry tuple: a mesh dim granted to tensor dim ``d``
    shards it (``Shard(d)``), an ungranted one replicates.  A dim sharded
    over several mesh axes nests them in mesh order, as DTensor does, so a
    tuple out of mesh order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        grant = _axes_tuple(entry)
        idx = [names.index(a) for a in grant]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {grant}, out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(axes_tree, shapes_tree, rules, mesh):
    """The placements tree of ``tree_specs`` on a ``DeviceMesh``."""
    return tree_map(lambda s: spec_placements(s, mesh),
                    tree_specs(axes_tree, shapes_tree, rules, mesh))


def chain_specs(tree, num_chains: int, axis_name: str = "chain"):
    """``axis_name`` for each tensor whose leading dim is ``num_chains``,
    else None: the reference's PartitionSpec rule, as a tree."""
    return map_tensors(lambda x: axis_name if x.ndim >= 1 and x.shape[0] == num_chains
                       else None, tree)


def _specs(tree, num_chains, axis_name, specs):
    return chain_specs(tree, num_chains, axis_name) if specs is None else specs


def local_chains(tree, mesh, num_chains: int, axis_name: str = "chain", specs=None):
    """This rank's slice of a global tree: split tensors cut to their
    ``num_chains / W`` local chains (contiguous views of the global
    tensors), replicated ones as they are."""
    ax = collectives.mesh_axis(mesh, axis_name)
    if num_chains % ax.size:
        raise ValueError(f"num_chains={num_chains} must be divisible by the {axis_name!r} "
                         f"mesh axis (size {ax.size})")
    k = num_chains // ax.size
    return map_tensors(lambda x, s: x[ax.rank * k:(ax.rank + 1) * k] if s else x, tree,
                       _specs(tree, num_chains, axis_name, specs))


def gather_chains(tree, mesh, num_chains: int, axis_name: str = "chain", specs=None):
    """The global tree from each rank's local tree: every split tensor
    all-gathered over the chain axis in rank order (one collective per
    tensor, counted), replicated ones as they are."""
    ax = collectives.mesh_axis(mesh, axis_name)
    local_k = num_chains // ax.size
    if specs is None:
        specs = chain_specs(tree, local_k, axis_name)
    return map_tensors(
        lambda x, s: collectives.all_gather(x, ax).reshape((-1,) + tuple(x.shape[1:])) if s
        else x, tree, specs)


def leading_axes_specs(tree, axes, mesh):
    """Per tensor, a tuple granting ``axes[i]`` to its i-th LEADING dim when
    the mesh has that axis and the axis size divides the dim (else None:
    that dim replicates); as long as the shorter of ``axes`` and the
    tensor's dims.  The reference's PartitionSpec rule, as a tree: pooled
    caches are (member, slot, ...), slot state (slot, ...), member stacks
    (member, ...)."""
    sizes = _axis_sizes(mesh)

    def spec(x):
        return tuple(name if name is not None and name in sizes and x.shape[i] % sizes[name] == 0
                     else None for i, name in enumerate(axes[:x.ndim]))

    return map_tensors(spec, tree)


def local_block(tree, specs, mesh):
    """This rank's block of a global tree: every dim a spec grants an axis
    cut to the rank's contiguous share along it (views, no copy), the
    other dims whole."""
    def cut(x, spec):
        for dim, name in enumerate(spec):
            if name is not None:
                ax = collectives.mesh_axis(mesh, name)
                n = x.shape[dim] // ax.size
                x = x.narrow(dim, ax.rank * n, n)
        return x

    return map_tensors(cut, tree, specs)


# ---------------------------------------------------------------------------
# Rule tables (the reference's, value for value)
# ---------------------------------------------------------------------------


def train_param_rules(mesh, pure_dp: bool = False, fsdp: bool = True, style: str = "tp_fsdp"):
    """Chain-stacked params.  Styles: ``tp_fsdp``, TP over ``model`` and
    FSDP over ``data``; ``fsdp2d``, params sharded over (data, model) on the
    embed dim with no tensor parallelism; ``dp``, params replicated."""
    sizes = _axis_sizes(mesh)
    chain_axes = tuple(a for a in ("pod", "chain") if a in sizes)
    if pure_dp or style == "dp":
        return {"chain": chain_axes}
    if style == "fsdp2d":
        return {"chain": chain_axes, "embed": ("data", "model")}
    rules = {"chain": chain_axes, "vocab": "model", "mlp": "model", "mlp2": "model",
             "heads": "model", "kv_heads": "model", "expert": "model", "rnn": "model"}
    if fsdp:
        rules["embed"] = "data"
    return rules


def center_rules(mesh, pure_dp: bool = False):
    """Center variables (c, r, c̃, m̃θ) have no chain axis: they shard over
    the whole mesh (the chain and pod axes fold into the FSDP axis)."""
    sizes = _axis_sizes(mesh)
    full_data = tuple(a for a in ("pod", "chain", "data") if a in sizes)
    if pure_dp:
        return {"vocab": full_data, "embed": "model", "mlp": "model"}
    return {"vocab": "model", "mlp": "model", "mlp2": "model", "heads": "model",
            "kv_heads": "model", "expert": "model", "rnn": "model", "embed": full_data}


def serve_param_rules(mesh, fsdp: bool = False, pure_dp: bool = False, style: str = "tp_fsdp"):
    sizes = _axis_sizes(mesh)
    if pure_dp or style == "dp":
        return {}
    if style == "fsdp2d":
        return {"embed": tuple(a for a in ("pod", "data", "model") if a in sizes)}
    rules = {"vocab": "model", "mlp": "model", "mlp2": "model", "heads": "model",
             "kv_heads": "model", "expert": "model", "rnn": "model"}
    if fsdp:
        rules["embed"] = tuple(a for a in ("pod", "data") if a in sizes)
    return rules


def batch_rules(mesh, pure_dp: bool = False, style: str = "tp_fsdp"):
    sizes = _axis_sizes(mesh)
    chain_axes = tuple(a for a in ("pod", "chain") if a in sizes)
    # without tensor parallelism the model axis is free for batch rows
    wide = pure_dp or style in ("fsdp2d", "dp")
    return {"chain": chain_axes, "batch": ("data", "model") if wide else ("data",),
            # sequence dims pick up whatever is left (long_500k: B=1)
            "kvseq": ("data", "model") if not wide else ("data",), "seq": ()}


def serve_batch_rules(mesh):
    data_axes = tuple(a for a in ("pod", "data") if a in _axis_sizes(mesh))
    return {"batch": data_axes, "kv_heads": "model", "heads": "model", "rnn": "model",
            "kvseq": data_axes + ("model",), "embed": (), "vocab": "model", "mlp": "model"}


# ---------------------------------------------------------------------------
# Placing trees as DTensors
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_shape(shape, placements, mesh) -> tuple:
    """The shape of each rank's block of a ``shape`` tensor laid out by
    ``placements`` (every sharded dim divides evenly, as ``build_spec``
    grants)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def _stride(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def as_dtensor(local, placements, mesh, shape):
    """A DTensor of global ``shape`` whose block on this rank is ``local``."""
    import torch
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_stride(shape))


def block(x, placements, mesh):
    """This rank's block of a full tensor ``x`` laid out by ``placements``:
    the mesh dims sharding one tensor dim nest in mesh order, as DTensor
    lays them out."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            n = x.shape[p.dim] // mesh.size(i)
            x = x.narrow(p.dim, coord[i] * n, n)
    return x


def empty_tree(abstract_tree, placements_tree, mesh, device, zeros: bool = False):
    """DTensors of an abstract tree's shapes and dtypes, each rank's block
    made by ``torch.empty`` (``torch.zeros`` with ``zeros``) on ``device``:
    under ``FakeTensorMode`` the dry run's arguments, with no storage."""
    import torch

    make = torch.zeros if zeros else torch.empty

    def one(a, pl):
        if pl is None:
            return a
        return as_dtensor(make(local_shape(a.shape, pl, mesh), dtype=a.dtype, device=device),
                          pl, mesh, a.shape)

    return map_tensors(one, abstract_tree, placements_tree)


def zeros_like_layout(abstract_tree, placements_tree, like, mesh):
    """Zeros of an abstract tree: DTensors laid out by ``placements_tree``
    when the tensors of ``like`` are DTensors, else plain tensors on their
    device."""
    import torch

    from repro_torch.models.common import tree_leaves

    first = tree_leaves(like)[0]
    if is_dtensor(first):
        return empty_tree(abstract_tree, placements_tree, mesh, first.to_local().device,
                          zeros=True)
    return map_tensors(lambda a: torch.zeros(a.shape, dtype=a.dtype, device=first.device),
                       abstract_tree)
