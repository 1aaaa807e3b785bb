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

Not ported here: ``build_spec``, ``tree_specs``, the logical-axis rule
tables and ``leading_axes_specs``.  They are GSPMD layouts for the dry-run
cells and the mesh-sharded serving engine, and come with those (ROADMAP
items 15 and 10b).
"""
from __future__ import annotations

from repro_torch.models.common import map_tensors

from . import collectives


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
