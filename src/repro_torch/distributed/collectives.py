"""The port's collectives and the binding of a chain-axis name to a
process group.

In the reference a sampler built with ``chain_axis="chain"`` reduces over
the mesh axis of that name, which the enclosing ``shard_map`` binds; the
name is unbound, and the sampler fails, outside it.  Eager torch has no
such scope, so ``bind_axis`` opens one: within it, ``axis(name)`` gives the
``AxisBinding`` (process group, this rank's index on the axis, the axis
size) that ``ChainExecutor.run_sharded`` bound; outside it ``axis`` raises
``NameError``, as an unbound axis name does in JAX.

Every collective the port issues goes through ``all_reduce_sum``,
``all_reduce_min`` or ``all_gather`` here, which count it, by op and
payload bytes, in the ``distributed.collectives`` counters of the default
metrics registry (``collective_counts``).  That count replaces the
reference's reading of the lowered program's text (``lower_sharded``):
eager torch has no lowered program, and the one-collective-per-sync
contract is checked on the counter instead.  A gloo group takes CUDA tensors through host copies
(gloo's collectives run on the host); NCCL takes them as they are.
"""
from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Any, NamedTuple

import torch

from repro_torch.obs.metrics import default_registry

PREFIX = "distributed.collectives"
OPS = ("all_reduce", "all_gather")


class AxisBinding(NamedTuple):
    group: Any  # torch.distributed ProcessGroup
    rank: int  # this process's index on the axis
    size: int  # the axis size W


_BOUND: contextvars.ContextVar = contextvars.ContextVar("repro_torch_chain_axes", default={})


@contextlib.contextmanager
def bind_axis(name: str, binding: AxisBinding):
    """Bind the axis name ``name`` to ``binding`` for the duration of the
    ``with`` block."""
    token = _BOUND.set({**_BOUND.get(), name: binding})
    try:
        yield binding
    finally:
        _BOUND.reset(token)


def axis(name: str) -> AxisBinding:
    """The binding of axis ``name``; raises ``NameError`` when unbound."""
    binding = _BOUND.get().get(name)
    if binding is None:
        raise NameError(f"unbound axis name: {name!r} (a sampler built with chain_axis= runs "
                        "inside ChainExecutor.run_sharded, which binds it)")
    return binding


def mesh_axis(mesh, name: str) -> AxisBinding:
    """The binding of dimension ``name`` of a 1-D or N-D
    ``torch.distributed.device_mesh.DeviceMesh``; raises ``ValueError`` when
    the mesh has no such dimension."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"mesh has axes {names}; no {name!r} axis")
    dim = names.index(name)
    return AxisBinding(mesh.get_group(name), int(mesh.get_local_rank(name)), int(mesh.size(dim)))


def _count(op: str, nbytes: int) -> None:
    reg = default_registry()
    reg.counter(f"{PREFIX}.{op}_total").inc(1)
    reg.counter(f"{PREFIX}.{op}_bytes_total").inc(int(nbytes))


def collective_counts() -> dict:
    """``{op: {"calls": n, "bytes": b}}`` for every op counted since the
    last ``reset_collective_counts`` (ops never issued read 0)."""
    snap = default_registry().snapshot()
    return {op: {"calls": int(snap.get(f"{PREFIX}.{op}_total", 0)),
                 "bytes": int(snap.get(f"{PREFIX}.{op}_bytes_total", 0))} for op in OPS}


def reset_collective_counts() -> None:
    reg = default_registry()
    for op in OPS:
        reg.counter(f"{PREFIX}.{op}_total").value = 0
        reg.counter(f"{PREFIX}.{op}_bytes_total").value = 0


def _on_host(group, t) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(buf, ax, op):
    import torch.distributed as dist

    _count("all_reduce", buf.numel() * buf.element_size())
    if _on_host(ax.group, buf):
        host = buf.cpu()
        dist.all_reduce(host, op=op, group=ax.group)
        return buf.copy_(host)
    dist.all_reduce(buf, op=op, group=ax.group)
    return buf


def all_reduce_sum(buf: torch.Tensor, ax: AxisBinding) -> torch.Tensor:
    """Sum ``buf`` over the axis, in place (every rank gets the same bits:
    gloo and NCCL both hand every rank the one reduced result)."""
    import torch.distributed as dist

    return _all_reduce(buf, ax, dist.ReduceOp.SUM)


def all_reduce_min(buf: torch.Tensor, ax: AxisBinding) -> torch.Tensor:
    """The elementwise minimum of ``buf`` over the axis, in place (counted
    as an all-reduce)."""
    import torch.distributed as dist

    return _all_reduce(buf, ax, dist.ReduceOp.MIN)


def host_world(mesh) -> AxisBinding:
    """Every rank of ``mesh`` as one axis on a gloo group: for agreement
    among ranks on host values (flags, device ids) that must not wait on a
    device stream.  The mesh must span the default process group.  Under a
    gloo default group this is the world group; under NCCL a gloo group
    over the same ranks is made, which is a collective call (every rank
    makes it)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"the mesh holds {mesh.size()} ranks; it must span all {world} ranks "
                         "of the process group")
    group = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return AxisBinding(group, dist.get_rank(), world)


def all_gather(x: torch.Tensor, ax: AxisBinding) -> torch.Tensor:
    """Every rank's ``x`` (contiguous, same shape on every rank), stacked in
    rank order: (W,) + x.shape."""
    import torch.distributed as dist

    _count("all_gather", x.numel() * x.element_size())
    src = (x.cpu() if _on_host(ax.group, x) else x.contiguous()).reshape(-1)
    out = torch.empty(ax.size * src.numel(), dtype=x.dtype, device=src.device)
    with warnings.catch_warnings():
        # torch 2.13 deprecates the name in favour of all_gather_single,
        # which the card's torch 2.11 may not have
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*",
                                category=FutureWarning)
        dist.all_gather_into_tensor(out, src, group=ax.group)
    return out.view((ax.size,) + tuple(x.shape)).to(x.device)
