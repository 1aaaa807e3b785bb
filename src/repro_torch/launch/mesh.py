"""The multi-process launch path of the port (DESIGN.md §7): the part of
``repro/launch/mesh.py`` that starts processes and builds the chain mesh.

* ``initialize_distributed`` — ``torch.distributed.init_process_group``
  from arguments or the torchrun variables (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``); a no-op returning
  ``(0, 1)`` when nothing identifies a multi-process job, so single-process
  entry points can call it unconditionally.
* ``make_chain_mesh`` — the 1-D ``(chain,)`` ``DeviceMesh`` over the
  process group's ranks that ``ChainExecutor.run_sharded`` takes.
* ``spawn_local`` — the single-host launcher, the counterpart of the
  reference's forced-device environment: W local ranks started with the
  ``spawn`` method (forking a process that has initialised CUDA breaks it),
  meeting at a ``file://`` rendezvous in a fresh temporary directory (so
  concurrent launches never race for a port), each group with a timeout
  (so a rank that dies does not hang its peers); a rank's exception is
  raised in the parent.

NCCL on the card (one rank per GPU), gloo on the CPU; gloo also runs
several ranks on one card, staging the collectives' CUDA tensors through
the host (``distributed.collectives``).  The TPU-slice meshes
(``make_production_mesh``, ``make_train_mesh``, ``make_serve_mesh``) come
with the dry run (ROADMAP item 15), ``make_engine_mesh`` with the
mesh-sharded engine (item 10b).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import traceback

DEFAULT_TIMEOUT_S = 300.0


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def initialize_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> tuple[int, int]:
    """Join (or, with nothing to join, skip) the default process group.
    Returns ``(rank, world_size)``.  ``backend`` defaults to NCCL when CUDA
    is available, else gloo; under NCCL the process takes the card
    ``LOCAL_RANK`` (else its rank) modulo the cards it sees."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if (init_method is None and world_size is None and rank is None
            and "RANK" not in os.environ):
        return 0, 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank, timeout=_timeout(timeout_s))
    return rank, world_size


def make_chain_mesh(num_ranks: int | None = None, *, axis: str = "chain"):
    """The 1-D ``(axis,)`` ``DeviceMesh`` over all ranks of the default
    process group (``num_ranks``, when given, must be its world size): a
    ``"cuda"`` mesh under NCCL, a ``"cpu"`` one under gloo (whatever device
    the tensors are on: gloo stages CUDA tensors through the host)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if num_ranks is None else int(num_ranks)
    if n != world:
        raise ValueError(f"a chain mesh spans the {world} ranks of the process group, not {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def _child(fn, rank, world_size, init_file, backend, timeout_s, args, results):
    import torch
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world_size, rank=rank, timeout=_timeout(timeout_s))
        try:
            # pickled by value here: a queue would share a tensor's storage by
            # file descriptor, which dies with this process
            results.put((rank, True, pickle.dumps(fn(rank, world_size, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_local(fn, world_size: int, *args, backend: str = "gloo",
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes of one process group and return their results in rank order.
    ``fn`` and its arguments and result must pickle (``fn`` a module-level
    function).  Raises ``RuntimeError`` with the traceback of a rank that
    raised or died, or when the ranks take longer than ``timeout_s``; every
    process is gone when it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
    procs = [ctx.Process(target=_child, args=(fn, r, world_size, os.path.join(tmp, "rdzv"),
                                              backend, timeout_s, args, results), daemon=True)
             for r in range(world_size)]
    out = {}
    deadline = datetime.datetime.now() + _timeout(timeout_s)
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died without reporting (a crash, a kill)
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"spawn_local: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}") from None
                if datetime.datetime.now() > deadline:
                    raise RuntimeError(f"spawn_local: ranks still running after {timeout_s} s")
                continue
            if not ok:  # the peers may wait in a collective: stop them (finally)
                raise RuntimeError(f"spawn_local: rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=30)
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
