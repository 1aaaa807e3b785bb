"""Multi-pod dry run: each (architecture x input shape) cell traced on the
reference's 256/512-device meshes with no device memory.

The reference lowers and compiles each cell against abstract inputs and
reads XLA's memory and cost analyses.  Torch has no lowering; its
counterpart here is a fake world of ``mesh.size`` ranks (a ``fake``
process group: collectives return at once and move nothing), the cell's
arguments placed as DTensors whose blocks are fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage), and the step
run once.  One dispatch mode (``_Tracker``) sees every op on each rank's
blocks and records:

* ``memory_analysis`` — per device: ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, the bytes of the blocks (each storage once),
  and ``temp_size_in_bytes``, the peak of the live bytes (each storage
  from its first op until it is freed, rounded up to 512 bytes as the CUDA
  caching allocator rounds) minus the arguments' live bytes.
  ``peak_bytes`` is that peak, and
  ``fits`` says whether it fits the 80 GB of ``roofline.HW``'s card;
* ``cost_analysis`` — ``flops`` per device: the formulas of
  ``torch.utils.flop_counter`` (``flop_registry``) on each rank's local ops
  (``FlopCounterMode`` on a DTensor program counts the global shapes);
* ``collectives`` — count and bytes per device (the operands' blocks) of
  each family under the reference's names, both the collectives DTensor
  inserts and those the port issues itself, whose own count (the EC
  sync's chain mean) is also kept as ``port_collectives``
  (``distributed.collectives.collective_counts``).  ``CommDebugMode``
  counts the same ops (the tests hold the two counts equal) but gives no
  bytes and slows a trace by a third, so the tracker counts them.

Left out, for want of a counterpart: HLO's ``bytes accessed`` and the rest
of ``cost_analysis`` beyond ``flops``, and ``generated_code_size_in_bytes``
/ ``alias_size_in_bytes`` of ``memory_analysis``.  ``lower_s`` is the time
to build the cell and place its arguments, ``compile_s`` the time of the
traced step.

No kernel launches under the dry run: the kernels' wrappers route fake
tensors to their ``torch.library`` forms, whose fake implementations give
the output shapes.  Nothing happens at import; ``main`` starts the fake
world.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import build_cell
from repro_torch.models.common import map_tensors
from repro_torch.obs import get_logger

log = get_logger("dryrun")

# op names (functional collectives and c10d's) -> the reference's family names
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
        "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
ALLOC_ROUND = 512  # the CUDA caching allocator's block granularity
CARD_HBM_BYTES = 80e9  # roofline.HW's card, H100 80GB HBM3


def _rounded(n: int) -> int:
    return -(-int(n) // ALLOC_ROUND) * ALLOC_ROUND


# DTensor works out an op's output shape by running the op once on fake
# tensors of the GLOBAL shapes; under the dry run's own FakeTensorMode those
# ops reach the tracker, but they allocate and compute nothing on a card
_META_FRAMES = ("_propagate_tensor_meta_non_cached", "gen_fake_args")


def _in_meta_propagation() -> bool:
    f = sys._getframe(2)
    for _ in range(64):
        if f is None:
            return False
        if f.f_code.co_name in _META_FRAMES:
            return True
        f = f.f_back
    return False


def _tensors(tree) -> list:
    out = []
    map_tensors(lambda t: out.append(t), tree)
    return out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class _Tracker(TorchDispatchMode):
    """Live bytes, FLOPs and collectives of the ops on each rank's blocks.
    A DTensor op is handed back (``NotImplemented``) so that DTensor
    desugars it into local ops and collectives, which come through here."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.flops = 0
        self.collectives: dict = {}
        self._sizes: dict = {}

    def track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = _rounded(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_meta_propagation():
            return out
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        family = _COLLECTIVE_OPS.get(getattr(packet, "__name__", ""))
        if family is not None:
            nbytes = sum(t.numel() * t.element_size() for t in _flat_tensors(args))
            e = self.collectives.setdefault(family, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += int(nbytes)
        for t in _flat_tensors(out):
            self.track(t)
        return out


def _flat_tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def start_fake_world(world_size: int) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0 (its
    collectives move nothing), in place of a fake group of another size;
    refuses to replace a real one.  Meshes are built over it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is already running")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _mesh_for(cell_kind: str, arch: str, multi_pod: bool, num_chains=None, size: int = 16):
    if cell_kind == "train":
        k = num_chains if num_chains is not None else configs.EC_CHAINS[arch]
        return mesh_lib.make_train_mesh(k, multi_pod=multi_pod, size=size)
    return mesh_lib.make_production_mesh(multi_pod=multi_pod, size=size)


def device() -> str:
    """The device the fake blocks are made on: the card where there is one
    (the card's code paths), else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def trace_cell(cell) -> dict:
    """Run ``cell.fn`` once on fake DTensor arguments and return the
    per-device record (memory, FLOPs, collectives, timings)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import collectives as port_coll
    from repro_torch.distributed import sharding as shd

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=False):
        args = shd.empty_tree(cell.args, cell.in_shardings, cell.mesh, device())
        arg_blocks = {t.untyped_storage()._cdata: t for t in map(_local, _tensors(args))}
        arg_bytes = sum(t.untyped_storage().nbytes() for t in arg_blocks.values())
        tracker = _Tracker()
        for t in arg_blocks.values():
            tracker.track(t)
        arg_live = tracker.live
        t_place = time.time() - t0
        port_coll.reset_collective_counts()
        with tracker, implicit_replication():
            out = cell.fn(*args)
        port = port_coll.collective_counts()
        t_trace = time.time() - t0 - t_place
        out_blocks = {t.untyped_storage()._cdata: t for t in map(_local, _tensors(out))}
        out_bytes = sum(t.untyped_storage().nbytes() for t in out_blocks.values())
    return {
        "memory_analysis": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(tracker.peak - arg_live),
        },
        "peak_bytes": int(tracker.peak),
        "cost_analysis": {"flops": float(tracker.flops)},
        "collectives": tracker.collectives,
        "collective_bytes_per_device": sum(v["bytes"] for v in tracker.collectives.values()),
        "port_collectives": port,
        "lower_s": round(t_place, 2),
        "compile_s": round(t_trace, 2),
    }


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: Path | None = None,
    num_chains=None,
    sync_every: int = 4,
    overrides: dict | None = None,
    tag: str = "",
    size: int = 16,
    **cell_kw,
) -> dict:
    """Dry-run one cell on the (pod,) data x model mesh of ``size`` x
    ``size`` ranks per pod; the fake world must have that many ranks
    (``start_fake_world``).  Writes the record under ``out_dir``."""
    from repro_torch.roofline import HW

    kind = configs.SHAPES[shape_name].kind
    mesh = _mesh_for(kind, arch, multi_pod, num_chains, size)
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, num_chains=num_chains, sync_every=sync_every,
                      overrides=overrides, **cell_kw)
    t_build = time.time() - t0
    rec = trace_cell(cell)
    rec["lower_s"] = round(rec["lower_s"] + t_build, 2)
    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": kind,
        "mesh": dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape))),
        "devices": int(mesh.size()),
        "multi_pod": multi_pod,
        "num_chains": cell.num_chains,
        "sync_every": sync_every,
        "tag": tag,
        "model_flops": cell.model_flops,
        "meta": {**cell.meta, "device": device(), "torch": torch.__version__},
        **rec,
        "card": HW["card"],
        "fits": rec["peak_bytes"] <= CARD_HBM_BYTES,
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        mesh_tag = "pod2" if multi_pod else "pod1"
        suffix = f"__{tag}" if tag else ""
        path = out_dir / f"{arch}__{shape_name}__{mesh_tag}{suffix}.json"
        path.write_text(json.dumps(record, indent=1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        pods = [False, True] if args.both_meshes else [args.multi_pod]
        todo = [(a, c.name, mp) for (a, c) in configs.all_cells() for mp in pods]
        if args.arch:
            todo = [t for t in todo if t[0] == args.arch]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        pods = [False, True] if args.both_meshes else [args.multi_pod]
        todo = [(args.arch, args.shape, mp) for mp in pods]

    failures = []
    for arch, shape, mp in todo:
        start_fake_world(512 if mp else 256)
        label = f"{arch} x {shape} x {'2-pod(512)' if mp else '1-pod(256)'}"
        try:
            rec = run_cell(arch, shape, mp, out_dir, args.chains, args.sync_every, tag=args.tag)
            ma = rec["memory_analysis"]
            log.info(f"[ok] {label}: trace={rec['compile_s']}s "
                     f"flops/dev={rec['cost_analysis']['flops']:.3e} "
                     f"coll_B/dev={rec['collective_bytes_per_device']:.3e} "
                     f"args/dev={ma['argument_size_in_bytes']} peak/dev={rec['peak_bytes']} "
                     f"fits={rec['fits']}")
        except Exception as e:
            failures.append((label, repr(e)))
            log.error(f"[FAIL] {label}: {e!r}")
            traceback.print_exc()
    if failures:
        log.error(f"{len(failures)} cell(s) FAILED:")
        for label, e in failures:
            log.error(f"  {label}: {e}")
        sys.exit(1)
    log.info(f"all {len(todo)} cells traced OK")


if __name__ == "__main__":
    main()
