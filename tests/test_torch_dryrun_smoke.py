"""The dry run (``repro_torch.launch.dryrun``), the port of the reference's
``tests/test_dryrun_smoke.py``.

* Every SMOKE arch x shape goes through ``run_cell`` on a 16-rank fake
  world (the reference test's mini meshes, its narrowed shapes), in
  subprocesses: a record with memory, FLOPs and collectives; the train
  cells show the EC sync (one all-reduce of the chain means); the
  per-device argument bytes are the cell's layout's (which the layout
  test holds to the reference's).
* A full-width cell (qwen3-0.6b decode_32k: about 31 GB of arguments per
  rank on 16 ranks) traces in a process whose peak RSS stays small:
  nothing is allocated for real, and no kernel launches.

The cells' execution on real ranks is ``test_torch_dryrun_ranks.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs

ROOT = Path(__file__).resolve().parent.parent
ARCHS = list(configs.ARCH_IDS)
GROUPS = (ARCHS[:5], ARCHS[5:])

_SCRIPT = r"""
import contextlib, json, sys
sys.path.insert(0, sys.argv[1])
from torch.distributed.tensor.debug import CommDebugMode
from torch_dryrun_workers import narrow_shapes
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.specs import build_cell
from repro_torch.kernels import ops

full = sys.argv[2] == "full"
COMM_CHECK = ("qwen3-0.6b", "recurrentgemma-2b", "whisper-base")
if not full:
    narrow_shapes()
dryrun.start_fake_world(16)
out = {}
todo = ([("qwen3-0.6b", "decode_32k")] if full else
        [(a, c.name) for a in sys.argv[2].split(",") for c in configs.cells(a)])
for arch, shape in todo:
    train = configs.SHAPES[shape].kind == "train"
    # CommDebugMode's count beside the tracker's, on some train cells
    check = train and arch in COMM_CHECK
    with CommDebugMode() if check else contextlib.nullcontext() as comm:
        rec = dryrun.run_cell(arch, shape, False, None, 2 if train else None, size=4,
                              smoke=not full)
    if check:
        rec["comm_debug_count"] = int(comm.get_total_counts())
    mesh = dryrun._mesh_for(configs.SHAPES[shape].kind, arch, False, 2 if train else None, 4)
    cell = build_cell(arch, shape, mesh, smoke=not full, num_chains=2 if train else None)
    layout = []
    shd.map_tensors(lambda a, pl: layout.append(
        a.element_size() * __import__("math").prod(shd.local_shape(a.shape, pl, mesh)))
        if pl is not None else None, cell.args, cell.in_shardings)
    rec["layout_arg_bytes"] = sum(layout)
    out[f"{arch}/{shape}"] = rec
# the peak RSS of this process's own memory (getrusage's ru_maxrss would
# also hold the forking parent's, folded in at exec)
hwm = [ln for ln in open("/proc/self/status") if ln.startswith("VmHWM:")][0]
print("RESULT:" + json.dumps({"records": out, "launches": sum(ops.launches.values()),
                              "maxrss_kb": int(hwm.split()[1])}))
"""


@pytest.fixture(scope="module")
def dryruns():
    """{cell: record} of every SMOKE cell, and the full-width run's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = [",".join(g) for g in GROUPS] + ["full"]
    procs = [subprocess.Popen([sys.executable, "-c", _SCRIPT, str(ROOT / "tests"), a],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(ROOT)) for a in argv]
    results = []
    for p in procs:
        so, se = p.communicate(timeout=900)
        assert p.returncode == 0, se[-4000:]
        line = [ln for ln in so.splitlines() if ln.startswith("RESULT:")][0]
        results.append(json.loads(line[len("RESULT:"):]))
    smoke = {k: v for r in results[:-1] for k, v in r["records"].items()}
    return smoke, results[-1], results


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_dryrun_all_shapes(arch, dryruns):
    smoke, _, _ = dryruns
    cells = {c.name for c in configs.cells(arch)}
    assert {k.split("/")[1] for k in smoke if k.startswith(arch + "/")} == cells
    for shape in cells:
        rec = smoke[f"{arch}/{shape}"]
        ma = rec["memory_analysis"]
        assert ma["argument_size_in_bytes"] == rec["layout_arg_bytes"] > 0
        assert ma["temp_size_in_bytes"] >= 0 and rec["peak_bytes"] >= ma["argument_size_in_bytes"]
        assert rec["cost_analysis"]["flops"] > 0 and rec["model_flops"] > 0
        assert rec["devices"] == 16 and rec["fits"]
        if "comm_debug_count" in rec:
            assert rec["comm_debug_count"] == sum(v["count"] for v in rec["collectives"].values())
    train = smoke[f"{arch}/train_4k"]
    # the EC sync: the chain means in ONE all-reduce of the port's collectives
    assert train["num_chains"] == 2 and train["port_collectives"]["all_reduce"]["calls"] == 1
    assert any(k in train["collectives"] for k in ("all-reduce", "reduce-scatter"))


def test_comm_debug_mode_counts_the_same_collectives(dryruns):
    """torch's CommDebugMode, around three train cells, counts what the
    tracker counts."""
    smoke, _, _ = dryruns
    checked = [k for k, r in smoke.items() if "comm_debug_count" in r]
    assert len(checked) == 3


def test_full_width_cell_allocates_nothing(dryruns):
    _, full, results = dryruns
    rec = full["records"]["qwen3-0.6b/decode_32k"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 20e9
    assert full["maxrss_kb"] < 2_000_000, full["maxrss_kb"]
    for r in results:
        assert r["launches"] == 0
