"""The dry run's layouts against the reference's (``launch/specs.py``,
``distributed/sharding.py``, ``models/common.py``, ``cache_axes``).

* ``build_spec`` / ``tree_specs`` and the rule tables: the cases of
  ``tests/test_sharding.py`` and seeded random shapes x axes x tables x
  mesh sizes, both sides given the same object with ``.shape``;
* ``abstract_params``, ``param_axes``, ``cast_specs``, ``cache_axes`` and
  the abstract cache of all ten archs, leaf for leaf;
* every SMOKE arch x shape cell on the reference test's mini meshes
  (``make_train_mesh(2, size=4)``, ``make_production_mesh(size=4)``): the
  port's placements read back as ``PartitionSpec`` entries, and the
  per-device bytes of each argument, equal the reference's ``build_cell``
  (run without a compile, 16 forced host devices) leaf for leaf.  Both
  sides run in subprocesses, the port's on a 16-rank fake world.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import abstract_params as j_abstract, get_model as jget_model
from repro.models import param_axes as j_axes
from repro.models.common import cast_specs as j_cast
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.models import (abstract_params, cast_specs, get_model, init_params, param_axes,
                                tree_leaves)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = list(configs.ARCH_IDS)


def _mesh(**sizes):
    return SimpleNamespace(shape=dict(sizes))


def _ref_spec(shape, axes, rules, mesh):
    return tuple(jshd.build_spec(shape, axes, rules, mesh))


@pytest.mark.parametrize("shape, axes, rules, sizes, want", [
    ((16, 8), ("embed", "heads"), {"embed": "data", "heads": "model"}, dict(data=1, model=1),
     ("data", "model")),
    ((16, 8), ("embed", "mlp"), {"embed": "model", "mlp": "model"}, dict(data=1, model=1),
     (None, "model")),
    ((4, 128, 8, 64), ("batch", "kvseq", "kv_heads", None),
     {"batch": "data", "kvseq": "model", "kv_heads": "model"}, dict(data=1, model=1),
     ("data", None, "model", None)),
    ((32,), ("embed",), {"embed": ("pod", "data")}, dict(pod=1, data=1, model=1),
     (("pod", "data"),)),
    ((7,), ("heads",), {"heads": "model"}, dict(data=1, model=2), (None,)),
])
def test_build_spec_cases(shape, axes, rules, sizes, want):
    """The spec cases of the reference's ``tests/test_sharding.py``."""
    mesh = _mesh(**sizes)
    assert shd.build_spec(shape, axes, rules, mesh) == want == _ref_spec(shape, axes, rules, mesh)


_TABLES = ("train", "center", "serve", "serve_fsdp", "batch", "serve_batch", "fsdp2d", "dp")


def _tables(mod, mesh, pure_dp):
    return {
        "train": mod.train_param_rules(mesh, pure_dp),
        "center": mod.center_rules(mesh, pure_dp),
        "serve": mod.serve_param_rules(mesh, pure_dp=pure_dp),
        "serve_fsdp": mod.serve_param_rules(mesh, fsdp=True, pure_dp=pure_dp),
        "batch": mod.batch_rules(mesh, pure_dp),
        "serve_batch": mod.serve_batch_rules(mesh),
        "fsdp2d": mod.train_param_rules(mesh, style="fsdp2d"),
        "dp": mod.batch_rules(mesh, style="dp"),
    }


@pytest.mark.parametrize("seed", range(4))
def test_rule_tables_and_specs_match_reference_random(seed):
    """Seeded random shapes x logical axes x every rule table x mesh sizes:
    the tables and the resolved specs equal the reference's."""
    rng = np.random.default_rng(seed)
    names = list(shd._PRIORITY) + [None, "other"]
    for _ in range(60):
        axes_names = ("pod", "chain", "data", "model")
        present = [a for a in axes_names if rng.random() < 0.7] or ["data"]
        mesh = _mesh(**{a: int(rng.choice([1, 2, 3, 4, 8, 16])) for a in present})
        pure_dp = bool(rng.random() < 0.3)
        port, ref = _tables(shd, mesh, pure_dp), _tables(jshd, mesh, pure_dp)
        assert port == ref
        for name in _TABLES:
            for _ in range(5):
                nd = int(rng.integers(0, 5))
                shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64]))
                              for _ in range(nd))
                axes = tuple(names[int(i)] for i in rng.integers(0, len(names), nd))
                assert (shd.build_spec(shape, axes, port[name], mesh)
                        == _ref_spec(shape, axes, ref[name], mesh)), (shape, axes, name)


def test_tree_specs_match_reference():
    cfg, jcfg = configs.get_config("gemma3-27b", smoke=True), jconfigs.get_config(
        "gemma3-27b", smoke=True)
    mesh = _mesh(data=4, model=4)
    specs, jspecs = get_model(cfg).param_specs(cfg), jget_model(jcfg).param_specs(jcfg)
    got = shd.tree_specs(param_axes(specs), abstract_params(specs),
                         shd.serve_param_rules(mesh, fsdp=True), mesh)
    want = jshd.tree_specs(j_axes(jspecs), j_abstract(jspecs),
                           jshd.serve_param_rules(mesh, fsdp=True), mesh)
    want = jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert got == want


def test_spec_placements_nest_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert shd.spec_placements((("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert shd.spec_placements((None,), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        shd.spec_placements((("data", "pod"),), mesh)


def _dtype(x):
    return str(x).replace("torch.", "")


def _sds(tree):
    return jax.tree.map(lambda s: (tuple(s.shape), _dtype(s.dtype)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_reference(arch):
    """``abstract_params`` (meta tensors), ``param_axes``, ``cast_specs``,
    ``cache_axes`` and ``make_cache(device="meta")`` against the
    reference's trees; ports ``test_arch_smoke.py::
    test_abstract_params_match_init``."""
    cfg, jcfg = configs.get_config(arch, smoke=True), jconfigs.get_config(arch, smoke=True)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    specs, jspecs = model.param_specs(cfg), jmodel.param_specs(jcfg)
    absp = abstract_params(specs)
    assert all(t.device.type == "meta" for t in tree_leaves(absp))
    port = jax.tree.map(lambda t: (tuple(t.shape), _dtype(t.dtype)), absp)
    assert port == _sds(j_abstract(jspecs))
    assert param_axes(specs) == j_axes(jspecs)
    bf = jax.tree.map(lambda t: (tuple(t.shape), _dtype(t.dtype)),
                      abstract_params(cast_specs(specs, torch.bfloat16)))
    assert bf == _sds(j_abstract(j_cast(jspecs, jnp.bfloat16)))
    assert model.cache_axes(cfg) == jmodel.cache_axes(jcfg)
    cache = model.make_cache(cfg, 2, 16, torch.bfloat16, device="meta")
    jcache = jmodel.make_cache(jcfg, 2, 16, jnp.bfloat16, abstract=True)
    assert jax.tree.map(lambda t: (tuple(t.shape), _dtype(t.dtype)), cache) == _sds(jcache)
    # the init materialises what the abstract tree describes
    real = jax.tree.map(lambda t: (tuple(t.shape), _dtype(t.dtype)),
                        init_params(specs, torch.Generator().manual_seed(0), "cpu"))
    assert real == port


_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import json, sys
import jax
from repro.launch.specs import build_cell
from repro.launch import mesh as mesh_lib
import repro.configs as configs
sys.path.insert(0, sys.argv[1])
from torch_dryrun_workers import SMOKE_SHAPES
for name, (kind, seq, batch) in SMOKE_SHAPES.items():
    configs.SHAPES[name] = configs.ShapeCell(name, kind, seq, batch)

def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)

out = {}
for arch in configs.ARCH_IDS:
    for c in configs.cells(arch):
        kind = c.kind
        mesh = (mesh_lib.make_train_mesh(2, size=4) if kind == "train"
                else mesh_lib.make_production_mesh(size=4))
        cell = build_cell(arch, c.name, mesh, smoke=True, num_chains=2 if kind == "train" else None)
        leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
        shards = jax.tree_util.tree_flatten_with_path(
            cell.in_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
        rec = {}
        for (p, a), (q, s) in zip(leaves, shards):
            path = "/".join(key(k) for k in p)
            spec = [list(e) if isinstance(e, tuple) else e for e in s.spec]
            spec += [None] * (len(a.shape) - len(spec))
            n = 1
            for d in s.shard_shape(a.shape):
                n *= d
            rec[path] = [spec, n * a.dtype.itemsize]
        out[f"{arch}/{c.name}"] = rec
print("RESULT:" + json.dumps(out))
"""

_PORT_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch_dryrun_workers import narrow_shapes
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.launch.specs import build_cell
narrow_shapes()
dryrun.start_fake_world(16)

def flat(tree, pl, path, out):
    if isinstance(tree, torch.Tensor):
        if pl is not None:
            out[path] = (tree, pl)
    elif isinstance(tree, dict):
        for k in tree:
            flat(tree[k], pl[k], f"{path}/{k}" if path else str(k), out)
    elif isinstance(tree, tuple):
        names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        for n, v, p in zip(names, tree, pl):
            flat(v, p, f"{path}/{n}" if path else str(n), out)

out = {}
for arch in configs.ARCH_IDS:
    for c in configs.cells(arch):
        mesh = (mesh_lib.make_train_mesh(2, size=4) if c.kind == "train"
                else mesh_lib.make_production_mesh(size=4))
        cell = build_cell(arch, c.name, mesh, smoke=True,
                          num_chains=2 if c.kind == "train" else None)
        leaves = {}
        flat(cell.args, cell.in_shardings, "", leaves)
        rec = {}
        for path, (a, pl) in leaves.items():
            spec = []
            for d in range(a.ndim):
                ax = [mesh.mesh_dim_names[i] for i, p in enumerate(pl)
                      if p.is_shard() and p.dim == d]
                spec.append(None if not ax else ax[0] if len(ax) == 1 else ax)
            n = 1
            for d in shd.local_shape(a.shape, pl, mesh):
                n *= d
            rec[path] = [spec, n * a.element_size()]
        out[f"{arch}/{c.name}"] = rec
meshes = {}
for name, fn in (("train2", lambda: mesh_lib.make_train_mesh(2, size=4)),
                 ("train1_tp2", lambda: mesh_lib.make_train_mesh(1, size=4, tp=2)),
                 ("prod", lambda: mesh_lib.make_production_mesh(size=4)),
                 ("serve_tp8", lambda: mesh_lib.make_serve_mesh(size=4, tp=8)),
                 ("serve", lambda: mesh_lib.make_serve_mesh(size=4))):
    m = fn()
    meshes[name] = [list(m.mesh_dim_names), list(m.shape), mesh_lib.total_chains(m, 3)]
for bad in (lambda: mesh_lib.make_production_mesh(size=2),
            lambda: mesh_lib.make_train_mesh(2, multi_pod=True, size=4)):
    try:
        bad()
        meshes.setdefault("unrefused", 0)
    except ValueError:
        meshes["refused"] = meshes.get("refused", 0) + 1
dryrun.start_fake_world(32)
m = mesh_lib.make_train_mesh(2, multi_pod=True, size=4)
meshes["train2_pod"] = [list(m.mesh_dim_names), list(m.shape), mesh_lib.total_chains(m, 3)]
out["_meshes"] = meshes
print("RESULT:" + json.dumps(out))
"""


def _run_both():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(ROOT / "tests")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(ROOT))
             for script in (_REF_SCRIPT, _PORT_SCRIPT)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, se[-3000:]
        line = [ln for ln in so.splitlines() if ln.startswith("RESULT:")][0]
        outs.append(json.loads(line[len("RESULT:"):]))
    return outs


@pytest.fixture(scope="module")
def layouts():
    return _run_both()


def port_arg_bytes(rec: dict) -> int:
    """A cell's per-device argument bytes from its per-leaf layout."""
    return sum(b for _, b in rec.values())


def test_slice_meshes(layouts):
    """The reference's slice meshes' shapes, axis names and chain counts,
    as ``DeviceMesh``es over the default group; a mesh whose size is not
    the world's is refused."""
    m = layouts[1]["_meshes"]
    assert m["train2"] == [["chain", "data", "model"], [2, 2, 4], 3]
    assert m["train1_tp2"] == [["chain", "data", "model"], [1, 8, 2], 3]
    assert m["prod"] == m["serve"] == [["data", "model"], [4, 4], 3]
    assert m["serve_tp8"] == [["data", "model"], [2, 8], 3]
    assert m["train2_pod"] == [["pod", "chain", "data", "model"], [2, 2, 2, 4], 6]
    assert m["refused"] == 2 and "unrefused" not in m


def test_cell_layouts_match_reference(layouts):
    """Every SMOKE arch x shape: each argument's spec and per-device bytes
    equal the reference's; the reference's extra leaves are its step
    counter and PRNG key, which the port keeps on the host."""
    ref, port = layouts
    port = {k: v for k, v in port.items() if not k.startswith("_")}
    assert set(ref) == set(port) == {f"{a}/{c.name}" for a in ARCHS for c in configs.cells(a)}
    for cell in ref:
        r, p = ref[cell], port[cell]
        extra = set(r) - set(p)
        assert all(k.endswith("/step") or k == "3" for k in extra), (cell, extra)
        assert not set(p) - set(r), (cell, set(p) - set(r))
        for leaf in p:
            assert p[leaf] == r[leaf], (cell, leaf, p[leaf], r[leaf])
        assert port_arg_bytes(p) == sum(r[k][1] for k in p)
