"""The port's mesh-sharded ServeEngine on the CPU: ``ServeEngine(mesh=
make_engine_mesh(m, s))`` over gloo process groups of W = 1, 2 and 4 ranks.

The mirror of the reference's ``TestShardedServeEngine``
(``tests/test_sharding.py:298-405``) and ``TestShardedPagedServeEngine``
(``tests/test_paged_cache.py:539-570``), with the collectives read from
the counter (eager torch has no compiled program to count).  The ranks
are spawned once per world size for the whole module
(``torch_serve_workers.serve_checks``) and every test reads their output.
Members are the reference's stub ensemble and SMOKE qwen3-0.6b drawn by
the reference's ``init_params``.

* Tokens on meshes (1, 1), (2, 1), (1, 2) and (2, 2), greedy and
  T = 0.7/top-k 50, equal the port's unsharded engine's on every rank, and
  the reference's unsharded engine's (greedy, and the stub sampled: its
  one-hot mixture leaves the Gumbel draw no say; the reference draws
  threefry noise that the port does not reproduce, ROADMAP "RNG").
  Log-probs are bitwise the unsharded engine's where only members are
  split, within the engine tolerance where slots are.
* The paged engine on (2, 1), K = 3 on a member axis of 2 (replicated).
* Exactly one member all-gather per admit, one member and one slot
  all-gather per tick, by payload bytes, and none between.
* Live refresh on (2, 1): the same promotions at the same ticks on every
  rank, each rank's members the unsharded run's block, nothing stalled.
* ``leading_axes_specs`` against the reference's rule, ``make_engine_mesh``'s
  errors, and the refresher's spare-device rule.
"""
from __future__ import annotations

import concurrent.futures
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_parity as tp
import torch_serve_workers as w
from repro import configs as jconfigs
from repro.distributed.sharding import leading_axes_specs as jleading_axes_specs
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import synthetic_trace as jsynthetic_trace
from repro.serve.engine.scheduler import Request as JRequest
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch import _interop
from repro_torch.distributed import leading_axes_specs
from repro_torch.launch.mesh import spawn_local
from repro_torch.serve.engine import Request, synthetic_trace
from repro_torch.serve.engine import refresh as refresh_mod

WORLDS = (1, 2, 4)
MESHES = [mesh for W in WORLDS for mesh in w.MESHES[W]]
TRACE_KW = dict(prompt_lens=(5, 8), max_new=4, mean_interarrival=1.0, seed=5)


def _trace(make, vocab):
    return make(6, vocab_size=vocab, **TRACE_KW)


def _paged_prompts():
    """Ragged prompts; request 3 repeats request 1's 9 tokens (two shared
    blocks of 4)."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in (5, 9, 7, 9, 6)]
    prompts[3] = prompts[1].copy()
    return prompts


def _reqs(cls, prompts, max_new=5):
    return [cls(rid=i, prompt=p.copy(), max_new=max_new, arrival_step=i)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def ctx():
    jcfg = jconfigs.get_config("qwen3-0.6b", smoke=True)
    jmodel = jget_model(jcfg)
    # tp.member_setup's members, drawn one by one (vmap's compile costs more)
    draws = [jax.tree.map(np.asarray, jinit_params(jmodel.param_specs(jcfg), kk))
             for kk in jax.random.split(jax.random.PRNGKey(7), 4)]
    jmembers = jax.tree.map(lambda *x: np.stack(x), *draws)
    data = {
        "smoke_cfg": _interop.config_from(jcfg),
        "smoke_members": jmembers,
        "traces": {"stub": _trace(synthetic_trace, w.STUB_VOCAB),
                   "smoke": _trace(synthetic_trace, 512)},
        "paged_trace": _reqs(Request, _paged_prompts()),
        "refresh_trace": [Request(rid=i, prompt=np.arange(1, 3 + i % 3, dtype=np.int32),
                                  max_new=8, arrival_step=i) for i in range(8)],
    }
    # the worlds run in their own processes while this one runs the
    # reference's engines
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    spawned = {W: pool.submit(spawn_local, w.serve_checks, W, data, timeout_s=240)
               for W in WORLDS}
    base = w.unsharded(data)
    # the reference's unsharded engine on the same members and requests
    from test_serve_engine import STUB_CFG, stub_members, stub_model

    def jrun(cfg_, model_, members_, reqs, **kw):
        rep = JServeEngine(cfg_, model_, members_, num_slots=w.NUM_SLOTS, max_seq=w.MAX_SEQ,
                           **kw).run(reqs)
        return {r.rid: np.asarray(r.tokens).tolist() for r in rep.results}

    stub_trace = lambda: _trace(jsynthetic_trace, w.STUB_VOCAB)  # noqa: E731
    ref = {
        ("stub", False): jrun(STUB_CFG, stub_model(), stub_members(4), stub_trace()),
        ("stub", True): jrun(STUB_CFG, stub_model(), stub_members(4), stub_trace(),
                             sampling=JSamplingParams(temperature=0.7, top_k=50), seed=3),
        ("stub3", False): jrun(STUB_CFG, stub_model(), stub_members(3), stub_trace()),
        ("smoke", False): jrun(jcfg, jmodel, jmembers, _trace(jsynthetic_trace, 512)),
        ("smoke-paged", False): jrun(jcfg, jmodel, jmembers, _reqs(JRequest, _paged_prompts()),
                                     paged=True, block_size=4),
    }
    ranks = {W: f.result() for W, f in spawned.items()}
    pool.shutdown()
    return SimpleNamespace(ranks=ranks, base=base, ref=ref)


def _world(mesh):
    return mesh[0] * mesh[1]


def _tokens(res):
    return {rid: r["tokens"] for rid, r in res["results"].items()}


def _check_run(ctx, mesh, name, sampled, bitwise):
    base = ctx.base[(name, sampled)]
    for out in ctx.ranks[_world(mesh)]:
        got = out["runs"][mesh + (name, sampled)]
        assert _tokens(got) == _tokens(base), (mesh, name, sampled, out["rank"])
        if (name, sampled) in ctx.ref:
            assert _tokens(got) == ctx.ref[(name, sampled)], (mesh, name, sampled)
        for rid, r in got["results"].items():
            want = base["results"][rid]["logprobs"]
            if bitwise:
                np.testing.assert_array_equal(r["logprobs"], want, err_msg=f"rid {rid}")
            else:
                rtol = tp.SCALE_RTOL if name == "smoke" else 0.0
                tp.assert_close(r["logprobs"], want, scale_rtol=rtol, what=f"rid {rid}")


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("name", ["stub", "smoke"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tokens_match_unsharded_engines(ctx, mesh, name, sampled):
    _check_run(ctx, mesh, name, sampled, bitwise=mesh[1] == 1)
    # the slot all-gather hands every rank the same emissions and rows
    runs = [out["runs"][mesh + (name, sampled)]["results"] for out in ctx.ranks[_world(mesh)]]
    for other in runs[1:]:
        for rid, r in other.items():
            assert r["tokens"] == runs[0][rid]["tokens"]
            np.testing.assert_array_equal(r["logprobs"], runs[0][rid]["logprobs"])


def test_paged_engine_on_member_mesh(ctx):
    _check_run(ctx, (2, 1), "smoke-paged", False, bitwise=True)
    for out in ctx.ranks[2]:
        res = out["runs"][(2, 1, "smoke-paged", False)]
        assert res["alloc_checked"] and res["k_local"] == 2 and res["slots"] == (0, w.NUM_SLOTS)


def test_indivisible_member_axis_replicates(ctx):
    _check_run(ctx, (2, 1), "stub3", False, bitwise=True)
    for out in ctx.ranks[2]:
        assert out["runs"][(2, 1, "stub3", False)]["k_local"] == 3


def _expected(mesh, paged, vocab=512, K=4, S=w.NUM_SLOTS):
    """(per admit, per tick) collectives: a member all-gather of the f32
    (K_local, V) / (K_local, S_local, V) logits; the dense engine's slot
    all-gather of S_local rows of 4 int32 columns and the V logp bits."""
    k, s = K // mesh[0], (S if paged else S // mesh[1])
    admit = {"all_gather": {"calls": 1, "bytes": 4 * k * vocab}}
    tick = {"all_gather": {"calls": 1, "bytes": 4 * k * s * vocab}}
    if not paged:
        slot_bytes = 4 * s * (4 + vocab)
        tick["all_gather"] = {"calls": 2, "bytes": tick["all_gather"]["bytes"] + slot_bytes}
    none = {"calls": 0, "bytes": 0}
    return ({"all_reduce": none, **admit}, {"all_reduce": none, **tick},
            {"all_reduce": none, "all_gather": none})


@pytest.mark.parametrize("case", [m + ("smoke",) for m in MESHES] + [(2, 1, "smoke-paged")],
                         ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}")
def test_collectives_per_tick_and_admit(ctx, case):
    mesh, name = case[:2], case[2]
    admit, tick, between = _expected(mesh, paged=name == "smoke-paged")
    for out in ctx.ranks[_world(mesh)]:
        log = out["runs"][case + (False,)]["log"]
        kinds = {k for k, _ in log}
        assert kinds == {"admit", "tick", "between"}, kinds
        for kind, delta in log:
            assert delta == {"admit": admit, "tick": tick, "between": between}[kind], (kind, delta)


def test_live_refresh_on_member_mesh(ctx):
    base = ctx.base["refresh"]
    outs = [out["refresh"] for out in ctx.ranks[2]]
    for rank, rf in enumerate(outs):
        assert rf["promoted"] >= 3
        # the same version at every tick on every rank, and as unsharded
        assert rf["versions"] == base["versions"], rank
        assert rf["final_version"] == base["final_version"] == rf["promoted"]
        assert rf["refresher"]["decode_steps_stalled"] == 0
        # placed once per promotion: at the flip, never again in _members
        assert rf["placed"] == rf["promoted"] and rf["placed_version"] == rf["final_version"]
        assert rf["device"] is None  # no spare card on the CPU
        assert _tokens(rf) == _tokens(base)
        # the rank's block of the unsharded run's final members
        for key, leaf in rf["members"].items():
            np.testing.assert_array_equal(leaf, base["members"][key][2 * rank:2 * rank + 2])


def test_refresh_agreement_keeps_skewed_ranks_in_step(ctx):
    """One rank's verdicts and side stream lag (``refresh_run``'s skew): the
    other rank defers and backs off at the same ticks, so both serve the
    same version at every tick."""
    a, b = (out["refresh_skewed"] for out in ctx.ranks[2])
    assert a["versions"] == b["versions"] and a["final_version"] == b["final_version"] >= 1
    for key in ("flips_deferred", "backpressure_ticks", "micro_chunks", "promotions"):
        assert a["refresher"][key] == b["refresher"][key], key
    assert a["refresher"]["flips_deferred"] > 0 and a["refresher"]["backpressure_ticks"] > 0
    # the lag costs ticks, never the tokens or a stall
    assert _tokens(a) == _tokens(b) == _tokens(ctx.base["refresh"])
    assert a["refresher"]["decode_steps_stalled"] == 0
    for rank, rf in enumerate((a, b)):
        assert rf["placed"] == rf["promoted"]
        assert all(leaf.shape[0] == 2 for leaf in rf["members"].values()), rank


def test_make_engine_mesh_errors_and_defaults(ctx):
    for out in ctx.ranks[2]:
        assert len(out["mesh_errors"]) == 4
        assert all(e and "spans the 2 ranks" in e for e in out["mesh_errors"])
        assert out["default_shape"] == (2, 1)
    assert ctx.ranks[1][0]["default_shape"] == (1, 1)
    assert all(out["default_shape"] == (2, 2) for out in ctx.ranks[4])


SPEC_SHAPES = [(4,), (4, 8), (4, 8, 3), (3, 8), (4, 6, 2), (), (8, 1, 5), (2, 4)]


@pytest.mark.parametrize("mesh_shape", [{"member": 2, "slot": 4}, {"member": 4, "slot": 1},
                                        {"member": 8, "slot": 1}, {"slot": 2}],
                         ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("axes", [("member", "slot"), ("member",), ("slot",), (None, "slot"),
                                  ("member", "absent")])
def test_leading_axes_specs_match_reference(mesh_shape, axes):
    jmesh = SimpleNamespace(shape=mesh_shape)  # the reference reads only mesh.shape
    mesh = SimpleNamespace(mesh_dim_names=tuple(mesh_shape), shape=tuple(mesh_shape.values()))
    tree = {f"x{i}": np.zeros(s, np.float32) for i, s in enumerate(SPEC_SHAPES)}
    want = jleading_axes_specs(tree, axes, jmesh)
    got = leading_axes_specs({k: torch.zeros(v.shape) for k, v in tree.items()}, axes, mesh)
    for key in tree:
        assert isinstance(want[key], PartitionSpec)
        assert got[key] == tuple(want[key]), (key, got[key], want[key])


def test_spare_device_rule(monkeypatch):
    assert refresh_mod._spare_device([0, 1], 4) == 3
    assert refresh_mod._spare_device([3, 1], 4) == 2
    assert refresh_mod._spare_device([0, 1, 2, 3], 4) is None
    assert refresh_mod._spare_device([0, 0], 1) is None
    # under a mesh the ranks' serving devices are gathered on the host
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    gathered = []
    monkeypatch.setattr(refresh_mod.collectives, "all_gather",
                        lambda x, ax: gathered.append(x) or torch.tensor([[1], [2]]))
    eng = SimpleNamespace(device=torch.device("cuda", 1), host=object())
    assert refresh_mod._pick_device(eng, "auto") == torch.device("cuda", 3)
    assert gathered[0].tolist() == [1]
    monkeypatch.setattr(refresh_mod.collectives, "all_gather",
                        lambda x, ax: torch.tensor([[0], [1], [2], [3]]))
    assert refresh_mod._pick_device(eng, "auto") is None
    assert refresh_mod._pick_device(SimpleNamespace(device=torch.device("cpu"), host=object()),
                                    "auto") is None
