"""Checkpointing of the port (``repro_torch.train.checkpoint`` and the
loop's auto-resume), mirroring ``tests/test_checkpoint.py``, plus the
file format against the reference: a checkpoint written by either package
restores in the other bit for bit, with identical manifests and leaf keys,
and ``restore`` puts each leaf on the template's device."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.train import checkpoint as jck
from repro_torch import _interop, core
from repro_torch.core import rng
from repro_torch.models import tree_leaves
from repro_torch.train import checkpoint as ck
from repro_torch.train.loop import LoopConfig, Preempted, run


def _tiny_setup(num_chains=2):
    params = torch.randn(num_chains, 8, generator=torch.Generator().manual_seed(0))
    sampler = core.ec_sghmc(step_size=1e-2, alpha=1.0, sync_every=2)
    state = sampler.init(params)
    return params, sampler, state


def _tree_setup():
    """A nested params dict and an EC-SGHMC state after two steps (so its
    center fields differ)."""
    g = np.random.default_rng(1)
    np_params = {"embed": g.normal(size=(2, 6, 4)).astype(np.float32),
                 "layers": {"w": g.normal(size=(2, 3, 5)).astype(np.float32),
                            "b": g.normal(size=(2, 5)).astype(np.float32)}}
    params = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()}) for k, v in np_params.items()}
    samp = core.ec_sghmc(step_size=1e-2, sync_every=1)
    state = samp.init(params)
    for t in range(2):
        grads = {k: (v - 1.0 if not isinstance(v, dict) else {kk: vv - 1.0 for kk, vv in v.items()})
                 for k, v in params.items()}
        upd, state = samp.update(grads, state, params, rng.key(t))
        params = core.apply_updates(params, upd)
    return params, state


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _equal_states(a, b):
    assert type(a) is type(b) and a.step == b.step
    for f in a._fields[:-1]:
        _equal_trees(getattr(a, f), getattr(b, f))


class TestCheckpointRoundtrip:
    def test_save_restore_exact(self, tmp_path):
        params, sampler, state = _tiny_setup()
        ck.save(tmp_path, 7, params, state)
        got = ck.restore(tmp_path, params, state)
        assert got is not None
        step, p2, s2, _ = got
        assert step == 7 and torch.equal(p2, params) and torch.equal(s2.center, state.center)
        tree_params, tree_state = _tree_setup()
        bf = dict(tree_params, embed=tree_params["embed"].to(torch.bfloat16))
        ck.save(tmp_path / "tree", 2, bf, tree_state)
        step, p3, s3, _ = ck.restore(tmp_path / "tree", bf, tree_state)
        assert step == 2 and p3["embed"].dtype == torch.bfloat16
        _equal_trees(p3, bf)
        _equal_states(s3, tree_state)
        assert isinstance(s3.step, int)

    def test_atomic_no_tmp_left(self, tmp_path):
        params, sampler, state = _tiny_setup()
        ck.save(tmp_path, 1, params, state)
        assert not any(p.name.startswith("tmp.") for p in tmp_path.iterdir())

    def test_corrupted_falls_back(self, tmp_path):
        params, sampler, state = _tiny_setup()
        ck.save(tmp_path, 1, params, state)
        ck.save(tmp_path, 2, params, state)
        newest = sorted(tmp_path.glob("step_*"))[-1]
        (newest / "arrays.npz").write_bytes(b"garbage")
        got = ck.restore(tmp_path, params, state)
        assert got is not None and got[0] == 1

    def test_manifest_shape_mismatch_detected(self, tmp_path):
        params, sampler, state = _tiny_setup()
        path = ck.save(tmp_path, 3, params, state)
        m = json.loads((path / "manifest.json").read_text())
        k = next(iter(m["shapes"]))
        m["shapes"][k] = [999]
        (path / "manifest.json").write_text(json.dumps(m))
        assert ck.restore(tmp_path, params, state) is None

    def test_prune_keeps_latest(self, tmp_path):
        params, sampler, state = _tiny_setup()
        for s in range(1, 6):
            ck.save(tmp_path, s, params, state)
        ck.prune(tmp_path, keep=2)
        names = sorted(p.name for p in tmp_path.glob("step_*"))
        assert names == ["step_00000004", "step_00000005"]


class TestElasticRescale:
    def test_restore_with_different_chain_count(self, tmp_path):
        params, sampler, state = _tiny_setup(num_chains=2)
        ck.save(tmp_path, 5, params, state)
        p4 = torch.zeros(4, 8)
        s4 = core.ec_sghmc(step_size=1e-2, alpha=1.0).init(p4)
        got = ck.restore_elastic(tmp_path, p4, s4, num_chains=4, alpha=1.0)
        assert got is not None
        step, new_p, new_s, extra = got
        assert step == 5 and new_p.shape == (4, 8) and new_s.step == 5
        assert extra.get("elastic_resample")
        assert torch.equal(new_s.center, state.center)
        assert torch.equal(new_s.center_momentum, torch.zeros(8))

    def test_dead_chain_recovery_math(self):
        params, sampler, state = _tiny_setup(num_chains=2)
        new_p, new_s = core.resample_chain_from_center(state, alpha=2.0, rng=rng.key(1),
                                                       num_chains=8)
        assert new_p.shape == (8, 8) and torch.isfinite(new_p).all()


class TestLoopResume:
    def _run(self, tmp_path, steps, preempt_at=None):
        params, sampler, state = _tiny_setup()

        def train_step(params, state, batch, rng_key):
            g = params - 1.0  # U = ||theta - 1||^2/2
            upd, state = sampler.update(g, state, params, rng_key)
            return core.apply_updates(params, upd), state, {"nll_per_token": torch.mean(g**2)}

        cfg = LoopConfig(num_steps=steps, ckpt_dir=str(tmp_path), ckpt_every=5,
                         log_every=100, preempt_at=preempt_at)
        return run(train_step, params, state, lambda t: None, cfg, num_chains=2)

    def test_preempt_then_resume(self, tmp_path):
        with pytest.raises(Preempted):
            self._run(tmp_path, steps=20, preempt_at=10)
        assert (tmp_path / "step_00000010").exists()
        params, state, _ = self._run(tmp_path, steps=20)
        assert state.step == 20
        # each step's key is folded from the absolute step: the resumed run
        # IS the uninterrupted one
        p_ref, s_ref, _ = self._run(tmp_path / "straight", steps=20)
        assert torch.equal(params, p_ref)
        _equal_states(state, s_ref)

    def test_resume_is_noop_when_done(self, tmp_path):
        self._run(tmp_path, steps=10)
        params, state, _ = self._run(tmp_path, steps=10)
        assert state.step == 10


class TestReferenceFormat:
    def test_keys_match_reference_flatten(self):
        params, state = _tree_setup()
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        for port_state, ref_state in (
            (state, jcore.ec_sghmc(step_size=1e-2).init(jparams)),
            (core.sgld(0.1).init(params), jcore.sgld(0.1).init(jparams)),
            (core.sghmc(0.1).init(params), jcore.sghmc(0.1).init(jparams)),
        ):
            mine = ck._flatten({"params": params, "state": port_state})
            ref, _ = jck._flatten({"params": jparams, "state": ref_state})
            assert list(mine) == list(ref)
            for k in ref:
                assert mine[k].shape == ref[k].shape and mine[k].dtype == ref[k].dtype, k

    def test_reference_checkpoint_restores_in_port(self, tmp_path):
        params, state = _tree_setup()
        np_state = _interop.state_to_numpy(state)
        jstate = jcore.ECSGHMCState(
            **{f: (jnp.asarray(state.step, jnp.int32) if f == "step" else
                   jax.tree.map(jnp.asarray, np_state[f])) for f in state._fields})
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        jck.save(tmp_path / "ref", 6, jparams, jstate)
        ck.save(tmp_path / "port", 6, params, state)
        mr = json.loads((tmp_path / "ref" / "step_00000006" / "manifest.json").read_text())
        mp = json.loads((tmp_path / "port" / "step_00000006" / "manifest.json").read_text())
        assert mr == mp
        tpl_p = {k: (torch.zeros_like(v) if not isinstance(v, dict) else
                     {kk: torch.zeros_like(vv) for kk, vv in v.items()}) for k, v in params.items()}
        tpl_s = core.ec_sghmc(step_size=1e-2).init(tpl_p)
        step, p2, s2, _ = ck.restore(tmp_path / "ref", tpl_p, tpl_s)
        assert step == 6
        _equal_trees(p2, params)
        _equal_states(s2, state)

    def test_port_checkpoint_restores_in_reference(self, tmp_path):
        params, state = _tree_setup()
        ck.save(tmp_path, 4, params, state)
        jparams = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), params)
        jstate = jcore.ec_sghmc(step_size=1e-2).init(jparams)
        step, jp, js, _ = jck.restore(tmp_path, jparams, jstate)
        assert step == 4 and int(js.step) == state.step
        for a, b in zip(tree_leaves(params), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for f in ("momentum", "center", "center_momentum", "center_stale", "mean_theta_stale"):
            for a, b in zip(tree_leaves(getattr(state, f)), jax.tree.leaves(getattr(js, f))):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_reference_bf16_leaf_restores_as_bf16(self, tmp_path):
        """The reference writes a bf16 leaf as raw 2-byte records; the
        port reads them back as the template's bfloat16 bits."""
        bits = np.random.default_rng(2).integers(0, 2**15, size=(2, 5)).astype(np.uint16)
        jp = {"w": jnp.asarray(bits.view(jnp.bfloat16))}
        js = jcore.sgld(0.1).init(jp)
        jck.save(tmp_path, 1, jp, js)
        tpl = {"w": torch.zeros(2, 5, dtype=torch.bfloat16)}
        step, p, s, _ = ck.restore(tmp_path, tpl, core.sgld(0.1).init(tpl))
        assert step == 1 and p["w"].dtype == torch.bfloat16 and s.step == 0
        np.testing.assert_array_equal(p["w"].view(torch.int16).numpy().view(np.uint16), bits)

    def test_restore_places_leaves_on_template_device(self, tmp_path):
        params, sampler, state = _tiny_setup()
        ck.save(tmp_path, 3, params, state)
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        tpl_state = state._replace(**{f: meta(getattr(state, f)) for f in state._fields[:-1]})
        step, p, s, _ = ck.restore(tmp_path, meta(params), tpl_state)
        assert step == 3 and p.device.type == "meta" and s.center.device.type == "meta"
        step, p, s, _ = ck.restore(tmp_path, params, state)
        assert p.device == params.device and torch.equal(p, params)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's [ckpt] phase restores onto the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_restore_onto_the_card(tmp_path, card):
    params, sampler, state = _tiny_setup()
    ck.save(tmp_path, 3, params, state)
    to = lambda t: t.to(card)
    tpl_state = state._replace(**{f: to(getattr(state, f)) for f in state._fields[:-1]})
    step, p, s, _ = ck.restore(tmp_path, to(params), tpl_state)
    assert p.is_cuda and s.center.is_cuda and torch.equal(p.cpu(), params)
