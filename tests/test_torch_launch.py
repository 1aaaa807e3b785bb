"""The port's serve loop and launchers on the CPU.

* ``serve.loop.generate`` against ``repro.serve.loop.generate`` (greedy,
  with and without EOS): the same tokens;
* ``collect_ensemble`` with a noiseless SGLD (temperature 0) against the
  reference's (atol 2e-6, the sampler parity tolerance of the port's
  tests);
* ``launch.serve.main`` at SMOKE size on ``--device cpu``: engine mode with
  sync and overlapped live refresh, and ensemble mode; the bootstrap leaves
  no tensor in a reference cycle;
* ``launch.train.main`` at SMOKE size with ``--ckpt-dir`` and
  ``--preempt-at``: the resumed run ends where the uninterrupted one does,
  bit for bit;
* the audio and vlm families' training batches against the reference's
  keys, shapes and dtypes, a few SMOKE training steps of whisper,
  qwen2-vl and xlstm, and whisper through ``launch.serve.main``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro.models import get_model as jget_model
from repro.models import init_params as jinit_params
from repro.serve.loop import collect_ensemble as jcollect_ensemble
from repro.serve.loop import generate as jgenerate
from repro_torch import _interop, configs, core
from repro_torch.core import rng
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import get_model, tree_leaves, tree_map
from repro_torch.serve.loop import collect_ensemble, generate
from repro_torch.train.loop import Preempted

PREC = 2500.0


@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get_config("qwen3-0.6b", smoke=True)
    jmodel = jget_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(jcfg), jax.random.PRNGKey(21))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = _interop.config_from(jcfg)
    return jcfg, jmodel, np_params, cfg, get_model(cfg)


def test_generate_matches_reference(smoke):
    jcfg, jmodel, np_params, cfg, model = smoke
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(3, 6)).astype(np.int32)
    params = _interop.tree_from_numpy(np_params)
    jparams = jax.tree.map(jnp.asarray, np_params)
    ref = np.asarray(jgenerate(jcfg, jmodel, jparams, {"tokens": jnp.asarray(toks)}, 16, 8))
    got = generate(cfg, model, params, {"tokens": torch.from_numpy(toks)}, 16, 8).numpy()
    np.testing.assert_array_equal(got, ref)
    # an EOS that row 0 emits mid-sequence: masking after it, early stop
    # once every row has emitted it (never here: the other rows go on)
    eos = int(ref[0, 2])
    ref_eos = np.asarray(jgenerate(jcfg, jmodel, jparams, {"tokens": jnp.asarray(toks)}, 16, 8,
                                   eos_id=eos, pad_id=0))
    got_eos = generate(cfg, model, params, {"tokens": torch.from_numpy(toks)}, 16, 8,
                       eos_id=eos, pad_id=0).numpy()
    np.testing.assert_array_equal(got_eos, ref_eos)
    assert (got_eos[0, 3:] == 0).all()
    # every row stops at once when the first token of each row is the EOS
    one = toks[:1]
    first = int(ref[0, 0])
    ref_stop = np.asarray(jgenerate(jcfg, jmodel, jparams, {"tokens": jnp.asarray(one)}, 16, 8,
                                    eos_id=first))
    got_stop = generate(cfg, model, params, {"tokens": torch.from_numpy(one)}, 16, 8,
                        eos_id=first).numpy()
    np.testing.assert_array_equal(got_stop, ref_stop)
    assert got_stop.shape == (1, 1)
    with pytest.raises(ValueError):  # the max_seq guard
        generate(cfg, model, params, {"tokens": torch.from_numpy(toks)}, 12, 8)


def test_collect_ensemble_matches_reference(smoke):
    *_, np_params, cfg, model = smoke
    g = np.random.default_rng(3)
    np_start = jax.tree.map(lambda x: x + 0.01 * g.normal(size=x.shape).astype(np.float32),
                            np_params)
    jcenter = jax.tree.map(jnp.asarray, np_params)
    jmembers, jres = jcollect_ensemble(
        jcore.sgld(step_size=8e-5, temperature=0.0),
        lambda p: jax.tree.map(lambda x, c: PREC * (x - c), p, jcenter),
        jax.tree.map(jnp.asarray, np_start), num_samples=3, key=jax.random.PRNGKey(1), thin=4)
    center = _interop.tree_from_numpy(np_params)
    members, res = collect_ensemble(
        core.sgld(step_size=8e-5, temperature=0.0),
        lambda p: tree_map(lambda x, c: PREC * (x - c), p, center),
        _interop.tree_from_numpy(np_start), num_samples=3, key=rng.key(1), thin=4)
    assert res.steps == jres.steps == 16
    for a, b in zip(tree_leaves(members), jax.tree.leaves(jmembers)):
        assert a.shape == b.shape and a.shape[0] == 3
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    with pytest.raises(ValueError):
        collect_ensemble(core.sgld(0.1), lambda p: p, torch.zeros(2), num_samples=0,
                         key=rng.key(0))


@pytest.mark.parametrize("mode", ["sync", "overlapped"])
def test_serve_main_engine_with_refresh(mode):
    rep = serve_launch.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--engine",
                             "--ensemble", "2", "--refresh-every", "3", "--refresh-mode", mode,
                             "--requests", "6", "--slots", "3", "--prompt-len", "8", "--gen", "6"])
    assert len(rep.results) == 6 and all(r.num_tokens == 6 and not r.truncated
                                         for r in rep.results)
    assert all(0 <= int(t) < 512 for r in rep.results for t in r.tokens)
    promotions = rep.refresher["promotions" if mode == "overlapped" else "refreshes"]
    assert rep.registry["version"] >= 1 and rep.registry["rejected"] == 0
    assert rep.registry["version"] == promotions
    assert np.isfinite(rep.registry["last_health"]["mean_param_norm"])
    if mode == "overlapped":
        assert {"pump_wall_s", "micro_chunks", "decode_steps_stalled"} <= rep.refresher.keys()


def test_bootstrap_leaves_no_reference_cycles(smoke):
    """Every tree a sampler step builds is freed when dropped, not when the
    cycle collector next runs: ``tree_unflatten`` used a recursive closure,
    a reference cycle that kept each update tree alive (on the card the
    bootstrap's 80 SGLD steps filled 75 GiB before the collector ran)."""
    import gc

    *_, cfg, model = smoke
    gc.collect()
    gc.disable()
    try:
        members, res = serve_launch._bootstrap_ensemble(model.param_specs(cfg), rng.key(0), 2,
                                                        "cpu")
        del members, res
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert leaked == []


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "gemma2-27b"])
def test_serve_main_ensemble_and_single(arch):
    toks = serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--ensemble", "3", "--batch", "2", "--prompt-len", "8",
                              "--gen", "5"])
    assert toks.shape == (2, 5) and int(toks.min()) >= 0 and int(toks.max()) < 512
    single = serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    assert single.shape == (2, 5)


def test_ensemble_decode_of_one_member_is_greedy_generate(smoke):
    """With K = 1 the BMA loop is the single model's greedy decode."""
    *_, np_params, cfg, model = smoke
    params = _interop.tree_from_numpy(np_params)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 512, size=(2, 6)).astype(np.int32))
    stack = tree_map(lambda x: x[None], params)
    got = serve_launch.ensemble_decode(cfg, model, stack, {"tokens": toks}, 16, 6)
    want = generate(cfg, model, params, {"tokens": toks}, 16, 6)
    assert torch.equal(got, want)


def test_train_main_preempt_and_resume(tmp_path):
    base = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "4",
            "--chains", "2", "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    train_launch.main(base + ["--ckpt-dir", str(tmp_path / "straight")])
    with pytest.raises(Preempted):
        train_launch.main(base + ["--ckpt-dir", str(tmp_path / "cut"), "--preempt-at", "2"])
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == ["step_00000002"]
    train_launch.main(base + ["--ckpt-dir", str(tmp_path / "cut")])
    a = np.load(tmp_path / "straight" / "step_00000004" / "arrays.npz")
    b = np.load(tmp_path / "cut" / "step_00000004" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_main_refuses_unported_families():
    """Every family is ported: the audio and vlm batches carry the
    reference's keys, shapes and dtypes (the values differ: the generators
    do), with the vlm text cut to seq_len - vlm_patches(seq_len); a step's
    batch is a function of (seed, step)."""
    from repro.launch import train as jtrain_launch

    K, Bc, seq = 2, 3, 16
    for arch in ("whisper-base", "qwen2-vl-7b"):
        jcfg = jconfigs.get_config(arch, smoke=True)
        cfg = _interop.config_from(jcfg)
        want = jtrain_launch.build_batch_fn(jcfg, K, Bc, seq, seed=4)(1)
        fn = train_launch.build_batch_fn(cfg, K, Bc, seq, seed=4, device="cpu")
        got = fn(1)
        assert sorted(got) == sorted(want)
        for key, ref in want.items():
            assert tuple(got[key].shape) == tuple(ref.shape), (arch, key)
            assert got[key].dtype == _interop.torch_dtype(ref.dtype), (arch, key)
        for key in got:
            assert torch.equal(got[key], fn(1)[key])
        emb = got["frame_embeds" if arch == "whisper-base" else "patch_embeds"]
        assert 0.01 < float(emb.std()) < 0.03 and not torch.equal(
            emb, fn(2)["frame_embeds" if arch == "whisper-base" else "patch_embeds"])


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-7b", "xlstm-350m"])
def test_train_main_runs_the_new_families(arch):
    history = train_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "10",
                                 "--chains", "2", "--batch", "1", "--seq", "16"])
    assert len(history) >= 1 and np.isfinite(history[-1]["nll_per_token"])


def test_serve_main_whisper_ensemble_and_single():
    """The audio family through ``launch.serve.main``: random frame
    embeddings for the stubbed frontend, the ensemble path and the
    single-stream path."""
    base = ["--arch", "whisper-base", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    toks = serve_launch.main(base + ["--ensemble", "2"])
    assert toks.shape == (2, 4) and int(toks.min()) >= 0 and int(toks.max()) < 512
    assert serve_launch.main(base).shape == (2, 4)
    with pytest.raises(ValueError, match="without --engine"):  # token prompts only
        serve_launch.main(base + ["--engine"])
