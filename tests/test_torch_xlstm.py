"""The port's ssm family (xlstm-350m: mLSTM and sLSTM blocks) against the
reference's, on the CPU.

The SMOKE configuration (one mLSTM and one sLSTM block a period, two
periods) on params drawn by ``repro.models.init_params`` and carried
across with ``_interop``: the spec tree at SMOKE and full size, each block
and decode step, the prefill's final recurrent states, prefill then three
decode steps (logits and every cache leaf), ``train_nll`` and its
gradient, and the dense ``ServeEngine`` must match the reference (layers
at 1e-5, the model at the reference suite's 2e-5 with
``torch_parity.SCALE_RTOL``; tokens identical).  The paged engine is
refused with the reference's message.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.models import recurrent as jR
from repro.models import transformer as jT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.models import get_model, tree_map
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ARCH = "xlstm-350m"
LAYER_ATOL = 1e-5


@pytest.fixture(scope="module")
def shared():
    return tp.setup(ARCH, seed=1)


def _mix(params, jparams, pos):
    """Pattern position ``pos``'s mixer params of the first period."""
    return (tree_map(lambda a: a[0], params["layers"][pos]["mix"]),
            jax.tree.map(lambda a: a[0], jparams["layers"][pos]["mix"]))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, what=""):
    tp.assert_close(got, want, atol=LAYER_ATOL, scale_rtol=0.0, what=what)


def test_config_and_specs_match_reference():
    tp.check_config_and_specs(ARCH)
    full = configs.get_config(ARCH)  # 24 layers: 3 periods of 7 mLSTM + 1 sLSTM
    kinds = [k.kind for k in full.layer_kinds]
    assert full.family == "ssm" and kinds.count("mlstm") == 21 and kinds.count("slstm") == 3
    layers = T.param_specs(full)["layers"]
    assert set(layers["0"]) == set(layers["7"]) == {"ln1", "mix"}  # no FFN of their own


def test_mlstm_block_matches_reference(shared):
    jcfg, _, jparams, cfg, params = shared
    p, jp = _mix(params, jparams, "0")
    x = _x(3, (2, 12, cfg.d_model))
    _close(R.mlstm_block(cfg, p, torch.tensor(x)), jR.mlstm_block(jcfg, jp, jnp.asarray(x)),
           "mlstm_block")


def test_mlstm_decode_matches_reference(shared):
    """Three steps from a nonzero state, the state written in place."""
    jcfg, _, jparams, cfg, params = shared
    p, jp = _mix(params, jparams, "0")
    up, NH, dh = R._mlstm_dims(cfg)
    state = {"C": _x(4, (3, NH, dh, dh)), "n": _x(5, (3, NH, dh)),
             "m": 0.5 * _x(6, (3, NH)), "conv": _x(7, (3, 3, up))}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    state = {k: torch.tensor(v) for k, v in state.items()}
    for step in range(3):
        x = _x(10 + step, (3, 1, cfg.d_model))
        out, new = R.mlstm_decode(cfg, p, torch.tensor(x), state)
        jout, jstate = jR.mlstm_decode(jcfg, jp, jnp.asarray(x), jstate)
        assert new is state
        _close(out, jout, f"step {step} out")
        for key in ("C", "n", "m", "conv"):
            _close(state[key], jstate[key], f"step {step} {key}")


def test_slstm_cell_and_decode_match_reference(shared):
    jcfg, _, jparams, cfg, params = shared
    p, jp = _mix(params, jparams, "1")
    shape = (3, cfg.num_heads, cfg.head_dim)
    state = {"h": _x(4, shape), "c": _x(5, shape), "n": np.abs(_x(6, shape)) + 0.5,
             "m": 0.5 * _x(7, shape)}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    state = {k: torch.tensor(v) for k, v in state.items()}
    xt = _x(8, (3, cfg.d_model))
    cell, jcell = R._slstm_cell(p, torch.tensor(xt), state), jR._slstm_cell(jp, jnp.asarray(xt),
                                                                             jstate)
    for key in ("h", "c", "n", "m"):
        _close(cell[key], jcell[key], f"cell {key}")
    for step in range(3):
        x = _x(10 + step, (3, 1, cfg.d_model))
        out, _ = R.slstm_decode(cfg, p, torch.tensor(x), state)
        jout, jstate = jR.slstm_decode(jcfg, jp, jnp.asarray(x), jstate)
        _close(out, jout, f"step {step} out")
        for key in ("h", "c", "n", "m"):
            _close(state[key], jstate[key], f"step {step} {key}")


def test_slstm_block_matches_reference(shared):
    jcfg, _, jparams, cfg, params = shared
    p, jp = _mix(params, jparams, "1")
    x = _x(3, (2, 12, cfg.d_model))
    out, state = R.slstm_block(cfg, p, torch.tensor(x))
    _close(out, jR.slstm_block(jcfg, jp, jnp.asarray(x)), "slstm_block")
    jout, jstate = jT._slstm_with_state(jcfg, jp, jnp.asarray(x))
    _close(out, jout, "slstm_with_state out")
    for key in ("h", "c", "n", "m"):
        _close(state[key], jstate[key], f"final {key}")


@pytest.mark.parametrize("S", [10, 2])
def test_prefill_final_states_match_reference(shared, S):
    """The mLSTM state from the decode recurrence run over the prompt, as
    the reference's prefill extracts it (a prompt shorter than the conv
    history too)."""
    jcfg, _, jparams, cfg, params = shared
    x = _x(9, (2, S, cfg.d_model))
    p, jp = _mix(params, jparams, "0")
    state = R.mlstm_init_state(cfg, 2, torch.float32, "cpu")
    out = R.mlstm_block(cfg, p, torch.tensor(x), state)
    jout, jstate = jT._mlstm_with_state(jcfg, jp, jnp.asarray(x))
    _close(out, jout, "mlstm out")
    for key in ("C", "n", "m", "conv"):
        _close(state[key], jstate[key], f"mlstm {key}")
    assert float(state["m"].min()) > -1e29  # every head has seen a token


def test_prefill_and_decode_match_reference(shared):
    tl = tp.check_prefill_and_decode(shared, tp.tokens(0, (2, 14)), max_seq=24)
    assert torch.isfinite(tl).all()


def test_decode_continues_prefill(shared):
    """decode after a prefill of 8 tokens == the last position of a prefill
    of 9..12 tokens (the recurrent tolerance of the arch smoke tests)."""
    *_, cfg, params = shared
    model = get_model(cfg)
    toks = torch.tensor(tp.tokens(9, (1, 12)))

    def last_logits(n):
        return model.prefill(cfg, params, {"tokens": toks[:, :n]}, 16)[0][0, 0].numpy()

    lg, cache = model.prefill(cfg, params, {"tokens": toks[:, :8]}, 16)
    for t in range(8, 12):
        lg, cache = model.decode_step(cfg, params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(lg[0, 0].numpy(), last_logits(t + 1), rtol=5e-4, atol=5e-4)


def test_train_nll_and_grad_match_reference(shared):
    tp.check_train_nll(shared)
    tp.check_grads(shared, tp.nll_batch(16, seed=8))


@pytest.fixture(scope="module")
def members():
    return tp.member_setup(ARCH, K=2)


def test_dense_engine_matches_reference_engine(members):
    rep = tp.check_engine(members, paged=False)
    assert rep.total_tokens == 16


def test_paged_engine_is_refused_like_the_reference(members):
    jcfg, jmodel, jmembers, cfg, model, stack = members
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jcfg, jmodel, jmembers, num_slots=2, max_seq=24, paged=True)
    with pytest.raises(ValueError) as err:
        ServeEngine(cfg, model, stack, num_slots=2, max_seq=24, paged=True, device="cpu")
    assert str(err.value) == str(jerr.value) == \
        "paged decode supports attn-only models, got 'mlstm'"
