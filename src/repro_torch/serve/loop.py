"""Serving steps: prefill (prompt -> cache) and single-token decode.

Token selection goes through the shared ``repro_torch.serve.sampling``
helper (greedy / temperature / top-k), the same one the continuous-batching
engine uses.  Randomness is a ``core.rng`` key: a step's generator is
seeded from ``fold_in(key, step)``.

``ensemble_diagnostics`` reports the dispersion of a chain ensemble before
it serves: a collapsed ensemble (zero spread) silently degrades Bayesian
model averaging to a single model, and the serving tier is where that must
be caught.

``collect_ensemble`` draws the K ensemble members as thinned samples of one
executor run (``repro_torch.run.rollout``).  The interactive ``generate``
loop below is a per-step host loop.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng as rnglib
from repro_torch.diagnostics import ensemble_spread
from repro_torch.models import ModelDef
from repro_torch.models.common import ModelConfig, tree_map
from repro_torch.run import rollout
from repro_torch.serve.sampling import GREEDY, SamplingParams, mask_after_eos, select_tokens


def _generator(key, device):
    return None if key is None else rnglib.generator(key, device)


def make_prefill_step(
    cfg: ModelConfig,
    model: ModelDef,
    max_seq: int,
    cache_dtype=None,
    sampling: SamplingParams = GREEDY,
):
    def prefill_step(params, batch, key=None, cache=None):
        """``cache``: an all-zero cache to fill (the dry-run cell's, laid
        out on its mesh); None makes a new one."""
        logits, cache = model.prefill(cfg, params, batch, max_seq, cache_dtype, cache=cache)
        gen = _generator(key, logits.device)
        return select_tokens(logits[:, -1], gen, sampling)[:, None], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, model: ModelDef, sampling: SamplingParams = GREEDY):
    def serve_step(params, cache, tokens, key=None):
        logits, new_cache = model.decode_step(cfg, params, cache, tokens)
        gen = _generator(key, logits.device)
        return select_tokens(logits[:, -1], gen, sampling)[:, None], new_cache

    return serve_step


def ensemble_diagnostics(params_stack, *, min_rel_spread: float = 1e-6) -> dict:
    """Ensemble-spread health report for a (K, ...)-stacked posterior
    ensemble about to serve: the shared spread summary plus a ``collapsed``
    flag — K identical samples waste K× serve compute for a single model's
    predictions."""
    out = ensemble_spread(params_stack)
    out["collapsed"] = bool(out["rel_spread"] < min_rel_spread)
    return out


def collect_ensemble(
    sampler,
    grad_fn,
    params0,
    *,
    num_samples: int,
    key,
    thin: int = 16,
    burn: int | None = None,
):
    """Draw ``num_samples`` ensemble members as thinned posterior samples of
    one sampler run: burn-in, then every ``thin``-th state, in one
    ``rollout`` (one chunk).  Returns the (num_samples, ...) member stack,
    ready for ``ensemble_decode`` / ``ensemble_diagnostics``, and the run's
    result.  ``grad_fn(theta)`` is the gradient of whatever potential the
    ensemble should target (posterior for a trained model, prior bootstrap
    for a demo).  ``burn`` defaults to one thinning interval and is rounded
    up so every kept sample is post-burn-in.  ``params0`` is consumed."""
    if num_samples < 1 or thin < 1:
        raise ValueError("num_samples and thin must be >= 1")
    burn = thin if burn is None else thin * -(-burn // thin)  # ceil to a thin multiple
    steps = burn + num_samples * thin
    keys = rnglib.split(key, steps)
    res = rollout(
        sampler, grad_fn, params0,
        num_steps=steps, keys=keys, thin=thin, moments=False,
        chunk_steps=steps,
    )
    members = tree_map(lambda a: a[-num_samples:].clone(), res.trace)
    return members, res


@torch.no_grad()
def generate(
    cfg: ModelConfig,
    model: ModelDef,
    params,
    batch,
    max_seq: int,
    num_tokens: int,
    *,
    sampling: SamplingParams = GREEDY,
    key=None,
    eos_id: int | None = None,
    pad_id: int = 0,
):
    """Host-side generation loop (examples / integration tests).

    Stops as soon as EVERY sequence has emitted ``eos_id`` (when given)
    instead of always decoding to the full ``num_tokens`` budget, and masks
    everything after each row's first EOS with ``pad_id`` — so the returned
    (B, T) tensor may have fewer than ``num_tokens`` columns.
    ``sampling``/``key`` select tokens through the shared helper (greedy by
    default)."""
    if sampling.temperature > 0 and key is None:
        raise ValueError("temperature > 0 sampling needs key=")
    prompt_len = int(batch["tokens"].shape[-1])
    if prompt_len + num_tokens > max_seq:
        # a cache write past max_seq-1 would clamp and overwrite the last
        # position instead of failing — same guard as ServeEngine admission
        raise ValueError(
            f"prompt_len + num_tokens = {prompt_len + num_tokens} exceeds "
            f"max_seq={max_seq}"
        )
    prefill = make_prefill_step(cfg, model, max_seq, sampling=sampling)
    step = make_decode_step(cfg, model, sampling=sampling)
    step_key = lambda i: None if key is None else rnglib.fold_in(key, i)
    tok, cache = prefill(params, batch, step_key(0))
    out = [tok]
    done = (tok == eos_id) if eos_id is not None else None
    for i in range(num_tokens - 1):
        if eos_id is not None and bool(done.all()):
            break
        tok, cache = step(params, cache, tok, step_key(i + 1))
        out.append(tok)
        if eos_id is not None:
            done = done | (tok == eos_id)
    seq = torch.cat(out, dim=1)
    if eos_id is not None:
        seq = mask_after_eos(seq, eos_id, pad_id)
    return seq
