"""Fault-tolerant checkpointing (numpy ``.npz`` files, the reference's
format).

* ATOMIC: state is written to ``<dir>/tmp.<step>`` then os.replace()'d to
  ``<dir>/step_<step>`` — a crash mid-write can never corrupt the latest
  valid checkpoint.
* SELF-VALIDATING: a manifest records leaf count, shapes and a checksum;
  restore() verifies and falls back to the previous checkpoint when the
  newest is damaged (torn disk, partial preemption).
* ELASTIC: ``restore_elastic`` re-shapes the chain axis — a job restarted
  with a different K resamples new chains from the center variable
  (theta^i | c ~ N(c, (K/alpha) I), the stationary conditional implied by
  Eq. 5) instead of failing.  Dead chains are recoverable the same way.

The files are the reference's: each leaf is keyed by the string
``jax.tree_util.tree_flatten_with_path`` gives for the same tree (dict
keys as ``['embed']``, NamedTuple fields as ``.momentum``), joined by
``"::"``; a sampler state's host-int ``step`` is stored as a 0-d int32
array, as the reference stores its step; bfloat16 leaves are stored as
their ``uint16`` bits.  So a checkpoint written by either package restores
in the other, with identical manifests.  ``restore`` puts every leaf on
the device of the template's leaf (a host-int template leaf restores as an
int).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch._interop import array_to_device
from repro_torch.core import rng as rnglib
from repro_torch.core.ec_sghmc import ECSGHMCState, resample_chain_from_center
from repro_torch.models.common import tree_map
from repro_torch.obs import get_logger

log = get_logger("ckpt")

_SEP = "::"


def _flatten_with_path(tree, path=()):
    """(path, leaf) pairs in the reference pytree's flatten order: dict
    keys sorted, NamedTuple fields and sequence items in order, None an
    empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_path(tree[k], path + (f"[{k!r}]",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten_with_path(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in _flatten_with_path(v, path + (f"[{i}]",))]
    return [(_SEP.join(path), tree)]


def _unflatten(template, leaves: dict, path=()):
    """``template``'s structure with each leaf taken from ``leaves`` by path."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves, path + (f"[{k!r}]",)) for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves, path + (f".{f}",))
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves, path + (f"[{i}]",))
                              for i, v in enumerate(template))
    return leaves[_SEP.join(path)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)  # a host step, stored as the reference's int32
    return np.asarray(leaf)


def _flatten(tree):
    return {key: _to_numpy(leaf) for key, leaf in _flatten_with_path(tree)}


def _leaf_sum(v):  # NaN/inf-robust (a diverged model must still checkpoint)
    s = float(np.nansum(np.abs(v).astype(np.float64)))
    return int((s if np.isfinite(s) else 0.0) * 1000) % 2**31


def save(ckpt_dir, step: int, params, sampler_state, extra: dict | None = None):
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = _flatten({"params": params, "state": sampler_state})
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": int(step),
        "leaves": len(flat),
        "checksum": int(sum(_leaf_sum(v) for v in flat.values() if v.dtype.kind == "f")),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic on POSIX
    return final


def _checkpoints(ckpt_dir):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))


def _restore_leaf(arr: np.ndarray, tpl):
    """A stored array as the template leaf's kind: a tensor on the
    template's device (bf16 bits read back when the template is bf16), or
    a host int for a host-int template leaf."""
    if isinstance(tpl, torch.Tensor):
        return array_to_device(arr, tpl.device, tpl.dtype)
    if isinstance(tpl, (bool, int)):
        return int(arr)
    return arr


def _load_one(path: Path, template):
    manifest = json.loads((path / "manifest.json").read_text())
    # the template against the manifest first: a checkpoint of another
    # chain count is refused before any array is read
    tpl = _flatten_with_path(template)
    for key, tpl_leaf in tpl:
        want = tuple(tpl_leaf.shape) if hasattr(tpl_leaf, "shape") else ()
        if key not in manifest["shapes"]:
            raise IOError(f"{path}: missing leaf {key}")
        if tuple(manifest["shapes"][key]) != want:
            raise IOError(
                f"{path}: template shape mismatch for {key}: "
                f"stored {tuple(manifest['shapes'][key])} vs wanted {want}"
            )
    with np.load(path / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    if len(flat) != manifest["leaves"]:
        raise IOError(f"{path}: leaf count mismatch")
    for k, v in flat.items():
        if list(v.shape) != manifest["shapes"][k]:
            raise IOError(f"{path}: shape mismatch for {k}")
    # rebuild against the template's structure
    leaves = {}
    for key, tpl_leaf in tpl:
        if key not in flat:
            raise IOError(f"{path}: missing leaf {key}")
        leaves[key] = _restore_leaf(flat[key], tpl_leaf)
    return manifest["step"], _unflatten(template, leaves), manifest.get("extra", {})


def restore(ckpt_dir, params_template, state_template):
    """Latest VALID checkpoint (walks backward past corrupted ones).
    Returns (step, params, state, extra) or None."""
    template = {"params": params_template, "state": state_template}
    for path in reversed(_checkpoints(ckpt_dir)):
        try:
            step, payload, extra = _load_one(path, template)
            return step, payload["params"], payload["state"], extra
        except Exception as e:  # corrupted — try the previous one
            log.warning(f"skipping {path.name}: {e}")
    return None


def restore_elastic(ckpt_dir, params_template, state_template, num_chains: int, alpha: float,
                    seed: int = 0):
    """Restore; if the checkpointed chain count differs from ``num_chains``,
    resample chains from the center (elastic K scaling)."""
    exact = restore(ckpt_dir, params_template, state_template)
    if exact is not None:
        return exact
    # chain-count mismatch: load raw, rebuild from center
    for path in reversed(_checkpoints(ckpt_dir)):
        try:
            manifest = json.loads((path / "manifest.json").read_text())
            prefix = ("['state']", ".center")
            tpl_center = state_template.center
            with np.load(path / "arrays.npz") as z:
                # guard: this checkpoint must hold EC center state
                if not any(f"{_SEP}.center" in k for k in z.files):
                    continue
                # only the center's arrays are read
                center = _unflatten(tpl_center, {
                    key: _restore_leaf(z[_SEP.join(prefix + ((key,) if key else ()))], tpl)
                    for key, tpl in _flatten_with_path(tpl_center)
                })
            stub = ECSGHMCState(
                momentum=None, center=center,
                center_momentum=tree_map(torch.zeros_like, center),
                center_stale=center, mean_theta_stale=center, step=int(manifest["step"]),
            )
            params, state = resample_chain_from_center(
                stub, alpha=alpha, rng=rnglib.key(seed), num_chains=num_chains
            )
            return manifest["step"], params, state, {"elastic_resample": True}
        except Exception as e:
            log.warning(f"elastic restore failed for {path.name}: {e}")
    return None


def prune(ckpt_dir, keep: int = 3):
    ckpts = _checkpoints(ckpt_dir)
    for p in ckpts[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
