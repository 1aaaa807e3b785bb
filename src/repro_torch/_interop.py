"""Crossing between the reference package's pytrees and the port's tensors.

Parameter and cache pytrees cross as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, tree)`` gives).  bfloat16 crosses as a
``uint16`` view: ``tree_from_numpy`` recognises a numpy bfloat16 array by
its dtype name (no import of its provider) and reinterprets its bits;
``tree_to_numpy`` returns bf16 leaves as uint16 arrays, to be viewed back
as bfloat16 on the other side.  ``torch_dtype`` maps the dtypes that
configs carry (jnp types, numpy dtypes or names) to torch dtypes, and
``config_from`` copies a reference ModelConfig into the port's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import LayerKind, ModelConfig

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    name = getattr(dtype, "name", None)  # numpy dtype instances
    if isinstance(name, str):
        return name
    name = getattr(dtype, "__name__", None)  # jnp.float32, np.float32 scalar types
    if isinstance(name, str):
        return name
    return str(np.dtype(dtype))


def torch_dtype(dtype) -> torch.dtype:
    """jnp / numpy dtype (type, instance or name) or torch dtype -> torch dtype."""
    name = _dtype_name(dtype)
    if name not in _DTYPES:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return _DTYPES[name]


def array_to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def tree_from_numpy(tree):
    """Nested dict of numpy arrays -> the same dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v) for k, v in tree.items()}
    return array_to_tensor(tree)


def tree_to_numpy(tree):
    """Nested dict of tensors -> numpy arrays (bf16 as uint16 bits)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tensor_to_array(tree)


def config_from(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with every field of a reference ModelConfig
    (a dataclass with the same field names); dtypes are mapped to torch."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        val = getattr(ref_cfg, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            val = torch_dtype(val)
        elif f.name == "pattern":
            val = tuple(LayerKind(p.kind, p.window, p.moe) for p in val)
        kw[f.name] = val
    return ModelConfig(**kw)
