"""Crossing between the reference package's pytrees and the port's tensors.

Parameter and cache pytrees cross as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, tree)`` gives).  bfloat16 crosses as a
``uint16`` view: ``tree_from_numpy`` recognises a numpy bfloat16 array by
its dtype name (no import of its provider) and reinterprets its bits;
``tree_to_numpy`` returns bf16 leaves as uint16 arrays, to be viewed back
as bfloat16 on the other side.  ``torch_dtype`` maps the dtypes that
configs carry (jnp types, numpy dtypes or names) to torch dtypes, and
``config_from`` copies a reference ModelConfig into the port's.

Sampler states cross field by field: ``state_from_numpy`` turns a
reference sampler state (SGHMC, EC-SGHMC, Async SGHMC, EC-SGLD or one of
the EASGD family) whose leaves are numpy arrays
(``jax.tree.map(np.asarray, state)``) into the port's state of the same
name on a given device, with a host-int ``step``; ``state_to_numpy`` goes
back to a dict of numpy trees.  ``array_to_device`` is the numpy -> tensor
step they share with ``train/checkpoint.py``.  A chain-stacked parameter
tree, and the flat parameter dicts of the MLP and ResNet-32, cross like any
other tree.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import LayerKind, ModelConfig, tree_map

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


def array_to_device(a, device, dtype=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, in its own dtype.  A numpy
    bfloat16 array becomes bfloat16; with ``dtype=torch.bfloat16`` a 2-byte
    array (``uint16`` bits, or the raw 2-byte records ``np.savez`` leaves of
    a numpy bfloat16 array) is read as bfloat16 bits too."""
    arr = np.ascontiguousarray(a)
    bf16_bits = arr.dtype.itemsize == 2 and (arr.dtype.kind == "V" or arr.dtype == np.uint16)
    bf16 = arr.dtype.name == "bfloat16" or (dtype == torch.bfloat16 and bf16_bits)
    if bf16:
        arr = arr.view(np.int16)
    if torch.device(device).type == "cpu" or not arr.flags.writeable:
        arr = arr.copy()  # never share the array's memory: the port's samplers write in place
    t = torch.from_numpy(arr)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def tree_from_numpy(tree):
    """Nested dict of numpy arrays -> the same dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v) for k, v in tree.items()}
    return array_to_device(tree, "cpu")


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


def state_from_numpy(ref_state, *, device):
    """A reference sampler state (NamedTuple of numpy trees) -> the port's
    state class of the same name, tensors on ``device``."""
    from repro_torch import core

    classes = {c.__name__: c for c in (
        core.AsyncSGHMCState, core.EAMSGDState, core.EASGDState, core.ECMSGDState,
        core.ECSGHMCState, core.ECSGLDState, core.SGHMCState)}
    name = type(ref_state).__name__
    if name not in classes:
        raise ValueError(f"no port state for {name}")
    cls = classes[name]
    kw = {}
    for f in cls._fields:
        val = getattr(ref_state, f)
        kw[f] = (int(np.asarray(val)) if f == "step"
                 else tree_map(lambda x: array_to_device(x, device), val))
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """A port sampler state -> {field: numpy tree}, ``step`` an int."""
    return {f: (int(v) if f == "step" else tree_to_numpy(v)) for f, v in state._asdict().items()}
