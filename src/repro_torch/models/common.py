"""Model substrate: configs and the ParamSpec machinery.

One source of truth per model: ``param_specs(cfg)`` returns a nested dict
of :class:`ParamSpec` with the reference package's key paths and its
stacked-layer axis, so weights cross one to one.  ``init_params``
materialises it on a device from a ``torch.Generator``; ``abstract_params``
gives it as ``meta`` tensors (the dry run: no allocation) and
``param_axes`` its logical-axis names (the sharding rules), so init,
shapes and sharding can never drift apart.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name (str) or None per dim; len == len(shape)
    init: str = "normal"  # normal | zeros | ones | lru_lambda
    scale: float | str = "fan_in"  # stddev, or "fan_in" => 1/sqrt(fan_in dim)
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (the reference pytree's
    flatten order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves):
    """The tree of ``template``'s structure holding ``leaves`` in flatten
    order (the inverse of :func:`tree_leaves`)."""
    return _build(template, iter(leaves))


def _build(template, it):
    # a module-level function: a recursive closure would be a reference
    # cycle holding ``leaves`` until Python's cycle collector ran
    if isinstance(template, dict):
        return {k: _build(template[k], it) for k in sorted(template)}
    return next(it)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def map_tensors(fn, tree, *rest):
    """``fn`` on every tensor of a tree of dicts, tuples and NamedTuples (a
    sampler state), with the matching leaves of ``rest``; other leaves (host
    ints, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [map_tensors(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _materialize(spec: ParamSpec, generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "lru_lambda":
        # RG-LRU Λ init: a = exp(-8·softplus(Λ)) uniform in [0.9, 0.999], so
        # Λ = softplus⁻¹(-log(u)/8) for u ~ U(0.9, 0.999)
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32, device=device)
        u = torch.clamp_min(u * (0.999 - 0.9) + 0.9, 0.9)
        sp = -torch.log(u) / 8.0
        return torch.log(torch.expm1(torch.clamp_min(sp, 1e-8))).to(spec.dtype)
    if spec.init != "normal":
        raise NotImplementedError(f"init {spec.init!r}")
    if spec.scale == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        std = 1.0 / math.sqrt(fan_in)
    else:
        std = float(spec.scale)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return (x.mul_(std)).to(spec.dtype)


def init_params(specs, generator: torch.Generator, device="cuda"):
    """Materialise a spec tree on ``device``.  Leaves draw from ``generator``
    in the reference's flatten order; the numbers differ from
    ``jax.random``'s, so tests carry weights across with ``_interop``."""
    if isinstance(specs, dict):
        return {k: init_params(specs[k], generator, device) for k in sorted(specs)}
    return _materialize(specs, generator, device)


def abstract_params(specs, dtype_override=None, device="meta"):
    """The spec tree as tensors on the ``meta`` device (no storage): the
    reference's ``ShapeDtypeStruct`` tree, for the dry run."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype_override or s.dtype,
                                          device=device), specs)


def param_axes(specs):
    """The logical-axis names per dim of every leaf (the sharding rules'
    input)."""
    return tree_map(lambda s: s.axes, specs)


def cast_specs(specs, dtype):
    return tree_map(lambda s: dataclasses.replace(s, dtype=dtype), specs)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerKind:
    kind: str  # attn | rglru | mlstm | slstm
    window: Optional[int] = None  # sliding-window size; None => full/global attn
    moe: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | audio | hybrid | ssm | vlm
    vocab_size: int
    d_model: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    # repeating block pattern (cycled); remainder handled by truncation
    pattern: tuple = (LayerKind("attn"),)
    norm_eps: float = 1e-6
    norm_scale_offset: float = 0.0  # gemma: weight stored as (w - 1)
    sandwich_norm: bool = False  # gemma2/3: post-norms on both sublayers
    act: str = "silu"
    mlp_gated: bool = True  # False: plain 2-layer MLP (whisper)
    use_rope: bool = True  # False: absolute position embeddings (whisper)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple] = None  # qwen2-vl (t, h, w) freq split
    query_scale: Optional[float] = None  # None => 1/sqrt(head_dim)
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # recurrent blocks
    rglru_conv_width: int = 4
    rnn_width: Optional[int] = None
    # embeddings / head
    tie_embeddings: bool = True
    embed_scale: Optional[str] = None  # "sqrt_d" (gemma)
    embed_onehot: bool = False  # one_hot(tokens) @ table lookup
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0
    # dtypes
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    # loss
    xent_chunk: int = 2048
    remat: str = "full"
    # dispatch attention through the hand-written CUDA kernels (flash
    # prefill, paged decode); on CPU tensors the kernels' plain versions run
    use_flash_kernel: bool = False

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer LayerKind, pattern cycled to num_layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def num_params(cfg: ModelConfig) -> int:
    """Total parameter count derived from the spec tree (exact)."""
    from . import registry  # local import to avoid cycle

    specs = registry.get_model(cfg).param_specs(cfg)
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def active_params(cfg: ModelConfig) -> int:
    """Params touched per token, for 6 * N_active * tokens: an expert
    leaf counts top_k / num_experts of its size (MoE), as in the
    reference."""
    from . import registry

    total = 0
    for s in tree_leaves(registry.get_model(cfg).param_specs(cfg)):
        n = math.prod(s.shape)
        if "expert" in s.axes and cfg.moe_num_experts:
            n = n * cfg.moe_top_k // cfg.moe_num_experts
        total += n
    return total
