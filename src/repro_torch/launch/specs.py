"""Cell assembly: (arch, shape, mesh) -> a step the dry run traces.

``build_cell`` returns what the dry run needs: the step function, its
abstract arguments (``meta`` tensors of the global shapes: no
allocation), the DTensor placements of each argument on the mesh, and the
analytic model FLOPs (6ND / 2ND) for the roofline's useful-compute ratio.
The layouts are the reference's: the same logical-axis rule tables give,
leaf for leaf, the reference's ``PartitionSpec``s
(``distributed.sharding.tree_specs``), here as placements.

The reference donates the train cell's params and state and the decode
cell's cache; the port's steps update those arguments IN PLACE, which is
what donation buys, so ``Cell`` has no ``donate_argnums``.  Beside them,
``default_sampler`` wires the paper's sampler for an arch and
``vlm_patches`` sizes the vlm patch prefix.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import configs
from repro_torch.core import ec_sghmc, sghmc
from repro_torch.distributed import int8_codec
from repro_torch.distributed import sharding as shd
from repro_torch.models import abstract_params, active_params, get_model, param_axes
from repro_torch.models.common import tree_map

# archs whose dims divide the model axis poorly — run them data-parallel
PURE_DP = frozenset({"whisper-base", "xlstm-350m"})
# archs needing FSDP at serve time (params too big for TP-only)
SERVE_FSDP = frozenset({"grok-1-314b", "gemma3-27b", "gemma2-27b", "qwen2-vl-7b"})
N_DATA = 1_000_000_000  # representative corpus size for the N/|B| NLL scale
VLM_PATCHES = 64


def vlm_patches(seq_len: int) -> int:
    """Patch-prefix length; bounded so tiny smoke shapes keep text tokens."""
    return min(VLM_PATCHES, seq_len // 2)


class Cell(NamedTuple):
    arch: str
    shape: str
    kind: str  # train | prefill | decode
    fn: Callable
    args: tuple  # abstract (meta) args of the global shapes
    in_shardings: tuple  # DTensor placements per arg leaf (None: a host value)
    out_shardings: Any
    model_flops: float  # analytic useful FLOPs per step (6ND / 2ND)
    num_chains: int
    meta: dict
    mesh: Any  # the DeviceMesh the placements refer to


def _stack(tree, k: int):
    return tree_map(lambda s: torch.empty((k,) + tuple(s.shape), dtype=s.dtype, device="meta"),
                    tree)


def _stack_axes(tree):
    return tree_map(lambda ax: ("chain",) + ax, tree)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _replicated(mesh):
    return shd.spec_placements((), mesh)


def _train_batch(cfg, k: int, per_chain_batch: int, seq: int):
    """(abstract batch, axes tree) with a leading chain axis."""
    i32 = torch.int32
    B, S = per_chain_batch, seq
    if cfg.family == "vlm":
        n_patch = vlm_patches(S)
        n_text = S - n_patch
        batch = {"tokens": _meta((k, B, n_text), i32), "labels": _meta((k, B, n_text), i32),
                 "patch_embeds": _meta((k, B, n_patch, cfg.d_model), cfg.compute_dtype),
                 "positions": _meta((k, 3, B, S), i32)}
        axes = {"tokens": ("chain", "batch", "seq"), "labels": ("chain", "batch", "seq"),
                "patch_embeds": ("chain", "batch", "seq", None),
                "positions": ("chain", None, "batch", "seq")}
    elif cfg.family == "audio":
        batch = {"tokens": _meta((k, B, S), i32), "labels": _meta((k, B, S), i32),
                 "frame_embeds": _meta((k, B, cfg.enc_seq, cfg.d_model), cfg.compute_dtype)}
        axes = {"tokens": ("chain", "batch", "seq"), "labels": ("chain", "batch", "seq"),
                "frame_embeds": ("chain", "batch", "seq", None)}
    else:
        batch = {"tokens": _meta((k, B, S), i32), "labels": _meta((k, B, S), i32)}
        axes = {"tokens": ("chain", "batch", "seq"), "labels": ("chain", "batch", "seq")}
    return batch, axes


def _serve_batch(cfg, batch_size: int, seq: int, prefill: bool):
    i32 = torch.int32
    B, S = batch_size, seq
    if not prefill:
        return {"tokens": _meta((B, 1), i32)}, {"tokens": ("batch", None)}
    if cfg.family == "vlm":
        n_patch = vlm_patches(S)
        n_text = S - n_patch
        return ({"tokens": _meta((B, n_text), i32), "labels": _meta((B, n_text), i32),
                 "patch_embeds": _meta((B, n_patch, cfg.d_model), cfg.compute_dtype),
                 "positions": _meta((3, B, S), i32)},
                {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                 "patch_embeds": ("batch", "seq", None), "positions": (None, "batch", "seq")})
    if cfg.family == "audio":
        return ({"tokens": _meta((B, S), i32),
                 "frame_embeds": _meta((B, cfg.enc_seq, cfg.d_model), cfg.compute_dtype)},
                {"tokens": ("batch", "seq"), "frame_embeds": ("batch", "seq", None)})
    return {"tokens": _meta((B, S), i32)}, {"tokens": ("batch", "seq")}


def default_sampler(cfg, arch: str, num_chains: int, sync_every: int = 4, fused: bool = False,
                    compress_sync: bool = False, step_size: float = 1e-5,
                    chain_axis: str | None = None):
    """The paper's sampler wired for this arch (state dtype tracks params):
    EC-SGHMC over ``num_chains > 1`` chains, else SGHMC.  ``step_size``
    defaults to the reference's 1e-5.  ``compress_sync`` sends the center
    exchange through the int8 codec; ``chain_axis`` names the axis a
    sharded run splits the chains over (the train cells')."""
    del arch
    if num_chains > 1:
        return ec_sghmc(step_size=step_size, alpha=1.0, friction=1.0, center_friction=1.0,
                        sync_every=sync_every, state_dtype=cfg.param_dtype, fused=fused,
                        compression=int8_codec() if compress_sync else None,
                        chain_axis=chain_axis)
    return sghmc(step_size=step_size, friction=1.0, state_dtype=cfg.param_dtype)


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    smoke: bool = False,
    num_chains: int | None = None,
    sync_every: int = 4,
    overrides: dict | None = None,
    fsdp: bool = True,
    serve_fsdp: bool | None = None,
    compress_sync: bool = False,
    shard_style: str = "tp_fsdp",
    noise_fn: Callable | None = None,
) -> Cell:
    """The reference's cell on a ``DeviceMesh``.  ``noise_fn`` (train
    cells) hands the sampler's noise in, as ``make_train_step`` takes it."""
    from repro_torch.serve.loop import make_decode_step, make_prefill_step
    from repro_torch.train.step import chain_binding, make_train_step

    cfg = configs.get_config(arch, smoke=smoke)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = configs.SHAPES[shape_name]
    model = get_model(cfg)
    pure_dp = arch in PURE_DP
    specs = model.param_specs(cfg)
    p_abs = abstract_params(specs)
    p_axes = param_axes(specs)
    n_active = active_params(cfg)
    names = tuple(mesh.mesh_dim_names or ())
    pods = mesh.shape[names.index("pod")] if "pod" in names else 1
    rep = _replicated(mesh)

    if cell.kind == "train":
        k = num_chains if num_chains is not None else configs.EC_CHAINS[arch] * pods
        k = max(k, 1)
        # the chain axes are bound when the step runs on DTensors
        chain_binding(mesh)
        sampler = default_sampler(cfg, arch, k, sync_every, compress_sync=compress_sync,
                                  chain_axis="chain")
        step = make_train_step(cfg, model, sampler, n_data=N_DATA, noise_fn=noise_fn)
        params_abs = _stack(p_abs, k)
        params_axes = _stack_axes(p_axes)
        state_abs = sampler.init(params_abs)
        if hasattr(state_abs, "center"):
            # the traced step is the one that syncs, the costlier of the two
            # (the reference's program holds both branches of its cond)
            state_abs = state_abs._replace(step=sync_every - 1)
        per_chain_b = max(cell.global_batch // k, 1)
        batch_abs, batch_axes = _train_batch(cfg, k, per_chain_b, cell.seq_len)

        prm_rules = shd.train_param_rules(mesh, pure_dp, fsdp=fsdp, style=shard_style)
        ctr_rules = shd.center_rules(mesh, pure_dp)
        bat_rules = shd.batch_rules(mesh, pure_dp, style=shard_style)
        params_shard = shd.tree_shardings(params_axes, params_abs, prm_rules, mesh)
        momentum_shard = shd.tree_shardings(params_axes, state_abs.momentum, prm_rules, mesh)
        if hasattr(state_abs, "center"):  # ECSGHMCState
            state_shard = type(state_abs)(
                momentum=momentum_shard,
                center=shd.tree_shardings(p_axes, state_abs.center, ctr_rules, mesh),
                center_momentum=shd.tree_shardings(p_axes, state_abs.center_momentum,
                                                   ctr_rules, mesh),
                center_stale=shd.tree_shardings(p_axes, state_abs.center_stale, ctr_rules, mesh),
                mean_theta_stale=shd.tree_shardings(p_axes, state_abs.mean_theta_stale,
                                                    ctr_rules, mesh),
                step=None,
            )
        else:  # SGHMCState
            state_shard = type(state_abs)(momentum=momentum_shard, step=None)
        batch_shard = shd.tree_shardings(batch_axes, batch_abs, bat_rules, mesh)
        tokens = cell.global_batch * cell.seq_len
        return Cell(arch, shape_name, "train", step, (params_abs, state_abs, batch_abs, 0),
                    (params_shard, state_shard, batch_shard, None),
                    (params_shard, state_shard, {"potential": rep, "nll_per_token": rep}),
                    6.0 * n_active * tokens, k, {"tokens_per_step": tokens, "n_active": n_active},
                    mesh)

    # ---- serving cells ----------------------------------------------------
    use_serve_fsdp = (arch in SERVE_FSDP) if serve_fsdp is None else serve_fsdp
    srv_rules = shd.serve_param_rules(mesh, fsdp=use_serve_fsdp, pure_dp=pure_dp,
                                      style=shard_style)
    bat_rules = shd.serve_batch_rules(mesh)
    params_shard = shd.tree_shardings(p_axes, p_abs, srv_rules, mesh)
    cache_abs = model.make_cache(cfg, cell.global_batch, cell.seq_len, cfg.compute_dtype,
                                 device="meta")
    cache_shard = shd.tree_shardings(model.cache_axes(cfg), cache_abs, bat_rules, mesh)

    if cell.kind == "prefill":
        step = make_prefill_step(cfg, model, max_seq=cell.seq_len, cache_dtype=cfg.compute_dtype)
        batch_abs, batch_axes = _serve_batch(cfg, cell.global_batch, cell.seq_len, True)
        batch_shard = shd.tree_shardings(batch_axes, batch_abs, bat_rules, mesh)

        def prefill_fn(params, batch):
            # the cache is made in the decode cell's layout, on the params'
            # mesh when they are DTensors
            return step(params, batch, cache=shd.zeros_like_layout(cache_abs, cache_shard,
                                                                   params, mesh))

        tokens = cell.global_batch * cell.seq_len
        return Cell(arch, shape_name, "prefill", prefill_fn, (p_abs, batch_abs),
                    (params_shard, batch_shard), None, 2.0 * n_active * tokens, 1,
                    {"tokens_per_step": tokens, "n_active": n_active}, mesh)

    # decode (decode_32k / long_500k): one new token against a seq_len cache
    step = make_decode_step(cfg, model)
    tok_abs, tok_axes = _serve_batch(cfg, cell.global_batch, cell.seq_len, False)
    tok_shard = shd.tree_shardings(tok_axes, tok_abs, bat_rules, mesh)
    return Cell(arch, shape_name, "decode", step, (p_abs, cache_abs, tok_abs["tokens"]),
                (params_shard, cache_shard, tok_shard["tokens"]),
                (tok_shard["tokens"], cache_shard), 2.0 * n_active * cell.global_batch, 1,
                {"tokens_per_step": cell.global_batch, "n_active": n_active}, mesh)
