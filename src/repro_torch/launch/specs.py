"""Sampler wiring per architecture, and the vlm patch-prefix length.  Of
``repro/launch/specs.py`` only ``default_sampler``, ``VLM_PATCHES`` and
``vlm_patches`` are ported; the dry-run cells (``Cell``, ``build_cell``)
wait for ``launch/dryrun.py``."""
from __future__ import annotations

from repro_torch.core import ec_sghmc, sghmc
from repro_torch.distributed import int8_codec

VLM_PATCHES = 64


def vlm_patches(seq_len: int) -> int:
    """Patch-prefix length; bounded so tiny smoke shapes keep text tokens."""
    return min(VLM_PATCHES, seq_len // 2)


def default_sampler(cfg, arch: str, num_chains: int, sync_every: int = 4, fused: bool = False,
                    compress_sync: bool = False, step_size: float = 1e-5):
    """The paper's sampler wired for this arch (state dtype tracks params):
    EC-SGHMC over ``num_chains > 1`` chains, else SGHMC.  ``step_size``
    defaults to the reference's 1e-5.  ``compress_sync`` sends the center
    exchange through the int8 codec."""
    del arch
    if num_chains > 1:
        return ec_sghmc(step_size=step_size, alpha=1.0, friction=1.0, center_friction=1.0,
                        sync_every=sync_every, state_dtype=cfg.param_dtype, fused=fused,
                        compression=int8_codec() if compress_sync else None)
    return sghmc(step_size=step_size, friction=1.0, state_dtype=cfg.param_dtype)
