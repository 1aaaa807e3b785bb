"""Sampler wiring per architecture.  Only ``default_sampler`` of
``repro/launch/specs.py`` is ported; the dry-run cells (``Cell``,
``build_cell``) wait for ``launch/dryrun.py``."""
from __future__ import annotations

from repro_torch.core import ec_sghmc, sghmc


def default_sampler(cfg, arch: str, num_chains: int, sync_every: int = 4, fused: bool = False,
                    compress_sync: bool = False, step_size: float = 1e-5):
    """The paper's sampler wired for this arch (state dtype tracks params):
    EC-SGHMC over ``num_chains > 1`` chains, else SGHMC.  ``step_size``
    defaults to the reference's 1e-5."""
    del arch
    if compress_sync:
        raise NotImplementedError("the int8 center exchange waits for distributed/ in the port")
    if num_chains > 1:
        return ec_sghmc(step_size=step_size, alpha=1.0, friction=1.0, center_friction=1.0,
                        sync_every=sync_every, state_dtype=cfg.param_dtype, fused=fused)
    return sghmc(step_size=step_size, friction=1.0, state_dtype=cfg.param_dtype)
