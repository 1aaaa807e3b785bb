"""The port's SG-MCMC samplers with elastic coupling, as ``(init,
update)`` transforms over (possibly chain-stacked) trees of tensors.
Ported: SGHMC and EC-SGHMC (fused and unfused), schedules, potentials and
the tree helpers; the other samplers and the adaptive tier are not yet."""
from . import rng
from .ec_sghmc import ECSGHMCState, ec_sghmc, p_step, resample_chain_from_center
from .potential import Potential, chainwise, flat_prior, gaussian_prior, make_potential
from .schedules import as_schedule, constant, cosine, polynomial_decay, warmup_cosine
from .sghmc import SGHMCState, sghmc
from .tree_util import (
    apply_updates,
    count_params,
    global_norm,
    tree_broadcast_axis0,
    tree_cast,
    tree_mean_axis0,
    tree_random_normal,
)
from .types import Sampler

__all__ = [
    "ECSGHMCState",
    "Potential",
    "SGHMCState",
    "Sampler",
    "apply_updates",
    "as_schedule",
    "chainwise",
    "constant",
    "cosine",
    "count_params",
    "ec_sghmc",
    "flat_prior",
    "gaussian_prior",
    "global_norm",
    "make_potential",
    "p_step",
    "polynomial_decay",
    "resample_chain_from_center",
    "rng",
    "sghmc",
    "tree_broadcast_axis0",
    "tree_cast",
    "tree_mean_axis0",
    "tree_random_normal",
    "warmup_cosine",
]
