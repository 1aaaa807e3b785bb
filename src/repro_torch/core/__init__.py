"""The port's SG-MCMC samplers with elastic coupling, as ``(init,
update)`` transforms over (possibly chain-stacked) trees of tensors.
Ported: SGLD, SGHMC and EC-SGHMC (fused and unfused), the adaptive tier
(diagonal preconditioners, scale-adapted SGHMC and EC-SGHMC, pSGLD, the
FeedbackESS controller), the paper's naive Async SGHMC baseline
(``async_sghmc``), EC-SGLD, the EASGD family (``easgd``, ``eamsgd``,
``ec_msgd``), the complete-recipe simulator (``recipe``), schedules,
potentials and the tree helpers."""
from . import recipe, rng
from .async_sghmc import AsyncSGHMCState, async_sghmc
from .easgd import EAMSGDState, EASGDState, ECMSGDState, eamsgd, easgd, ec_msgd
from .ec_sghmc import ECSGHMCState, ec_sghmc, p_step, resample_chain_from_center
from .ec_sgld import ECSGLDState, ec_sgld
from .potential import Potential, chainwise, flat_prior, gaussian_prior, make_potential
from .preconditioned_sgld import PSGLDState, preconditioned_sgld
from .preconditioner import (
    PrecondState,
    Preconditioner,
    adam_preconditioner,
    frozen_mass_inv,
    get_preconditioner,
    rmsprop_preconditioner,
)
from .scale_adapted import (
    ScaleAdaptedECState,
    ScaleAdaptedState,
    scale_adapted_ec_sghmc,
    scale_adapted_sghmc,
)
from .schedules import (
    FeedbackESS,
    as_schedule,
    constant,
    cosine,
    feedback_ess,
    polynomial_decay,
    warmup_cosine,
)
from .sgld import SGLDState, sgld
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
    "AsyncSGHMCState",
    "EAMSGDState",
    "EASGDState",
    "ECMSGDState",
    "ECSGHMCState",
    "ECSGLDState",
    "FeedbackESS",
    "PSGLDState",
    "Potential",
    "PrecondState",
    "Preconditioner",
    "SGHMCState",
    "SGLDState",
    "Sampler",
    "ScaleAdaptedECState",
    "ScaleAdaptedState",
    "adam_preconditioner",
    "apply_updates",
    "as_schedule",
    "async_sghmc",
    "chainwise",
    "constant",
    "cosine",
    "count_params",
    "eamsgd",
    "easgd",
    "ec_msgd",
    "ec_sghmc",
    "ec_sgld",
    "feedback_ess",
    "flat_prior",
    "frozen_mass_inv",
    "gaussian_prior",
    "get_preconditioner",
    "global_norm",
    "make_potential",
    "p_step",
    "polynomial_decay",
    "preconditioned_sgld",
    "recipe",
    "resample_chain_from_center",
    "rmsprop_preconditioner",
    "rng",
    "scale_adapted_ec_sghmc",
    "scale_adapted_sghmc",
    "sgld",
    "sghmc",
    "tree_broadcast_axis0",
    "tree_cast",
    "tree_mean_axis0",
    "tree_random_normal",
    "warmup_cosine",
]
