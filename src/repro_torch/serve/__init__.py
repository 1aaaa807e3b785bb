from .loop import (
    collect_ensemble,
    ensemble_diagnostics,
    generate,
    make_decode_step,
    make_prefill_step,
)
from .sampling import GREEDY, SamplingParams, gumbel_noise, mask_after_eos, select_tokens

__all__ = [
    "GREEDY",
    "SamplingParams",
    "collect_ensemble",
    "ensemble_diagnostics",
    "generate",
    "gumbel_noise",
    "make_decode_step",
    "make_prefill_step",
    "mask_after_eos",
    "select_tokens",
]
