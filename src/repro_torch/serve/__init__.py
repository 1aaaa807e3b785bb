from .sampling import GREEDY, SamplingParams, gumbel_noise, mask_after_eos, select_tokens

__all__ = ["GREEDY", "SamplingParams", "gumbel_noise", "mask_after_eos", "select_tokens"]
