"""Launch helpers of the port: the sampler wiring (``specs``), and the
entry points ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``."""
from .specs import default_sampler

__all__ = ["default_sampler"]
