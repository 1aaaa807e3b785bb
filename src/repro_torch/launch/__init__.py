"""Launch helpers of the port: the sampler wiring (``specs``)."""
from .specs import default_sampler

__all__ = ["default_sampler"]
