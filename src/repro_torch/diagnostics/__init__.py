"""Ensemble diagnostics of the port: only the spread summaries the serving
registry needs are ported so far."""
from .spread import cross_chain_spread, ensemble_spread_device

__all__ = ["cross_chain_spread", "ensemble_spread_device"]
