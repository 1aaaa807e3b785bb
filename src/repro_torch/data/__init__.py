"""Synthetic token data for the training slice."""
from .pipeline import chain_batches
from .synthetic import synthetic_token_stream, token_batch

__all__ = ["chain_batches", "synthetic_token_stream", "token_batch"]
