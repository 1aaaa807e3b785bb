"""Synthetic data: the token stream of the training slice, and the
teacher-labelled MNIST- and CIFAR-shaped datasets of the paper's
experiments with their sharded loader."""
from .pipeline import ShardedLoader, chain_batches
from .synthetic import synthetic_cifar10, synthetic_mnist, synthetic_token_stream, token_batch

__all__ = ["ShardedLoader", "chain_batches", "synthetic_cifar10", "synthetic_mnist",
           "synthetic_token_stream", "token_batch"]
