"""PyTorch/CUDA port of ``repro`` (asynchronous stochastic-gradient MCMC
with elastic coupling).  It imports torch, never jax, and nothing of the
reference package; its subpackages mirror the reference's layout.

Ported so far: serving the K-member posterior-predictive ensemble of the
dense models (``serve.engine.ServeEngine``), with hand-written Hopper
kernels for flash prefill attention, paged decode attention and the fused
BMA mixture + token selection (``kernels``).  Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
