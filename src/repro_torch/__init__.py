"""PyTorch/CUDA port of ``repro`` (asynchronous stochastic-gradient MCMC
with elastic coupling).  It imports torch, never jax, and nothing of the
reference package; its subpackages mirror the reference's layout.

Ported so far: serving the K-member posterior-predictive ensemble of the
dense models (``serve.engine.ServeEngine``), and drawing it: elastically
coupled SGHMC chains (``core.ec_sghmc``) run by the chunked executor
(``run``) and the training loop (``train``).  Hand-written Hopper kernels
(``kernels``) do flash prefill attention, paged decode attention, the
fused BMA mixture + token selection and the fused Eq. 6 chain update.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
